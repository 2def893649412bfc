"""Quickstart on the PyTorch/CUDA port: one DVS window through the closed
loop.

The port's counterpart of ``examples/quickstart.py``: builds the paper's
Table II spiking CNN (``--smoke``: the reduced one), makes a synthetic
DVS gesture window, runs event -> label -> PWM through
``ClosedLoopPipeline`` and prints the Kraken SoC's latency and energy as
the paper's model gives them (modelled for the SoC, not measured on the
card), stage by stage, next to the paper's Table III.

The JAX example passes ``lif_scan_fn=lif_scan`` to choose its LIF
kernel; the port has no such knob: the closed loop always runs the conv
LIF layers through kernel K1 and fc1/fc2 through K2 (plain PyTorch on
CPU tensors).

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--smoke]
      [--device cpu]   (the default device is the card)
"""
import numpy as np

from torch_common import parser, sizes, snn_params

from repro_torch import resolve_device
from repro_torch.core import events as ev
from repro_torch.core.pipeline import ClosedLoopPipeline

LABEL = 7


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    sz = sizes(args.smoke, smoke_events=6000)
    cfg = sz["snn"]
    params = snn_params(cfg)

    # One 300 ms DVS event window (synthetic gesture, class 7).
    rng = np.random.default_rng(0)
    window = ev.synthetic_gesture_events(
        rng, label=LABEL, mean_events=sz["events"],
        height=cfg.height, width=cfg.width)
    print(f"window: {window.num_events} events over "
          f"{window.duration_us / 1000:.0f} ms")

    # Closed loop: acquire -> preprocess -> SNE inference -> PWM.
    pipe = ClosedLoopPipeline(params, cfg, device=dev)
    res = pipe(window)

    print(f"predicted class: {res.label_pred[0]}  (true: {window.label})")
    print(f"PWM duty cycles: {np.round(res.pwm[0], 3)}")
    print(f"modelled Kraken latency: {res.latency_ms:.2f} ms "
          f"(paper, full net: 164.5 ms)")
    print(f"modelled Kraken energy:  {res.energy_mj:.3f} mJ "
          f"(paper, full net: 7.7 mJ)")
    print(f"real-time at 300 ms windows: {res.realtime}; "
          f"sustained {res.sustained_rate_hz:.2f} Hz")
    for name, st in res.breakdown["stages"].items():
        print(f"  {name:18s} {st['time_ms']:8.2f} ms  "
              f"{st['active_energy_mj']:6.3f} mJ  [{st['domain']}]")
    return {"label": int(res.label_pred[0]), "true_label": window.label,
            "num_events": window.num_events, "pwm": res.pwm[0].tolist(),
            "latency_ms": res.latency_ms, "energy_mj": res.energy_mj,
            "realtime": bool(res.realtime),
            "sustained_rate_hz": res.sustained_rate_hz,
            "stages": {name: {"time_ms": st["time_ms"],
                              "active_energy_mj": st["active_energy_mj"]}
                       for name, st in res.breakdown["stages"].items()}}


if __name__ == "__main__":
    main()
