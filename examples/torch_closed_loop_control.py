"""Closed-loop control on the PyTorch/CUDA port: gesture -> setpoint
tracking at 3.3 Hz.

The port's counterpart of ``examples/closed_loop_control.py``: a stream
of ten 300 ms DVS windows drives the spiking classifier, whose PWM
outputs steer a toy first-order plant toward per-gesture setpoints. It
reports each window's Kraken latency and energy (the paper's SoC model,
not the card's), and the plant's tracking error.

Run:  PYTHONPATH=src python examples/torch_closed_loop_control.py
      [--smoke] [--device cpu]   (the default device is the card)
"""
import numpy as np

from torch_common import parser, sizes, snn_params

from repro_torch import resolve_device
from repro_torch.core import events as ev
from repro_torch.core.pipeline import ClosedLoopPipeline

PLANT_TAU = 0.8          # first-order plant time constant (windows)
# The gesture sequence the "pilot" performs; each class maps to a target
# actuation vector through pwm_from_logits' mixing matrix.
GESTURES = (1, 1, 4, 4, 4, 9, 9, 2, 2, 2)


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    sz = sizes(args.smoke, smoke_events=5000)
    cfg = sz["snn"]
    pipe = ClosedLoopPipeline(snn_params(cfg), cfg, device=dev)
    rng = np.random.default_rng(7)

    state = np.full(4, 0.5)
    total_energy = 0.0
    labels, pwms, latencies, energies, errors = [], [], [], [], []

    print("window  gesture  pred  latency_ms  energy_mJ  plant_state")
    for i, g in enumerate(GESTURES):
        w = ev.synthetic_gesture_events(rng, g, mean_events=sz["events"],
                                        height=cfg.height, width=cfg.width)
        res = pipe(w)
        # first-order plant follows the PWM setpoint
        target = res.pwm[0]
        state = state + (target - state) * (1 - np.exp(-1 / PLANT_TAU))
        total_energy += res.energy_mj
        labels.append(int(res.label_pred[0]))
        pwms.append(target.tolist())
        latencies.append(res.latency_ms)
        energies.append(res.energy_mj)
        errors.append(float(np.abs(target - state).mean()))
        print(f"{i:6d}  {g:7d}  {labels[-1]:4d}  "
              f"{res.latency_ms:10.2f}  {res.energy_mj:9.3f}  "
              f"{np.round(state, 3)}")

    avg_mw = total_energy / len(GESTURES) * 3.33   # mJ/window * windows/s
    print(f"\nmean modelled control latency: {np.mean(latencies):.2f} ms "
          f"(paper full-scale: 164.5 ms)")
    print(f"modelled energy for {len(GESTURES)} windows: "
          f"{total_energy:.2f} mJ (avg {avg_mw:.2f} mW; a 2 Wh battery "
          f"sustains {2000 / avg_mw:.0f} h of continuous 3.33 Hz control)")
    print(f"mean tracking error: {np.mean(errors):.3f}")
    return {"labels": labels, "pwm": pwms, "latency_ms": latencies,
            "energy_mj": energies, "plant_state": state.tolist(),
            "mean_tracking_error": float(np.mean(errors)),
            "avg_mw": avg_mw}


if __name__ == "__main__":
    main()
