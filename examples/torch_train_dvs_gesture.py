"""End-to-end driver: STBP-train the paper's DVS-Gesture SCNN on the
PyTorch/CUDA port.

The port's counterpart of ``examples/train_dvs_gesture.py`` (Sec. III:
STBP per Wu et al. 2018, LIF dynamics matched to SNE) on synthetic
DVS-Gesture-like event streams: ``repro_torch.training.stbp_step``
(``repro_torch.core.snn.snn_loss`` under autograd, then AdamW, with
cuDNN's deterministic algorithms) and step-atomic checkpoints (the JAX
package's format), resuming from the newest intact checkpoint. In
``time_serial`` mode (the default, as in the JAX example) the fc currents
run through K2's currents entry on the card; in ``layer_serial`` the
forward is the serving path's kernels K1 and K2. Defaults train the full
128x128 Table II network (T=16, B=16, ~60k-event windows); ``--smoke``
runs the reduced config. It ends with a closed-loop evaluation through
the port's ``ClosedLoopPipeline``.

Run:  PYTHONPATH=src python examples/torch_train_dvs_gesture.py [--smoke]
      [--device cpu] [--mode layer_serial]   (the default device is the card)
"""
import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core import events as ev
from repro_torch.core.pipeline import ClosedLoopPipeline
from repro_torch.core.snn import init_snn
from repro_torch.data import dvs_gesture_batch
from repro_torch.training import checkpoint as CKPT
from repro_torch.training import AdamWConfig, adamw_init, stbp_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--ckpt-dir", default="checkpoints/torch_dvs_gesture")
    ap.add_argument("--device", default=None)
    ap.add_argument("--mode", choices=("time_serial", "layer_serial"),
                    default="time_serial")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config("colibries", smoke=args.smoke)
    steps = args.steps or (40 if args.smoke else 300)
    batch = args.batch or (8 if args.smoke else 16)
    mean_events = 4000 if args.smoke else 60_000

    params = init_snn(0, cfg, device=dev)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=10, total_steps=steps,
                       weight_decay=1e-4)

    # resume if a checkpoint exists (fault tolerance)
    start = 0
    restored = CKPT.restore_latest(args.ckpt_dir,
                                   {"params": params, "opt": opt})
    if restored:
        start, state, extra = restored
        params, opt = state["params"], state["opt"]
        print(f"resumed from step {start}")

    accs = []
    for s in range(start, steps):
        b = dvs_gesture_batch(batch, s, height=cfg.height,
                              width=cfg.width, time_bins=cfg.time_bins,
                              mean_events=mean_events,
                              num_classes=cfg.num_classes, device=dev)
        t0 = time.perf_counter()
        params, opt, loss, aux = stbp_step(params, opt, b.vox, b.labels,
                                           cfg, ocfg, mode=args.mode)
        accs.append(float(aux["accuracy"]))
        if (s + 1) % 10 == 0:
            r = {k: f"{float(v):.3f}" for k, v in aux["firing_rates"].items()}
            print(f"step {s + 1:4d}  loss {float(loss):.4f}  "
                  f"acc {np.mean(accs[-10:]):.3f}  "
                  f"({(time.perf_counter() - t0) * 1e3:.0f} ms)  rates {r}")
        if (s + 1) % 50 == 0 or s + 1 == steps:
            CKPT.save_checkpoint(args.ckpt_dir, s + 1,
                                 {"params": params, "opt": opt})

    # Closed-loop evaluation with the trained net
    pipe = ClosedLoopPipeline(params, cfg, device=dev)
    rng = np.random.default_rng(123)
    correct = 0
    n_eval = 20
    for _ in range(n_eval):
        lab = int(rng.integers(0, cfg.num_classes))
        w = ev.synthetic_gesture_events(rng, lab, mean_events=mean_events,
                                        height=cfg.height, width=cfg.width,
                                        num_classes=cfg.num_classes)
        res = pipe(w)
        correct += int(res.label_pred[0]) == lab
    print(f"\nclosed-loop eval: {correct}/{n_eval} correct "
          f"(chance {1 / cfg.num_classes:.2f}); "
          f"latency {res.latency_ms:.1f} ms, energy {res.energy_mj:.2f} mJ,"
          f" realtime={res.realtime}")


if __name__ == "__main__":
    main()
