"""Heterogeneous closed-loop control on the PyTorch/CUDA port: event
cameras AND frame cameras, one StreamEngine, both Kraken wings a step.

The port's counterpart of ``examples/hetero_control.py``: DVS events
route to the spiking CNN (SNE's wing: voxelize, kernels K1 and K2),
frames to the ternary CNN (CUTIE's wing: normalize, kernel K3 and K2's
currents entry). Each ``step()`` makes one batched call per engine (on
the card, one CUDA graph replay per lane), and every stream gets its own
wing's Kraken latency and energy breakdown (the paper's SoC model, not
the card's). The urgent flight loops ride the deadline-aware slot policy.

Run:  PYTHONPATH=src python examples/torch_hetero_control.py [--smoke]
      [--device cpu]   (the default device is the card)
"""
import numpy as np

from torch_common import clock, parser, row, sizes, snn_params, tcn_params

from repro_torch import resolve_device
from repro_torch.core import events as ev
from repro_torch.core import frames as fr
from repro_torch.core._api import EngineConfig
from repro_torch.core.engine import FrameTCNEngine
from repro_torch.core.pipeline import BatchedClosedLoop
from repro_torch.serving import DeadlinePolicy, StreamEngine

EVENT_STREAMS = 3
FRAME_STREAMS = 3
SLOTS = {"event": 2, "frame": 2}
WINDOWS_PER_STREAM = 4


def rounds(scfg, tcfg, mean_events):
    """The windows of the warm-up round and of the served rounds: per
    round, each DVS sensor's event window (deadline 10k + s) and each
    frame camera's frames (deadline 10k + 100 + s), from one numpy
    generator (seed 7) in submission order."""
    rng = np.random.default_rng(7)
    out = []
    for k in range(WINDOWS_PER_STREAM + 1):
        out.append(
            [(f"dvs{s}", ev.synthetic_gesture_events(
                rng, (s + k) % scfg.num_classes, mean_events=mean_events,
                height=scfg.height, width=scfg.width), float(10 * k + s))
             for s in range(EVENT_STREAMS)]
            + [(f"cam{s}", fr.synthetic_gesture_frames(
                rng, (s + k) % tcfg.num_classes, height=tcfg.height,
                width=tcfg.width), float(10 * k + 100 + s))
               for s in range(FRAME_STREAMS)])
    return out


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    sz = sizes(args.smoke, smoke_events=4000)
    scfg, tcfg = sz["snn"], sz["tcn"]

    engine = StreamEngine(
        engines=[BatchedClosedLoop(snn_params(scfg), scfg, device=dev),
                 FrameTCNEngine(tcn_params(tcfg), tcfg, device=dev)],
        config=EngineConfig(max_streams=SLOTS,
                            policy=DeadlinePolicy(fair_quantum=2)))

    # A mixed fleet: DVS sensors (urgent flight loops, tight deadlines)
    # and frame cameras (slack monitoring loops). Modality is latched at
    # open, deadlines ride each submit.
    handles = {f"dvs{s}": engine.open(modality="event", stream_id=f"dvs{s}")
               for s in range(EVENT_STREAMS)}
    handles.update({f"cam{s}": engine.open(modality="frame",
                                           stream_id=f"cam{s}")
                    for s in range(FRAME_STREAMS)})
    work = rounds(scfg, tcfg, sz["events"])

    def submit_round(k):
        for sid, window, deadline in work[k]:
            handles[sid].submit(window, deadline=deadline)

    submit_round(0)             # warm-up: captures both engines' shapes
    warm_rows = engine.run()
    warm_windows = engine.stats["windows"]
    warm_steps = engine.stats["steps"]
    warm = {sid: (st.windows, st.energy_mj, st.latency_ms_sum)
            for sid, st in engine.stream_stats.items()}

    for k in range(WINDOWS_PER_STREAM):
        submit_round(k + 1)
    t0 = clock(dev)
    results = engine.run()
    wall = clock(dev) - t0

    steps = engine.stats["steps"] - warm_steps
    served = engine.stats["windows"] - warm_windows
    n_event = sum(r.modality == "event" for r in results)
    n_frame = sum(r.modality == "frame" for r in results)
    rate = served / wall
    print(f"{served} windows ({n_event} event + {n_frame} frame) over "
          f"{sum(SLOTS.values())} slots in {steps} steps -> "
          f"{rate:.0f} windows/s; one batched call per engine per step\n")

    print("stream  wing   windows  mean_lat_ms  energy_mJ  engine_stage "
          "(modelled Kraken SoC)")
    for sid in sorted(engine.stream_stats):
        st = engine.stream_stats[sid]
        w0, e0, l0 = warm[sid]
        n = st.windows - w0
        wing = engine.modality_of(sid)
        stage = "snn_inference" if wing == "event" else "tcn_inference"
        print(f"{sid:6s}  {wing:5s}  {n:7d}  "
              f"{(st.latency_ms_sum - l0) / n:11.2f}  "
              f"{st.energy_mj - e0:9.3f}  {stage}")

    last = {r.stream_id: r.result for r in results}
    breakdowns = {}
    print("\nper-window Kraken breakdowns (last window of each wing):")
    for name in ("dvs0", "cam0"):
        bd = last[name].breakdown
        breakdowns[name] = {s: v["time_ms"] for s, v in bd["stages"].items()}
        stages = ", ".join(f"{s}={v['time_ms']:.2f}ms"
                           for s, v in bd["stages"].items())
        print(f"  {name}: {stages}; total {bd['total_energy_mj']:.3f} mJ")
    shapes = {m: sorted(engine.compiled_shapes(m)) for m in SLOTS}
    print(f"\ncompiled shapes: event={shapes['event']} "
          f"frame={shapes['frame']}")
    return {"rows": [row(r) for r in warm_rows + results],
            "steps": steps, "windows": served, "windows_per_s": rate,
            "breakdowns": breakdowns,
            "compiled_shapes": {m: [list(k) for k in v]
                                for m, v in shapes.items()}}


if __name__ == "__main__":
    main()
