"""Multi-stream closed-loop control on the PyTorch/CUDA port: many DVS
sensors, one batched engine.

The port's counterpart of ``examples/multi_stream_control.py``: S
independent event cameras each produce 300 ms windows; the StreamEngine
serves them over a fixed number of batch slots, so every engine step is
ONE batched closed-loop inference (on the card, one replay of the slot
count's CUDA graph). Each stream's Kraken latency and energy (the
paper's SoC model, not the card's) equal those of the window run alone
through ``ClosedLoopPipeline``.

Streams are driven through the session-handle API: ``engine.open(...)``
returns a StreamHandle owning the stream's lifecycle; ``engine.run()``
is the completion surface. One stream ("tracker") is STATEFUL: its LIF
membranes carry across window boundaries, while its stateless "twin"
sees the identical window every time -- the twin's firing rates stay
constant, the tracker's drift as the carried membranes integrate.

The engine is built on a mesh (``make_mesh()``: every visible card on
the slot axis; a 1-device mesh serves exactly as no mesh). Off the card
the mesh is the one device given (``make_mesh(devices=[dev])``).

Run:  PYTHONPATH=src python examples/torch_multi_stream_control.py
      [--smoke] [--device cpu]   (the default device is the card)
"""
import numpy as np

from torch_common import clock, parser, row, sizes, snn_params

from repro_torch import resolve_device
from repro_torch.core import events as ev
from repro_torch.core._api import EngineConfig
from repro_torch.core.pipeline import ClosedLoopPipeline
from repro_torch.distributed import make_mesh
from repro_torch.serving import StreamEngine

NUM_STREAMS = 6          # sensors
SLOTS = 4                # engine batch slots (< NUM_STREAMS: slots rotate)
WINDOWS_PER_STREAM = 5


def workload(cfg, mean_events):
    """Each sensor's gesture sequence, then the window the tracker and
    its twin both see (one numpy generator, seed 7)."""
    rng = np.random.default_rng(7)
    streams = {
        f"cam{s}": [ev.synthetic_gesture_events(
            rng, (s + k) % cfg.num_classes, mean_events=mean_events,
            height=cfg.height, width=cfg.width)
            for k in range(WINDOWS_PER_STREAM)]
        for s in range(NUM_STREAMS)}
    repeated = ev.synthetic_gesture_events(
        rng, 3, mean_events=mean_events, height=cfg.height,
        width=cfg.width)
    return streams, repeated


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    sz = sizes(args.smoke, smoke_events=5000)
    cfg = sz["snn"]
    params = snn_params(cfg)
    workload_, repeated = workload(cfg, sz["events"])

    mesh = make_mesh() if dev.type == "cuda" else make_mesh(devices=[dev])
    engine = StreamEngine(params, cfg,
                          EngineConfig(max_streams=SLOTS, mesh=mesh))
    handles = {sid: engine.open(stream_id=sid) for sid in workload_}
    # Warm-up round: captures the (SLOTS, max_events) step's graph.
    for sid, windows in workload_.items():
        handles[sid].submit(windows[0])
    warm_rows = engine.run()
    warm = {sid: (st.windows, st.energy_mj, st.latency_ms_sum,
                  st.realtime_windows)
            for sid, st in engine.stream_stats.items()}
    warm_steps = engine.stats["steps"]
    warm_windows = engine.stats["windows"]

    for sid, windows in workload_.items():
        for w in windows:
            handles[sid].submit(w)
    t0 = clock(dev)
    results = engine.run()
    wall = clock(dev) - t0

    steps = engine.stats["steps"] - warm_steps
    occupancy = (engine.stats["windows"] - warm_windows) / steps
    rate = len(results) / wall
    print(f"{len(results)} windows from {NUM_STREAMS} streams over "
          f"{SLOTS} slots in {steps} steps "
          f"(mean occupancy {occupancy:.2f}) -> {rate:.0f} windows/s\n")

    print("stream  windows  mean_lat_ms  energy_mJ  mW_busy  realtime "
          "(modelled Kraken SoC)")
    per_stream = {}
    for sid in sorted(engine.stream_stats):
        st = engine.stream_stats[sid]
        w0, e0, l0, r0 = warm[sid]      # exclude the warm-up round
        n = st.windows - w0
        lat = st.latency_ms_sum - l0
        energy = st.energy_mj - e0
        rt = (st.realtime_windows - r0) / n
        per_stream[sid] = {"windows": n, "mean_latency_ms": lat / n,
                           "energy_mj": energy}
        print(f"{sid:6s}  {n:7d}  {lat / n:11.2f}  {energy:9.3f}  "
              f"{energy / (lat * 1e-3):7.1f}  {rt:8.0%}")

    # -- stateful streaming: a long-lived stream whose membrane carries --
    tracker = engine.open(stream_id="tracker", stateful=True)
    twin = engine.open(stream_id="twin")
    for _ in range(WINDOWS_PER_STREAM):
        tracker.submit(repeated)
        twin.submit(repeated)
    drift = {"tracker": {}, "twin": {}}
    for r in engine.run():
        if r.stream_id in drift:
            drift[r.stream_id][r.seq] = r.result.breakdown["firing_rates"]

    print("\nstateful stream vs stateless twin (identical input window "
          "every time):\nwindow   twin fc1 rate   tracker fc1 rate   "
          "tracker drift vs window 0")
    base = drift["tracker"][0]["fc1"]
    for k in sorted(drift["tracker"]):
        tw, tr = drift["twin"][k]["fc1"], drift["tracker"][k]["fc1"]
        print(f"{k:6d}  {tw:14.4f}  {tr:17.4f}  {tr - base:+24.4f}")
    print("twin rates are constant (amnesiac windows); tracker rates "
          "move because\nits LIF membranes carry across windows "
          "(reset_state() would re-zero them).")

    # Looped baseline for comparison (same windows, one at a time).
    pipe = ClosedLoopPipeline(params, cfg, device=dev)
    flat = [w for ws in workload_.values() for w in ws]
    for w in flat[:3]:
        pipe(w)              # warm up
    t0 = clock(dev)
    for w in flat:
        pipe(w)
    wall_loop = clock(dev) - t0
    print(f"\nlooped single-window baseline: "
          f"{len(flat) / wall_loop:.0f} windows/s "
          f"(batched speedup {wall_loop / wall:.2f}x)")
    return {"rows": [row(r) for r in warm_rows + results],
            "per_stream": per_stream, "steps": steps,
            "occupancy": occupancy, "windows_per_s": rate,
            "looped_windows_per_s": len(flat) / wall_loop,
            "batched_speedup": wall_loop / wall,
            "fc1_rates": {name: [d[k]["fc1"] for k in sorted(d)]
                          for name, d in drift.items()}}


if __name__ == "__main__":
    main()
