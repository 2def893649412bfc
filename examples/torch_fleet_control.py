"""Fleet control plane on the PyTorch/CUDA port: autoscaling, live
migration and rebalancing.

The port's counterpart of ``examples/fleet_control.py``, through
``repro_torch.fleet`` over two event-wing engines with a deliberately
skewed load:

  * a **hot** engine (2 slots) opens four deadlined stateful streams
    with all their windows queued up front,
  * a **cold** engine (4 slots) sits idle,
  * a :class:`~repro_torch.fleet.autoscale.LaneAutoscaler` watches the
    hot lane's backlog telemetry and grows its slot count (on the card
    the new slot count's CUDA graph is captured inside ``resize_lane``),
  * a :class:`~repro_torch.fleet.rebalance.FleetRebalancer` live-migrates
    deep-queue streams hot-to-cold through the checkpoint store, and
  * every migrated stream's results are checked bitwise against an
    uninterrupted single-engine run of the same windows.

Weights are drawn from a numpy seed on the 2**-8 grid, so every current
is exact and a stream's bits do not depend on the slots it shares.
Deadline misses are measured on a shared logical clock (one tick per
scheduling round), so the printout is deterministic.

Run:  PYTHONPATH=src python examples/torch_fleet_control.py [--device cpu]
(the default device is the card).
"""
import argparse

import numpy as np

from repro_torch.configs import SMOKE
from repro_torch.convert import snn_params_from_numpy
from repro_torch.core import events as ev
from repro_torch.core._api import EngineConfig, FleetConfig
from repro_torch.fleet import CheckpointStore, FleetRebalancer, LaneAutoscaler
from repro_torch.serving import DeadlinePolicy, StreamEngine

N_STREAMS = 4
N_WINDOWS = 5


def init_params(cfg, seed=0):
    """He-init weights in the JAX package's layout, rounded to 2**-8."""
    rng = np.random.default_rng(seed)

    def he(shape, fan_in):
        w = rng.normal(size=shape) * cfg.init_gain * np.sqrt(2.0 / fan_in)
        return (np.round(w * 256.0) / 256.0).astype(np.float32)

    return snn_params_from_numpy({
        "conv1": {"w": he((3, 3, cfg.in_channels, cfg.conv1_features),
                          9 * cfg.in_channels)},
        "conv2": {"w": he((3, 3, cfg.conv1_features, cfg.conv2_features),
                          9 * cfg.conv1_features)},
        "fc1": {"w": he((cfg.flat_dim, cfg.hidden), cfg.flat_dim)},
        "fc2": {"w": he((cfg.hidden, cfg.num_classes), cfg.hidden)},
    })


def windows_for(sid, n=N_WINDOWS):
    rng = np.random.default_rng(100 + int(sid[1:]))
    return [ev.synthetic_gesture_events(rng, k % SMOKE.num_classes,
                                        mean_events=3000,
                                        height=SMOKE.height,
                                        width=SMOKE.width)
            for k in range(n)]


def make_engine(params, slots, device):
    return StreamEngine(params, SMOKE, EngineConfig(
        max_streams=slots, policy=DeadlinePolicy(fair_quantum=2)),
        device=device)


def serve_fleet(params, streams, device, *, control):
    hot = make_engine(params, 2, device)
    cold = make_engine(params, 4, device)
    tick = [0]
    for eng in (hot, cold):
        eng.deadline_clock = lambda: float(tick[0])
    for sid in sorted(streams):
        h = hot.open(stream_id=sid, stateful=True)
        for k, w in enumerate(streams[sid]):
            h.submit(w, deadline=2.0 + 1.0 * k)
    scaler = reb = None
    if control:
        scaler = LaneAutoscaler(hot, config=FleetConfig(
            grow_backlog=3.0, grow_patience=2, max_slots=4))
        reb = FleetRebalancer(
            {"hot": hot, "cold": cold}, store=CheckpointStore(),
            config=FleetConfig(imbalance=1.0, cooldown=1))

    rows = []
    while hot.pending() or cold.pending():
        rows.extend(hot.step())
        rows.extend(cold.step())
        tick[0] += 1
        if scaler is not None:
            decision = scaler.observe()
            if decision.resized:
                print(f"  tick {tick[0]:2d}: autoscaler {decision.action} "
                      f"hot lane {decision.old_slots}->"
                      f"{decision.new_slots} ({decision.reason})")
        if reb is not None:
            report = reb.observe()
            rows.extend(report.displaced)
            for rec in report.moved:
                print(f"  tick {tick[0]:2d}: migrated {rec.stream_id!r} "
                      f"hot->cold in {rec.migration_ms:.1f} ms "
                      f"({len(rec.displaced)} displaced results)")
    dated = missed = 0
    for eng in (hot, cold):
        for st in eng.stream_stats.values():
            dated += st.deadline_windows
            missed += st.deadline_missed
    return rows, missed / dated


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without one)")
    args = ap.parse_args(argv)
    params = init_params(SMOKE)
    streams = {f"s{i}": windows_for(f"s{i}") for i in range(N_STREAMS)}

    # The oracle: each stream served alone, uninterrupted.
    oracle = {}
    for sid in sorted(streams):
        eng = make_engine(params, 2, args.device)
        h = eng.open(stream_id=sid, stateful=True)
        for w in streams[sid]:
            h.submit(w)
        for r in eng.run():
            oracle[(sid, r.seq)] = r.result

    print("static fleet (no control plane):")
    _, static_miss = serve_fleet(params, streams, args.device, control=False)
    print(f"  deadline-miss rate: {static_miss:.1%}\n")

    print("controlled fleet (autoscaler + rebalancer):")
    rows, rebal_miss = serve_fleet(params, streams, args.device,
                                   control=True)
    print(f"  deadline-miss rate: {rebal_miss:.1%}")

    same = len(rows) == len(oracle) and all(
        np.array_equal(r.result.pwm, oracle[(r.stream_id, r.seq)].pwm)
        and np.array_equal(r.result.logits,
                           oracle[(r.stream_id, r.seq)].logits)
        for r in rows)
    print(f"\nmiss rate {static_miss:.1%} -> {rebal_miss:.1%}; "
          f"migrated streams "
          f"{'bitwise-identical to uninterrupted runs' if same else 'MISMATCH'}")
    if not (same and rebal_miss <= static_miss):
        raise SystemExit(1)


if __name__ == "__main__":
    main()
