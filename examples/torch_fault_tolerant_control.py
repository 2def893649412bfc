"""Fault-tolerant closed-loop control on the PyTorch/CUDA port: degraded
fusion and supervised lane recovery, held bit for bit against the
uninterrupted run.

The port's counterpart of ``examples/fault_tolerant_control.py``, in two
acts on the two-wing sensor head:

  **Act 1 -- a wing dies mid-flight.** A seeded
  :class:`~repro_torch.fleet.faults.FaultInjector` kills the frame wing
  partway through a fused flight. The engine's recovery layer fails the
  dead lane fast; the :class:`~repro_torch.serving.session.FusionSession`
  emits single-wing DEGRADED ticks on the surviving event wing instead of
  stalling, until a fresh frame engine is installed
  (``replace_lane_engine``; on the card its graphs are captured anew)
  and fusion resumes. Every fused tick equals the uninterrupted run bit
  for bit -- the event wing's LIF carry never flinched.

  **Act 2 -- the stateful lane itself dies.** A
  :class:`~repro_torch.fleet.supervisor.LaneSupervisor` journals every
  submission and checkpoints the stream into a bounded
  :class:`~repro_torch.fleet.store.CheckpointStore`. The injector kills
  the event lane mid-scan; the supervisor rebuilds it, restores the last
  checkpoint and replays the journal, and EVERY window, those that failed
  while the lane was down included, lands bit for bit as in the
  uninterrupted scan.

Both acts assert their bitwise claims: a mismatch raises.

Run:  PYTHONPATH=src python examples/torch_fault_tolerant_control.py
      [--smoke] [--device cpu]   (the default device is the card)
"""
import numpy as np

from torch_common import Wings, parser

from repro_torch import resolve_device
from repro_torch.core._api import EngineConfig, FaultConfig, RecoveryConfig
from repro_torch.fleet import CheckpointStore, FaultInjector, LaneSupervisor
from repro_torch.serving import FusionSession, StreamEngine

TICKS = 8
KILL_AT = 3      # the frame wing dies dispatching this tick
REVIVE_AT = 6    # ...and a fresh engine is installed here

RECOVERY = RecoveryConfig(max_retries=0, backoff_steps=0, dead_after=1,
                          checkpoint_every=2)


def assert_bitwise(a, b):
    np.testing.assert_array_equal(a.label_pred, b.label_pred)
    np.testing.assert_array_equal(a.pwm, b.pwm)
    np.testing.assert_array_equal(a.logits, b.logits)


def act1_degraded_fusion(wings, ticks):
    print("== Act 1: frame wing dies mid-flight, fusion degrades ==")

    def make_session(inj):
        wrap = inj.wrap if inj else (lambda e: e)
        eng = StreamEngine(
            engines=[wrap(wings.event()), wrap(wings.frame())],
            config=EngineConfig(max_streams={"event": 1, "frame": 1},
                                recovery=RECOVERY))
        return eng, FusionSession(eng, session_id="uav0", stateful=True)

    # The oracle: the same flight with no faults.
    _, clean = make_session(None)
    for ev_w, fr_w in ticks:
        clean.submit(ev_w, fr_w)
    oracle = {r.seq: r.result for r in clean.run()}

    inj = FaultInjector(FaultConfig(seed=3))
    eng, sess = make_session(inj)
    rows = []
    for k, (ev_w, fr_w) in enumerate(ticks):
        if k == KILL_AT:
            inj.kill("frame")
            print(f"  tick {k}: frame wing KILLED")
        if k == REVIVE_AT:
            inj.revive("frame")
            eng.replace_lane_engine("frame", engine=inj.wrap(wings.frame()))
            print(f"  tick {k}: fresh frame engine installed")
        sess.submit(ev_w, fr_w)
        rows.extend(sess.step())
    sess.absorb(eng.flush())
    rows.extend(sess.drain())

    for r in rows:
        mark = {"ok": "fused", "degraded": "DEGRADED"}[r.status]
        extra = (f" (wing down: {r.result.breakdown['degraded_wing']})"
                 if r.status == "degraded" else "")
        print(f"  tick {r.seq}: {mark}  pred={int(r.result.label_pred[0])}"
              f"{extra}")
    assert [r.seq for r in rows] == list(range(TICKS))
    n_deg = sum(r.status == "degraded" for r in rows)
    assert n_deg == REVIVE_AT - KILL_AT, "wing-down stretch must degrade"
    # Bitwise: every FUSED tick -- before the kill and after the
    # recovery -- equals the uninterrupted flight (the event carry never
    # reset).
    for r in rows:
        if r.status == "ok":
            assert_bitwise(r.result, oracle[r.seq])
    health = sess.wing_health()
    print(f"  {sess.ticks_fused} fused + {sess.ticks_degraded} degraded "
          f"ticks; frame wing failures seen: "
          f"{health['frame']['failures_seen']}")
    print("  bitwise: every fused tick == uninterrupted oracle  [OK]\n")
    return {"statuses": [r.status for r in rows],
            "labels": [int(r.result.label_pred[0]) for r in rows],
            "ticks_fused": sess.ticks_fused,
            "ticks_degraded": sess.ticks_degraded,
            "frame_failures_seen": health["frame"]["failures_seen"],
            "fused_bitwise": True}


def act2_supervised_recovery(wings, ticks):
    print("== Act 2: stateful event lane dies, supervisor recovers ==")
    windows = [ev_w for ev_w, _ in ticks]
    config = EngineConfig(max_streams=1, recovery=RECOVERY)

    # The oracle: the same stateful scan with no faults.
    clean = StreamEngine(engines=[wings.event()], config=config)
    ch = clean.open(modality="event", stream_id="imu", stateful=True)
    for w in windows:
        ch.submit(w)
    oracle = {r.seq: r.result for r in clean.run()}

    inj = FaultInjector(FaultConfig(seed=3))
    make = lambda: inj.wrap(wings.event())  # noqa: E731
    eng = StreamEngine(engines=[make()], config=config)
    sup = LaneSupervisor(eng, store=CheckpointStore(capacity=4),
                         rebuild=lambda modality: make())
    sup.watch(eng.open(modality="event", stream_id="imu", stateful=True))
    got = []
    for k, w in enumerate(windows):
        if k == KILL_AT:
            inj.kill("event")
            print(f"  window {k}: event lane KILLED")
        if k == REVIVE_AT:
            inj.revive("event")
            print(f"  window {k}: injector revived (next rebuild sticks)")
        sup.submit("imu", w)
        got.extend(sup.tick(eng.step()))
    for _ in range(12):
        got.extend(sup.tick(eng.step()))

    ok = sorted((r for r in got if r.ok), key=lambda r: r.seq)
    failed = [r for r in got if not r.ok]
    assert [r.seq for r in ok] == list(range(TICKS)), \
        "every window must eventually succeed"
    for r in ok:
        assert_bitwise(r.result, oracle[r.seq])
    stats = {k: sup.stats[k] for k in ("restores", "checkpoints",
                                       "replayed")}
    print(f"  {len(ok)}/{TICKS} windows served ok ({len(failed)} transient "
          f"failures while the lane was down); supervisor: "
          f"{stats['restores']} restores, {stats['checkpoints']} "
          f"checkpoints, {stats['replayed']} journal replays")
    print("  bitwise: every successful window == uninterrupted scan  [OK]")
    return {"ok": len(ok), "failed": len(failed),
            "labels": [int(r.result.label_pred[0]) for r in ok],
            "supervisor": stats, "recovered_bitwise": True}


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    wings = Wings(args.smoke, resolve_device(args.device))
    ticks = wings.ticks(7, TICKS)
    return {"act1": act1_degraded_fusion(wings, ticks),
            "act2": act2_supervised_recovery(wings, ticks)}


if __name__ == "__main__":
    main()
