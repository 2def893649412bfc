"""Cross-modal fusion control on the PyTorch/CUDA port: one sensor head,
both Kraken wings, one actuation decision a control tick -- plus live
stream migration.

The port's counterpart of ``examples/fusion_control.py``: a combined
DVS + frame sensor head feeds the spiking CNN (event wing) and the
ternary CNN (frame wing); their logits are fused late -- a convex
combination -- into one PWM actuation a tick, with each wing's Kraken
latency and energy (the paper's SoC model, not the card's).

  * FusionSession -- one event handle and one frame handle bound into
    one logical stream; each step is still one batched call per lane,
    and the session pairs the wings' results up by tick.
  * checkpoint/restore -- mid-flight the stateful fusion stream is
    checkpointed into a host-serializable payload (pickled here) and
    restored into a BRAND-NEW StreamEngine, where the remaining ticks
    continue bit for bit as in the uninterrupted run.
  * the fused fast path -- co-scheduled fusion ticks plus the cross-wing
    megastep (``EngineConfig(megastep=True)``: on the card one CUDA
    graph replays both wings) against the same workload on two
    decoupled single-wing engines, timed with the card synchronized
    before each clock read.

The script EXITS 1 if the migration is not bit for bit, or if fused
serving is slower than separate wings (``main(..., ratio_gate=False)``
returns the ratio as a reading instead of gating on it).

Run:  PYTHONPATH=src python examples/torch_fusion_control.py [--smoke]
      [--device cpu]   (the default device is the card)
"""
import pickle

import numpy as np

from torch_common import Wings, clock, parser

from repro_torch import resolve_device
from repro_torch.core._api import EngineConfig
from repro_torch.serving import FusionSession, StreamEngine, late_logit_fusion

TICKS = 6
CUT = 3          # migrate the stream after this many ticks
HEADS = 2        # sensor heads in the timed fused-vs-separate race
REPEATS = 3


def _session(engine, **kw):
    return FusionSession(engine, session_id="uav0", stateful=True,
                         fusion=late_logit_fusion(0.6, 0.4), **kw)


def main(argv=None, *, ratio_gate=True):
    args = parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    wings = Wings(args.smoke, dev)
    ticks = wings.ticks(7, TICKS)

    # -- fused serving: one decision per tick ---------------------------
    session = _session(wings.engine())
    for ev_w, fr_w in ticks:
        session.submit(ev_w, fr_w)
    fused = session.run()

    print("tick  pred  pwm[0..3]              mJ_event  mJ_frame  "
          "lat_ms  realtime  (modelled Kraken SoC)")
    for r in fused:
        bd = r.result.breakdown
        pwm = "  ".join(f"{d:.3f}" for d in r.result.pwm[0])
        print(f"{r.seq:4d}  {int(r.result.label_pred[0]):4d}  {pwm}  "
              f"{bd['per_wing_energy_mj']['event']:8.3f}  "
              f"{bd['per_wing_energy_mj']['frame']:8.3f}  "
              f"{r.result.latency_ms:6.1f}  {r.result.realtime!s:>8}")
    st = session.stats
    print(f"\n{st['ticks_fused']} fused ticks "
          f"({st['event'].windows} event + {st['frame'].windows} frame "
          f"windows); rule = {session.fusion.name}; "
          f"wing energy split {st['event'].energy_mj:.2f} / "
          f"{st['frame'].energy_mj:.2f} mJ")

    # -- stream migration: checkpoint -> fresh engine -> restore --------
    part_a = _session(wings.engine())
    for ev_w, fr_w in ticks[:CUT]:
        part_a.submit(ev_w, fr_w)
    migrated = part_a.run()

    blob = pickle.dumps(part_a.checkpoint())     # host-serializable
    part_b = FusionSession.restore(wings.engine(), pickle.loads(blob),
                                   fusion=late_logit_fusion(0.6, 0.4))
    for ev_w, fr_w in ticks[CUT:]:
        part_b.submit(ev_w, fr_w)
    migrated += part_b.run()

    same = len(fused) == len(migrated) == TICKS and all(
        a.seq == b.seq
        and np.array_equal(a.result.pwm, b.result.pwm)
        and np.array_equal(a.result.logits, b.result.logits)
        and np.array_equal(a.result.label_pred, b.result.label_pred)
        and a.result.energy_mj == b.result.energy_mj
        for a, b in zip(fused, migrated))
    print(f"\nmigrated at tick {CUT} through a {len(blob)}-byte "
          f"checkpoint into a fresh engine: "
          f"{'bit for bit the uninterrupted run' if same else 'MISMATCH'}")

    # -- the perf claim: fused against separate wings -------------------
    race = fused_vs_separate(wings)
    ratio = race["ratio"]
    print(f"\nfused-vs-separate tick ratio over {HEADS} heads: "
          f"{ratio:.2f}x "
          f"({'fused serving is faster' if ratio >= 1.0 else 'FUSED IS SLOWER'})")
    out = {"ticks": [{"seq": r.seq, "label": int(r.result.label_pred[0]),
                      "pwm": r.result.pwm[0].tolist(),
                      "latency_ms": r.result.latency_ms,
                      "energy_mj": r.result.energy_mj} for r in fused],
           "ticks_fused": st["ticks_fused"],
           "migration_bitwise": bool(same), "checkpoint_bytes": len(blob),
           **race}
    if not same or (ratio_gate and ratio < 1.0):
        raise SystemExit(1)
    return out


def fused_vs_separate(wings):
    """Median fused/separate ticks-per-second over REPEATS interleaved
    passes: HEADS FusionSessions on one co-scheduled megastep engine
    against the same windows through decoupled event-only and frame-only
    engines."""
    dev = wings.device
    heads = {h: wings.ticks(40 + h, TICKS) for h in range(HEADS)}

    eng = wings.engine(max_streams=HEADS, megastep=True, pipeline_depth=1)
    sess = {h: FusionSession(eng, session_id=f"head{h}")
            for h in range(HEADS)}

    def fused_pass():
        for h, tks in heads.items():
            for ev_w, fr_w in tks:
                sess[h].submit(ev_w, fr_w)
        t0 = clock(dev)
        rows = eng.run()
        n = 0
        for s in sess.values():
            rows = s.absorb(rows)
            n += len(s.drain())
        assert n == HEADS * TICKS and not rows
        return n / (clock(dev) - t0)

    ev_eng = StreamEngine(engines=[wings.event()],
                          config=EngineConfig(max_streams=HEADS))
    fr_eng = StreamEngine(engines=[wings.frame()],
                          config=EngineConfig(max_streams=HEADS))
    ev_h = {h: ev_eng.open(stream_id=f"dvs{h}") for h in range(HEADS)}
    fr_h = {h: fr_eng.open(stream_id=f"cam{h}") for h in range(HEADS)}

    def separate_pass():
        for h, tks in heads.items():
            for ev_w, fr_w in tks:
                ev_h[h].submit(ev_w)
                fr_h[h].submit(fr_w)
        t0 = clock(dev)
        n = len(ev_eng.run()) + len(fr_eng.run())
        assert n == 2 * HEADS * TICKS
        return (n // 2) / (clock(dev) - t0)

    fused_pass(), separate_pass()            # warm-up: capture both sides
    fused, separate = [], []
    for _ in range(REPEATS):
        fused.append(fused_pass())
        separate.append(separate_pass())
    return {"ratio": float(np.median(fused) / np.median(separate)),
            "fused_ticks_per_s": fused, "separate_ticks_per_s": separate}


if __name__ == "__main__":
    main()
