"""Fleet and chaos soaks of the port, held to its own contracts.

The port's counterparts of ``test_fleet_soak.py`` and the supervised and
fusion scenarios of ``test_chaos_soak.py``, at the tests' small size (the
shared set-up of ``test_torch_checkpoint.py``). They are held to the
port's own uninterrupted runs, bit for bit, not to the JAX package's
soak oracles:

  * a rebalanced two-engine fleet against a static one, sync and
    pipelined: the rebalancer migrates, the rebalanced deadline-miss
    rate is strictly below the static one, and every persistent stream
    equals its uninterrupted run (``test_torch_fleet.py`` holds the
    rebalancer's reports to the JAX package's);
  * a supervised lane kill, three times over on a two-lane engine: each
    recovery within 2 ticks, every successful window equal to the
    uninterrupted run and reported once, the frame lane untouched, and
    the replaced engines freed without a gc pass;
  * a fusion wing kill that degrades the ticks and resumes after the
    wing's lane is replaced.

Every clock is logical (the serving loop's tick) and the injector is seeded,
so a failure replays exactly.
"""
import gc
import weakref

import pytest

from test_torch_checkpoint import assert_bitwise, side

torch = pytest.importorskip("torch")

N_PERSISTENT = 4
N_WINDOWS = 6


def _soak(s, persistent, *, depth, rebalance):
    """``test_fleet_soak.py``'s workload: 4 deadlined stateful streams
    with every window queued up front on a 2-slot hot engine, ephemeral
    churn on both engines, a 4-slot cold engine. Returns (rows, fleet
    deadline-miss rate, migrations)."""
    from repro_torch.fleet import FleetConfig, FleetRebalancer

    def engine(b):
        return s.engine(max_streams=b, pipeline_depth=depth,
                        policy=s.DeadlinePolicy(fair_quantum=2))

    hot, cold = engine(2), engine(4)
    tick = [0]
    for eng in (hot, cold):
        eng.deadline_clock = lambda: float(tick[0])
    for sid in sorted(persistent):
        h = hot.open(stream_id=sid, stateful=True)
        for k, w in enumerate(persistent[sid]):
            h.submit(w, deadline=3.0 + 1.2 * k)
    reb = FleetRebalancer(
        {"hot": hot, "cold": cold}, store=s.CheckpointStore(),
        config=FleetConfig(imbalance=1.0, cooldown=1, miss_weight=10.0),
    ) if rebalance else None
    churn = s.windows(4, seed=99)
    rows, ephemerals, n_eph, rounds = [], {}, 0, 0
    while (hot.pending() or cold.pending() or hot.in_flight
           or cold.in_flight or ephemerals):
        rounds += 1
        assert rounds < 300, "soak failed to drain"
        rows += hot.step() + cold.step()
        tick[0] += 1
        if rounds % 2 == 1 and rounds < 20:
            for eng, slack in ((hot, 50.0), (cold, 2.0)):
                eph = eng.open(stream_id=f"e{n_eph}")
                eph.submit(churn[n_eph % len(churn)],
                           deadline=tick[0] + slack)
                ephemerals[f"e{n_eph}"] = eph
                n_eph += 1
        for sid in [sid for sid in ephemerals
                    if any(r.stream_id == sid for r in rows)]:
            ephemerals.pop(sid).close()
        if reb is not None:
            rows += reb.observe().displaced
    dated = missed = 0
    for eng in (hot, cold):
        for st in eng.stream_stats.values():
            dated += st.deadline_windows
            missed += st.deadline_missed
    return rows, missed / dated, len(reb.migrations) if reb else 0


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "pipelined"])
def test_rebalanced_fleet_beats_static_and_stays_bitwise(depth):
    s = side("port")
    persistent = {f"p{i}": s.windows(N_WINDOWS, seed=80 + i)
                  for i in range(N_PERSISTENT)}
    alone = [r for sid, ws in persistent.items() for r in s.alone(sid, ws)]
    static, static_miss, n0 = _soak(s, persistent, depth=depth,
                                    rebalance=False)
    moved, moved_miss, n = _soak(s, persistent, depth=depth, rebalance=True)
    assert n0 == 0 and n >= 1
    assert moved_miss < static_miss, (moved_miss, static_miss)
    for rows in (static, moved):
        mine = [r for r in rows if r.stream_id in persistent]
        assert len(mine) == N_PERSISTENT * N_WINDOWS
        assert len({(r.stream_id, r.seq) for r in mine}) == len(mine)
        assert_bitwise(alone, mine)


def _supervised_kills(s, kills=(2, 5, 8), n=11):
    """One stateful event stream and one frame stream on a two-lane
    engine (1 slot a lane) under a LaneSupervisor, checkpointing every 2
    ticks; the event lane is killed at each tick of ``kills`` and revived
    the tick after. Returns (rows, ticks from each kill to its restore,
    weakrefs to every event engine the lane had, the stream ids)."""
    from repro_torch.fleet import LaneSupervisor
    evs, frs = s.windows(n, seed=23), s.frames(n, seed=24)
    recovery = s.RecoveryConfig(max_retries=0, backoff_steps=0,
                                dead_after=1, checkpoint_every=2)
    inj = s.FaultInjector()
    made = []

    def rebuild(modality):
        assert modality == "event"
        inner = s.loop()
        made.append(weakref.ref(inner))
        return inj.wrap(inner)

    eng = s.engine(lanes=("event", "frame"), wrap=inj.wrap, max_streams=1,
                   recovery=recovery)
    made.append(weakref.ref(eng.engines["event"].inner))
    sup = LaneSupervisor(eng, store=s.CheckpointStore(capacity=4),
                         rebuild=rebuild)
    h = sup.watch(eng.open(modality="event", stateful=True))
    cam = eng.open(modality="frame")
    rows, recovered, killed_at = [], [], None
    for k in range(n):
        sup.submit(h.stream_id, evs[k])
        cam.submit(frs[k])
        if k in kills:
            inj.kill("event")
            killed_at, before = k, sup.stats["restores"]
        rows += sup.tick(eng.step())
        if k - 1 in kills:
            inj.revive("event")
        if killed_at is not None and sup.stats["restores"] > before:
            recovered.append(k - killed_at)
            killed_at = None
    for _ in range(8):
        rows += sup.tick(eng.step())
    return rows, recovered, made, (h.stream_id, cam.stream_id), evs, frs


def test_supervised_lane_kills_recover_bitwise_and_free_the_old_engines():
    s = side("port")
    gc.disable()
    try:
        rows, recovered, made, (sid, cam), evs, frs = _supervised_kills(s)
        # The replaced engines are gone without a gc pass: nothing (the
        # fault wrapper, the supervisor, the serving engine) keeps one.
        alive = [i for i, ref in enumerate(made) if ref() is not None]
    finally:
        gc.enable()
    assert len(recovered) == 3 and all(t <= 2 for t in recovered)
    assert alive == [len(made) - 1]
    ok = [r for r in rows if r.ok]
    assert len({(r.stream_id, r.seq) for r in ok}) == len(ok)
    mine = [r for r in ok if r.stream_id == sid]
    assert sorted(r.seq for r in mine) == list(range(len(evs)))
    assert_bitwise(s.alone(sid, evs), mine)
    # The frame lane's rows are those of the same windows never faulted.
    plain = s.engine(lanes=("frame",), max_streams=1)
    hp = plain.open(stream_id=cam)
    for f in frs:
        hp.submit(f)
    assert_bitwise(plain.run(), [r for r in rows if r.stream_id == cam])


def test_fusion_wing_kill_degrades_then_resumes():
    s = side("port")
    inj = s.FaultInjector(s.FaultConfig(seed=1))
    recovery = s.RecoveryConfig(max_retries=0, backoff_steps=0,
                                dead_after=1)
    eng = s.engine(lanes=(s.stub("event"), s.stub("frame")),
                   wrap=inj.wrap, max_streams=1, recovery=recovery)
    sess = s.FusionSession(eng)
    rows = []
    for t in range(12):
        if t == 4:
            inj.kill("frame")
        if t == 8:
            inj.revive("frame")
            eng.replace_lane_engine("frame",
                                    engine=inj.wrap(s.stub("frame")))
        sess.submit(t, 100 + t)
        rows += sess.step()
    rows += sess.absorb(eng.flush()) or sess.drain()
    rows += sess.drain()
    assert [r.seq for r in rows] == list(range(12))
    statuses = [r.status for r in rows]
    assert statuses[:4] == ["ok"] * 4 and statuses[-4:] == ["ok"] * 4
    assert "degraded" in statuses and sess.ticks_degraded >= 1
    assert all(r.result.breakdown["degraded_wing"] == "frame"
               for r in rows if r.status == "degraded")
