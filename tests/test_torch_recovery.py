"""Fault injection and recovery in the port, against the JAX package.

Mirrors ``test_faults.py`` (injector, retry, quarantine, lane death and
replacement, pipelined retry, close with windows in flight, degraded
fusion) and ``test_fusion_sched.py``'s wing fault under the megastep.
``repro_torch.fleet.faults`` draws the JAX file's random numbers, so one
seed scripts both packages' engines alike: every scenario gives the same
rows in the same order, the same ``fault_log`` kinds, dead letters and
telemetry. Inside the port, bit for bit: a retried window equals the
clean run, and after a quarantine the stream goes on as the clean run
that never had that window (sync, and pipelined with its successors in
flight); a failed fused megastep falls back to the per-lane path.
"""
import numpy as np
import pytest

from test_torch_checkpoint import (assert_bitwise, assert_rows_match, both,
                                   fault_kinds, key, side)

torch = pytest.importorskip("torch")


def _drive(s, seed, n=40):
    inj = s.FaultInjector(s.FaultConfig(seed=seed, step_error_rate=0.2,
                                        nan_rate=0.2, stall_rate=0.1,
                                        stall_ms=0.0))
    eng = inj.wrap(s.stub())
    trace = []
    for i in range(n):
        try:
            res = eng.infer([i, None, i + 1])
            trace.append([None if r is None else
                          bool(np.isfinite(r.logits).all()) for r in res])
        except s.InjectedFault:
            trace.append("err")
    return trace, dict(inj.counters)


@pytest.mark.parametrize("seed", [3, 4])
def test_injector_draws_the_jax_package_schedule(seed):
    j, t = both(_drive, seed)
    assert j == t
    trace, counters = t
    assert counters["errors"] and counters["nans"] and counters["stalls"]
    assert _drive(side("port"), seed) == t       # deterministic per seed


def test_scripted_faults_kill_revive_and_transparency():
    s = side("port")
    inj = s.FaultInjector()
    stub = s.stub()
    eng = inj.wrap(stub)
    assert np.isfinite(eng.infer([7])[0].logits).all()
    inj.fail_next(kind="error")
    with pytest.raises(s.InjectedFault):
        eng.infer([7])
    inj.fail_next(kind="nan")
    assert not np.isfinite(eng.infer([7])[0].logits).any()
    inj.kill("stub")
    with pytest.raises(s.InjectedFault, match="killed"):
        eng.infer([7])
    assert stub.infer_calls == 2 and inj.killed("stub")
    inj.revive("stub")
    assert np.isfinite(eng.infer([7])[0].logits).all()
    inj.fail_next("frame", kind="error")
    eng.infer([7])
    assert inj._scripted                         # not this modality's
    inj.fail_next(kind="error", site="prepare")
    with pytest.raises(s.InjectedFault, match="packing"):
        eng.prepare([1], batch_size=1)
    with pytest.raises(ValueError):
        inj.fail_next(kind="nan", site="prepare")
    # The split surfaces only when the inner engine has it, and writes
    # land on the inner engine.
    assert getattr(eng, "infer_dispatch", None) is None
    loop = inj.wrap(s.loop())
    assert loop.infer_dispatch is not None and loop.inner.modality == "event"
    eng.duration_us = 1000
    assert stub.duration_us == 1000


def _stub_recovery(s):
    """Retry with backoff, retry exhaustion, NaN quarantine and lane
    death on a stub lane: rows per step, fault log, dead letters and
    telemetry."""
    inj = s.FaultInjector()
    stub = s.stub()
    eng = s.engine(lanes=(inj.wrap(stub),), max_streams=1,
                   recovery=s.RecoveryConfig(max_retries=1, backoff_steps=1,
                                             dead_after=3))
    h = eng.open("stub", stream_id="h")
    steps = []

    def step(n=1):
        for _ in range(n):
            steps.append(key(eng.step()))

    h.submit(5)
    inj.fail_next(kind="error")
    step(3)                                      # fail, back off, serve
    h.submit(6)
    inj.fail_next(kind="error", count=2)
    step(4)                                      # fail, back off, dead-letter
    h.submit(7)
    inj.fail_next(kind="nan")
    step()                                       # quarantined at once
    inj.kill("stub")
    for k in range(3):
        h.submit(10 + k)
        step(2)
    calls = stub.infer_calls
    h.submit(20)
    step()                                       # dead: fail fast
    assert stub.infer_calls == calls
    tel = eng.telemetry()
    inj.revive("stub")
    eng.replace_lane_engine("stub", engine=s.stub())
    h.submit(21)
    step()
    letters = [(d.stream_id, d.seq, d.item) for d in eng.dead_letters()]
    return (steps, fault_kinds(eng), letters,
            (tel.retries, tel.quarantined, tel.dead, tel.fault_rate),
            h.stats.snapshot().retries, eng.telemetry().dead)


def test_retry_quarantine_and_lane_death_on_a_stub_lane():
    j, t = both(_stub_recovery)
    assert j == t
    steps, kinds, letters, tel, retries, dead = t
    assert steps[:3] == [[], [], [("h", 0, "ok", "stub")]]
    assert steps[5] == [("h", 1, "failed", "stub")]
    assert steps[7] == [("h", 2, "failed", "stub")]
    assert kinds[:4] == [("retry", "stub", "h", 0), ("retry", "stub", "h", 1),
                         ("quarantine", "stub", "h", 1),
                         ("quarantine", "stub", "h", 2)]
    assert ("lane_dead", "stub", None, None) in kinds
    assert kinds[-1] == ("lane_replaced", "stub", None, None)
    assert letters[:2] == [("h", 1, 6), ("h", 2, 7)]
    assert tel[2] and not dead and retries >= 2
    assert steps[-1] == [("h", 7, "ok", "stub")]


def _quarantine(s, depth):
    """w0 ok (beside a stateless lane-mate), then w1 NaN-poisoned, w2 and
    w3 ok on a stateful stream: it goes on from its pre-w1 carry.
    Pipelined two deep, w2 and w3 are in flight when w1 is quarantined,
    and are pulled back and served again from the rolled-back carry."""
    ws = s.windows(4, seed=11)
    inj = s.FaultInjector()
    eng = s.engine(wrap=inj.wrap, max_streams=2, pipeline_depth=depth,
                   recovery=s.RecoveryConfig())
    h = eng.open(stream_id="h", stateful=True)
    eng.open(stream_id="m").submit(s.windows(1, seed=12)[0])
    h.submit(ws[0])
    rows = eng.run()
    for w in ws[1:]:
        h.submit(w)
    inj.fail_next(kind="nan")
    rows += eng.run()
    return (rows, fault_kinds(eng),
            [(d.stream_id, d.seq, d.error) for d in eng.dead_letters()],
            s.alone("h", [ws[0], ws[2], ws[3]]))


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "pipelined"])
def test_quarantine_rolls_carry_back(depth):
    (j_rows, j_log, j_dl, _), (t_rows, t_log, t_dl, clean) = both(
        _quarantine, depth)
    assert_rows_match(j_rows, t_rows)
    assert t_log == j_log and t_dl == j_dl == [("h", 1, "non-finite logits")]
    if depth:
        assert ("requeue", "event", "h", 2) in t_log
    failed = [r for r in t_rows if not r.ok]
    assert [(r.stream_id, r.seq) for r in failed] == [("h", 1)]
    mine = sorted((r for r in t_rows if r.stream_id == "h" and r.ok),
                  key=lambda r: r.seq)
    assert [r.seq for r in mine] == [0, 2, 3]
    for r, want in zip(mine, clean):
        for f in ("label_pred", "logits", "pwm"):
            np.testing.assert_array_equal(getattr(r.result, f),
                                          getattr(want.result, f))
        assert r.result.energy_mj == want.result.energy_mj


def _pipelined_retry(s, seed_fault):
    """Stateful streams, depth 2, collects failing (scripted, or from a
    seeded rate): every window is eventually served, and retries roll
    the carry back."""
    streams = {f"s{i}": s.windows(4, seed=5 + i) for i in range(3)}
    if seed_fault is None:
        inj = s.FaultInjector()
    else:
        inj = s.FaultInjector(s.FaultConfig(seed=seed_fault,
                                            step_error_rate=0.3))
    eng = s.engine(wrap=inj.wrap, max_streams=2, pipeline_depth=2,
                   recovery=s.RecoveryConfig(max_retries=8,
                                             backoff_steps=1,
                                             dead_after=50))
    hs = {sid: eng.open(stream_id=sid, stateful=True) for sid in streams}
    for k in range(4):
        for sid, ws in streams.items():
            hs[sid].submit(ws[k])
    if seed_fault is None:
        inj.fail_next(kind="error")
    rows = []
    for _ in range(80):
        rows += eng.step()
        if not eng.pending() and not eng.in_flight:
            break
    return (rows, fault_kinds(eng), eng.telemetry().retries,
            {sid: s.alone(sid, ws) for sid, ws in streams.items()})


@pytest.mark.parametrize("seed_fault", [None, 7], ids=["scripted",
                                                       "seeded"])
def test_pipelined_retry_equals_the_clean_run(seed_fault):
    (j_rows, j_log, j_n, _), (t_rows, t_log, t_n, alone) = both(
        _pipelined_retry, seed_fault)
    assert_rows_match(j_rows, t_rows)
    assert t_log == j_log and t_n == j_n >= 1
    assert all(r.ok for r in t_rows) and len(t_rows) == 12
    for sid, want in alone.items():
        assert_bitwise(want, [r for r in t_rows if r.stream_id == sid])


def _megastep_fault(s, depth, site, fault=True):
    """Two stateful fused sessions under the megastep with recovery, and
    one scripted fault on the event wing: a step fault (at the fused
    call's collect when synchronous, at the event lane's collect when
    pipelined) or a host packing fault (inside the fused call)."""
    data = [(s.windows(3, seed=30 + i), s.frames(3, seed=40 + i))
            for i in range(2)]
    inj = s.FaultInjector()
    eng = s.engine(lanes=("event", "frame"), wrap=inj.wrap, max_streams=2,
                   megastep=True, pipeline_depth=depth,
                   recovery=s.RecoveryConfig(backoff_steps=0))
    sess = [s.FusionSession(eng, session_id=f"f{i}", stateful=True)
            for i in range(2)]
    for t in range(3):
        for ss, (evs, frs) in zip(sess, data):
            ss.submit(evs[t], frs[t])
    if fault:
        inj.fail_next("event", kind="error", site=site)
    out = []
    for _ in range(30):
        rows = eng.step()
        for ss in sess:
            rows = ss.absorb(rows)
            out += ss.drain()
        if len(out) == 6:
            break
    return (out, fault_kinds(eng), inj.counters["scripted"],
            len(eng.compiled_megastep_keys()))


@pytest.mark.parametrize("depth,site", [(0, "step"), (1, "step"),
                                        (0, "prepare")],
                         ids=["sync", "pipelined", "prepare"])
def test_megastep_fault_matches_jax_and_recovers(depth, site):
    """The JAX package's behaviour, whatever it is: a synchronous fused
    call that fails falls back to the per-lane path for that step (the
    scripted fault was spent in the fused call, so nothing is retried);
    a pipelined collect fails on its lane and is retried. Either way the
    ticks equal the run without a fault, bit for bit."""
    (j_out, j_log, j_n, j_keys), (t_out, t_log, t_n, t_keys) = both(
        _megastep_fault, depth, site)
    assert_rows_match(j_out, t_out)
    assert t_log == j_log and t_n == j_n == 1 and t_keys == j_keys == 1
    assert bool(t_log) == (depth == 1)
    assert all(r.ok for r in t_out) and len(t_out) == 6
    clean, *_ = _megastep_fault(side("port"), depth, site, fault=False)
    assert_bitwise(clean, t_out)


def test_collect_exception_without_recovery_keeps_inflight():
    """Recovery off: a failed collect raises and leaves the record in
    flight; stepping again collects every window once."""
    def scenario(s):
        inj = s.FaultInjector()
        eng = s.engine(lanes=("event",), wrap=inj.wrap, max_streams=2,
                       pipeline_depth=1)
        h = eng.open(stateful=True)
        ws = s.windows(2, seed=50)
        h.submit(ws[0])
        assert eng.step() == []
        h.submit(ws[1])
        inj.fail_next(kind="error")
        with pytest.raises(s.InjectedFault):
            eng.step()
        n = len(eng._inflight)
        rows = []
        for _ in range(4):
            rows += eng.step()
        return rows + eng.flush(), n

    (j_rows, j_n), (t_rows, t_n) = both(scenario)
    assert_rows_match(j_rows, t_rows)
    assert t_n == j_n == 2 and [r.seq for r in t_rows] == [0, 1]


def test_close_with_windows_in_flight():
    def scenario(s):
        eng = s.engine(lanes=(s.stub(),), max_streams=2, pipeline_depth=2)
        a = eng.open(stream_id="a")
        b = eng.open(stream_id="b")
        for k in range(2):
            a.submit(10 + k)
            b.submit(20 + k)
        eng.step()
        eng.step()
        dropped = a.close()
        rows = eng.flush()
        return key(rows), dropped, a.close(), [
            float(np.unique(r.result.logits)[0]) for r in rows]

    j, t = both(scenario)
    assert j == t == ([("b", 0, "ok", "stub"), ("b", 1, "ok", "stub")], 2,
                      0, [20.0, 21.0])


def _degraded(s, megastep):
    """A fused session on real engines: the frame wing is killed after
    three ticks; the ticks degrade to the event wing, then both wings
    are killed and the ticks fail, in order."""
    evs, frs = s.windows(8, seed=60), s.frames(8, seed=61)
    inj = s.FaultInjector()
    eng = s.engine(lanes=("event", "frame"), wrap=inj.wrap, max_streams=1,
                   megastep=megastep,
                   recovery=s.RecoveryConfig(max_retries=0,
                                             backoff_steps=0,
                                             dead_after=2))
    sess = s.FusionSession(eng, session_id="f", stateful=True)
    rows = []
    for t in range(3):
        sess.submit(evs[t], frs[t])
        rows += sess.step()
    inj.kill("frame")
    for t in range(3, 6):
        sess.submit(evs[t], frs[t])
    for _ in range(20):
        rows += sess.step()
        if len(rows) == 6:
            break
    health = sess.wing_health()
    inj.kill("event")
    for t in range(6, 8):
        sess.submit(evs[t], frs[t])
    for _ in range(20):
        rows += sess.step()
        if len(rows) == 8:
            break
    counts = (sess.ticks_fused, sess.ticks_degraded, sess.ticks_failed,
              dict(sess.wing_failures))
    return rows, health, counts, fault_kinds(eng), s.alone("e", evs[:6])


@pytest.mark.parametrize("megastep", [False, True], ids=["lanes", "mega"])
def test_fusion_degrades_to_the_surviving_wing(megastep):
    (j_rows, j_health, j_counts, j_log, _), (t_rows, t_health, t_counts,
                                             t_log, alone) = both(
        _degraded, megastep)
    assert_rows_match(j_rows, t_rows)
    assert t_health == j_health and t_counts == j_counts
    assert t_log == j_log
    assert [r.status for r in t_rows] == (["ok"] * 3 + ["degraded"] * 3
                                          + ["failed"] * 2)
    assert all(r.result.breakdown["degraded_wing"] == "frame"
               for r in t_rows[3:6])
    assert t_health["frame"]["dead"] and not t_health["event"]["dead"]
    assert t_counts[1:] == (3, 2, {"event": 2, "frame": 5})
    # The surviving event wing's windows are the clean run's, bit for bit
    # (degraded ticks carry the wing's own result).
    for r, want in zip(t_rows[3:6], alone[3:6]):
        for f in ("label_pred", "logits", "pwm"):
            np.testing.assert_array_equal(getattr(r.result, f),
                                          getattr(want.result, f))
