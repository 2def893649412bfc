"""DeadlinePolicy and per-window deadlines in the port, against the JAX
package.

Mirrors ``test_slot_policy.py``'s DeadlinePolicy scenarios (on stub
engines, whose results echo their token, so only scheduling is under
test), ``test_stateful_stream.py``'s state-follows-the-stream reorder and
``test_fusion_sched.py``'s deadline reorder of fused sessions. Every
scenario runs through both packages: the same rows in the same order,
and the policies' aging tables agree. Inside the port, a stateful
stream reordered by deadlines equals its uninterrupted run bit for bit,
and fused ticks equal the wings served on separate engines.
"""
import numpy as np
import pytest

from test_torch_checkpoint import (assert_bitwise, assert_rows_match, both,
                                   key, side)

torch = pytest.importorskip("torch")


def _stub_engine(s, slots, **config):
    return s.engine(lanes=(s.stub(),), max_streams=slots, **config)


def _handles(eng, ids, **kw):
    return {sid: eng.open(stream_id=sid, **kw) for sid in ids}


def _urgent_first(s):
    eng = _stub_engine(s, 1, policy=s.DeadlinePolicy())
    hs = _handles(eng, ["slack", "late", "urgent", "undated", "dated"])
    hs["slack"].submit(1, deadline=900.0)
    hs["late"].submit(2, deadline=300.0)
    hs["urgent"].submit(3, deadline=10.0)
    hs["undated"].submit(4)                      # None sorts last
    hs["dated"].submit(5, deadline=1e9)
    return eng.run()


def test_deadline_policy_serves_urgent_first():
    j, t = both(_urgent_first)
    assert key(j) == key(t)
    assert [r.stream_id for r in t] == ["urgent", "late", "slack", "dated",
                                        "undated"]


def _starvation(s, seed):
    """Urgent streams resubmit tiny deadlines every step; an undeadlined
    stream waits. Returns the steps at which it was served."""
    policy = s.DeadlinePolicy(fair_quantum=2, max_wait=8)
    eng = _stub_engine(s, 1, policy=policy)
    hs = _handles(eng, ["slack", "urgent0", "urgent1"])
    rng = np.random.default_rng(seed)
    hs["slack"].submit(0)
    served = []
    for step_i in range(120):
        for u in range(2):
            if rng.random() < 0.9:
                hs[f"urgent{u}"].submit(step_i,
                                        deadline=float(rng.integers(0, 10)))
        if not eng.pending():
            continue
        for r in eng.step():
            if r.stream_id == "slack":
                served.append(step_i)
                hs["slack"].submit(step_i)
    return served, [eng.stream_stats[f"urgent{u}"].windows for u in (0, 1)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_deadline_policy_never_starves(seed):
    (j_served, j_urgent), (t_served, t_urgent) = both(_starvation, seed)
    assert t_served == j_served and t_urgent == j_urgent
    assert t_served, "slack stream was starved"
    assert np.diff([0] + t_served).max() <= (8 + 2 + 2) * 2
    assert min(t_urgent) > 10


def _aging(s):
    """Drained waiting entries leave the aging table; aging counts rounds,
    not slot fills; close forgets a stream."""
    policy = s.DeadlinePolicy(max_wait=16)
    eng = _stub_engine(s, 4, policy=policy)
    hs = _handles(eng, [f"s{i}" for i in range(5)])
    for i, h in hs.items():
        for _ in range(3):
            h.submit(int(i[1:]), deadline=float(i[1:]))
    rows = eng.step()
    waited = dict(policy._waited)
    assert waited == {"s4": 1}                   # one round -> aged once
    hs["s4"].close()
    assert "s4" not in policy._waited
    rows += eng.run()
    for k in range(20):
        eng.open(stream_id=f"e{k}").submit(k, deadline=float(k))
    rows += eng.run()
    assert not eng._lanes["stub"].waiting and not policy._waited
    return rows


def test_deadline_aging_and_forget():
    j, t = both(_aging)
    assert key(j) == key(t)


def _resize_bookkeeping(s):
    """A resize leaves the aging table alone; evicted streams rejoin the
    line and age normally; the grown slot goes to the aged stream."""
    policy = s.DeadlinePolicy(max_wait=16)
    eng = _stub_engine(s, 2, policy=policy)
    hs = _handles(eng, ["a", "b", "aged"])
    for sid, dl in (("a", 1.0), ("b", 2.0), ("aged", 9.0)):
        for _ in range(4):
            hs[sid].submit(0, deadline=dl)
    rows = eng.step()
    assert policy._waited == {"aged": 1}
    assert eng.resize_lane(slots=1) == ["b"]
    assert policy._waited == {"aged": 1}
    rows += eng.step()
    assert policy._waited == {"aged": 2, "b": 1}
    eng.resize_lane(slots=4)
    assert policy._waited == {"aged": 2, "b": 1}
    rows += eng.step()
    assert {r.stream_id for r in rows[-3:]} == {"a", "b", "aged"}
    hs["b"].close()
    rows += eng.run()
    assert not policy._waited
    return rows


def test_deadline_bookkeeping_survives_resize():
    j, t = both(_resize_bookkeeping)
    assert key(j) == key(t)


def _max_wait_across_resizes(s):
    policy = s.DeadlinePolicy(fair_quantum=2, max_wait=4)
    eng = _stub_engine(s, 1, policy=policy)
    hs = _handles(eng, ["slack", "urgent"])
    hs["slack"].submit(0)
    rows = []
    for step_i in range(30):
        hs["urgent"].submit(step_i, deadline=0.0)
        if step_i in (3, 7):
            eng.resize_lane(slots=2)
        elif step_i in (5, 9):
            eng.resize_lane(slots=1)
        rows += eng.step()
        if any(r.stream_id == "slack" for r in rows):
            break
    return rows


def test_deadline_max_wait_bound_holds_across_resizes():
    j, t = both(_max_wait_across_resizes)
    assert key(j) == key(t)
    assert any(r.stream_id == "slack" for r in t)


def _miss_telemetry(s):
    """A finite deadline is an instant on ``deadline_clock``; handle
    defaults apply to windows submitted without one."""
    eng = _stub_engine(s, 2)
    eng.deadline_clock = lambda: 100.0
    missed = eng.open(stream_id="missed", deadline=50.0)
    met = eng.open(stream_id="met")
    undated = eng.open(stream_id="undated")
    missed.submit(1)                             # default 50: past, missed
    met.submit(2, deadline=200.0)                # still ahead: met
    undated.submit(3)                            # not counted
    rows = eng.run()
    snaps = {sid: eng.stream_stats[sid].snapshot()
             for sid in ("missed", "met", "undated")}
    assert snaps["missed"].deadline_miss_rate == 1.0
    assert snaps["met"].deadline_miss_rate == 0.0
    assert snaps["undated"].horizon_deadline_windows == 0
    tel = eng.telemetry()
    assert tel.deadline_miss_rate == 0.5 and tel.windows == 3
    return rows, {k: (v.deadline_windows, v.deadline_missed)
                  for k, v in snaps.items()}


def test_deadline_miss_telemetry_uses_engine_clock():
    (j_rows, j_snaps), (t_rows, t_snaps) = both(_miss_telemetry)
    assert key(j_rows) == key(t_rows) and j_snaps == t_snaps


class _Recording:
    """Wraps a policy, recording each round's slot assignment."""

    def __init__(self, policy):
        self.policy = policy
        self.history = []

    def assign(self, lane):
        self.policy.assign(lane)
        self.history.append(list(lane.slots))

    def forget(self, sid):
        self.policy.forget(sid)


def _state_follows_stream(s):
    """A stateful stream rotated out by urgent traffic and re-admitted,
    into another slot, under DeadlinePolicy: its carry follows it."""
    carry = s.windows(4, seed=70)
    u0, u1 = s.windows(4, seed=80), s.windows(3, seed=81)
    rec = _Recording(s.DeadlinePolicy(fair_quantum=1, aging=0.0,
                                      max_wait=2))
    eng = s.engine(max_streams=2, policy=rec)
    hs = {"carry": eng.open(stream_id="carry", stateful=True),
          "urgent0": eng.open(stream_id="urgent0"),
          "urgent1": eng.open(stream_id="urgent1")}
    for k, w in enumerate(carry):
        hs["carry"].submit(w, deadline=1000.0 + k)
    for w in u0:
        hs["urgent0"].submit(w, deadline=0.0)
    rows = eng.step() + eng.step()
    for w in u1:
        hs["urgent1"].submit(w, deadline=0.0)
    rows += eng.run()
    held = {i for rnd in rec.history for i, sid in enumerate(rnd)
            if sid == "carry"}
    assert len(rows) == 11 and len(held) >= 2, rec.history
    return rows, s.alone("carry", carry)


def test_state_follows_stream_across_deadline_reorder():
    (j_rows, _), (t_rows, t_alone) = both(_state_follows_stream)
    assert_rows_match(j_rows, t_rows)
    assert_bitwise(t_alone, [r for r in t_rows if r.stream_id == "carry"])


def _fused_deadline(s, policy):
    """Four fused sessions over two slots a lane under the megastep, with
    per-session deadlines: returns ({session: ticks in seq order}, the
    lanes' paired tick rates)."""
    sessions, ticks = 4, 3
    data = [(s.windows(ticks, seed=10 + i), s.frames(ticks, seed=20 + i))
            for i in range(sessions)]
    eng = s.engine(lanes=("event", "frame"), max_streams=2,
                   policy=policy(s), megastep=True)
    sess = [s.FusionSession(eng, session_id=f"s{i}", stateful=True,
                            deadline=float(sessions - i))
            for i in range(sessions)]
    for t in range(ticks):
        for ss, (evs, frs) in zip(sess, data):
            ss.submit(evs[t], frs[t])
    out = {ss.session_id: [] for ss in sess}
    order = []
    for _ in range(200):
        rows = eng.step()
        for ss in sess:
            rows = ss.absorb(rows)
            got = ss.drain()
            out[ss.session_id] += got
            order += got
        if len(order) == sessions * ticks:
            break
    return order, out, [eng.telemetry(m).paired_tick_rate
                        for m in ("event", "frame")]


def test_deadline_reorder_keeps_pairing_and_parity():
    """Under DeadlinePolicy, fused sessions come out in the JAX package's
    order with its results, both wings of every tick share a step, and
    each session's ticks equal FairQuantumPolicy's bit for bit (only the
    order of serving moves)."""
    (j_order, _, j_rate), (t_order, t_out, t_rate) = both(
        _fused_deadline, lambda s: s.DeadlinePolicy())
    assert_rows_match(j_order, t_order)
    assert t_rate == j_rate == [1.0, 1.0]
    _, fair, _ = _fused_deadline(side("port"),
                                 lambda s: s.FairQuantumPolicy())
    for sid, ticks in t_out.items():
        assert [r.seq for r in ticks] == [0, 1, 2]
        assert_bitwise(fair[sid], ticks)
