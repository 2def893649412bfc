"""Telemetry and lane control in the port, against the JAX package.

Mirrors ``test_fleet.py``'s telemetry, resize and drain scenarios (on
stub engines, whose results echo their token) and adds real-engine
ones: every scenario runs through both packages with the same rows in
the same order and the same ``telemetry`` fields. Inside the port, bit
for bit: ``resize_lane`` mid-stream (8 -> 4 -> 8 slots, stateful, sync
and pipelined) equals the uninterrupted run, the new batch size's key is
prepared inside ``resize_lane`` (before its first step) and repeated
cycles add no key; ``abort_lane`` + ``replace_lane_engine`` + restore
equals the uninterrupted run, and a replaced lane under the megastep
drops the fused keys.
"""
import dataclasses

import pytest

from test_torch_checkpoint import (assert_bitwise, assert_rows_match, both,
                                   key, side)

torch = pytest.importorskip("torch")


def _tel(eng, modality=None):
    """A lane's telemetry as plain values (snapshots by stream)."""
    t = eng.telemetry(modality)
    d = dataclasses.asdict(t)
    d["streams"] = {sid: {k: v for k, v in dataclasses.asdict(s).items()
                          if k != "windows_per_s"}
                    for sid, s in t.streams.items()}
    d.pop("windows_per_s")            # wall-clock rate: differs by run
    return d, (t.fault_rate, t.backlog_per_slot, t.occupancy)


def test_stats_snapshot_derived_rates_and_horizon():
    def scenario(s):
        st = s.StreamStats(horizon=8)
        st.windows, st.queued = 3, 7
        st.note_completion(10.0, 3, None)
        st.note_completion(11.0, 1, True)
        st.note_completion(12.0, 2, False)
        short = s.StreamStats(horizon=2)
        empty = short.snapshot()
        for t, d, m in ((1.0, 9, True), (2.0, 1, False), (3.0, 1, False)):
            short.note_completion(t, d, m)
        return [dataclasses.asdict(x) for x in (st.snapshot(), empty,
                                                short.snapshot())]

    j, t = both(scenario)
    assert j == t
    snap, empty, short = t
    assert snap["windows_per_s"] == 1.0 and snap["queue_depth_p95"] == 3.0
    assert snap["deadline_miss_rate"] == 0.5
    assert empty["windows_per_s"] == 0.0
    assert short["deadline_missed"] == 1 and short["horizon_missed"] == 0
    with pytest.raises(dataclasses.FrozenInstanceError):
        side("port").StreamStats().snapshot().windows = 9


def _lane_counts(s):
    eng = s.engine(lanes=(s.stub(),), max_streams=2)
    hs = [eng.open(stream_id=f"s{i}") for i in range(3)]
    for h in hs:
        for k in range(2):
            h.submit(k)
    tels = [_tel(eng)]
    rows = eng.step()
    tels.append(_tel(eng))
    rows += eng.run()
    tels.append(_tel(eng))
    return rows, tels


def test_lane_telemetry_counts():
    (j_rows, j_tel), (t_rows, t_tel) = both(_lane_counts)
    assert key(j_rows) == key(t_rows) and j_tel == t_tel
    first, second, last = (t[0] for t in t_tel)
    assert (first["queued"], first["waiting"], first["occupied"]) == (6, 3,
                                                                      0)
    assert t_tel[0][1][1] == 3.0                 # backlog per slot
    assert second["occupied"] == 2 and t_tel[1][1][2] == 1.0
    assert last["queued"] == 0 and last["windows"] == 6


def _in_flight(s):
    eng = s.engine(lanes=(s.stub(), s.stub("stub2")), max_streams=1,
                   pipeline_depth=1)
    eng.open("stub", stream_id="a").submit(1)
    eng.open("stub2", stream_id="b").submit(2)
    eng.step()
    with pytest.raises(ValueError, match="modality required"):
        eng.telemetry()
    inflight = [eng.telemetry(m).in_flight for m in ("stub", "stub2")]
    rows = eng.flush()
    return rows, inflight + [eng.telemetry("stub").in_flight]


def test_telemetry_counts_in_flight():
    (j_rows, j_n), (t_rows, t_n) = both(_in_flight)
    assert key(j_rows) == key(t_rows) and j_n == t_n == [1, 1, 0]


def _resize_semantics(s):
    eng = s.engine(lanes=(s.stub(),), max_streams=4, pipeline_depth=1)
    hs = {c: eng.open(stream_id=c) for c in "abcd"}
    for h in hs.values():
        for k in range(3):
            h.submit(k)
    rows = eng.step()
    assert eng.resize_lane(slots=4) == []
    evicted = eng.resize_lane(slots=2)
    lane = eng._lanes["stub"]
    eng.open(stream_id="e").submit(9)
    waiting = list(lane.waiting)
    grown = eng.resize_lane(slots=5)
    rows += eng.run()
    with pytest.raises(ValueError, match=">= 1"):
        eng.resize_lane(slots=0)
    return rows, evicted, waiting, grown


def test_resize_grow_and_shrink_semantics():
    (j_rows, *j), (t_rows, *t) = both(_resize_semantics)
    assert key(j_rows) == key(t_rows) and j == t
    evicted, waiting, grown = t
    assert evicted == ["c", "d"] and waiting[:2] == ["c", "d"]
    assert grown == [] and len(t_rows) == 13


def test_resize_prewarms_through_the_engine_cache():
    """Stub: the old count's keys are re-keyed at the new count and warmed
    once. Port engine: the new B's key is in ``compiled_shape_keys``
    right after ``resize_lane``, before any step, and a second 8->4->8
    cycle warms nothing."""
    def scenario(s):
        stub = s.stub(warm=True)
        eng = s.engine(lanes=(stub,), max_streams=2)
        eng.open(stream_id="a").submit(1)
        eng.run()
        eng.resize_lane(slots=4)
        eng.resize_lane(slots=2, warm=False)
        eng.resize_lane(slots=4)
        return stub.warmed

    j, t = both(scenario)
    assert j == t == [((4,),)]
    s = side("port")
    eng = s.engine(max_streams=8, duration_us=300_000)
    eng.warmup([(8, 2048)])
    loop = eng.loop
    calls = []
    warm = loop.warmup
    loop.warmup = lambda keys: (calls.append(list(keys)), warm(keys))
    eng.resize_lane(slots=4)
    assert (4, 2048, 300_000) in loop.compiled_shape_keys()
    eng.resize_lane(slots=8)
    eng.resize_lane(slots=4)
    eng.resize_lane(slots=8)
    assert calls == [[(4, 2048, 300_000)]]
    assert loop.compiled_shape_keys() == {(8, 2048, 300_000),
                                          (4, 2048, 300_000)}


def _resize_mid_stream(s, depth):
    """Eight stateful streams over 8 slots, resized 8 -> 4 -> 8 between
    steps: the carries are parked and re-attached."""
    streams = {f"s{i}": s.windows(4, seed=40 + i) for i in range(8)}
    eng = s.engine(max_streams=8, pipeline_depth=depth)
    hs = {sid: eng.open(stream_id=sid, stateful=True) for sid in streams}
    for k in range(4):
        for sid, ws in streams.items():
            hs[sid].submit(ws[k])
    rows = eng.step()
    evicted = eng.resize_lane(slots=4)
    rows += eng.step() + eng.step()
    eng.resize_lane(slots=8)
    rows += eng.run()
    return rows, evicted, {sid: s.alone(sid, ws)
                           for sid, ws in streams.items()}


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "pipelined"])
def test_resize_mid_stream_equals_uninterrupted(depth):
    (j_rows, j_ev, _), (t_rows, t_ev, t_alone) = both(_resize_mid_stream,
                                                      depth)
    assert_rows_match(j_rows, t_rows)
    assert t_ev == j_ev == ["s4", "s5", "s6", "s7"]
    for sid, alone in t_alone.items():
        assert_bitwise(alone, [r for r in t_rows if r.stream_id == sid])


def _drain_one_lane(s):
    eng = s.engine(lanes=(s.stub(), s.stub("stub2")), max_streams=1,
                   pipeline_depth=2)
    a = eng.open("stub", stream_id="a")
    b = eng.open("stub2", stream_id="b")
    for k in range(2):
        a.submit(k)
        b.submit(10 + k)
    eng.step()
    eng.step()
    drained = eng.drain_lane("stub")
    left = eng.in_flight
    return drained, left, eng.flush()


def test_drain_lane_collects_one_lane_only():
    (j_d, j_n, j_rest), (t_d, t_n, t_rest) = both(_drain_one_lane)
    assert key(j_d) == key(t_d) and key(j_rest) == key(t_rest)
    assert [(r.stream_id, r.seq) for r in t_d] == [("a", 0), ("a", 1)]
    assert t_n == j_n == 2
    assert [(r.stream_id, r.seq) for r in t_rest] == [("b", 0), ("b", 1)]


def _drain_then_checkpoint(s):
    """A live migration by hand: drain the stream's lane (the frame lane
    stays in flight), checkpoint, restore elsewhere, serve on."""
    evs, frs = s.windows(4, seed=90), s.frames(2, seed=91)
    eng = s.engine(lanes=("event", "frame"), max_streams=2,
                   pipeline_depth=2)
    h = eng.open("event", stream_id="e", stateful=True)
    cam = eng.open("frame", stream_id="cam")
    for k in range(3):
        h.submit(evs[k])
    for f in frs:
        cam.submit(f)
    eng.step()
    eng.step()
    with pytest.raises(ValueError, match="in-flight"):
        h.checkpoint()
    rows = eng.drain_lane("event")
    assert eng.telemetry("frame").in_flight == 2
    ck = h.checkpoint()
    h.close()
    dst = s.engine(max_streams=1)
    moved = dst.restore(ck)
    moved.submit(evs[3])
    rows += dst.run() + eng.run()
    return rows, s.alone("e", evs)


def test_drain_lane_then_checkpoint_migrates_live():
    (j_rows, _), (t_rows, t_alone) = both(_drain_then_checkpoint)
    assert_rows_match(j_rows, t_rows)
    assert_bitwise(t_alone, [r for r in t_rows if r.stream_id == "e"])


def _abort_replace_restore(s, megastep):
    """Checkpoint stateful streams, keep serving pipelined, abort the
    event lane with records in flight, install a rebuilt engine, restore
    the checkpoints into fresh handles and serve the rest."""
    evs = {f"e{i}": s.windows(5, seed=100 + i) for i in range(2)}
    frs = s.frames(5, seed=110)
    eng = s.engine(lanes=("event", "frame"), max_streams=2,
                   pipeline_depth=1, megastep=megastep)
    hs = {sid: eng.open("event", stream_id=sid, stateful=True)
          for sid in evs}
    cam = eng.open("frame", stream_id="cam")
    for sid, ws in evs.items():
        for w in ws[:2]:
            hs[sid].submit(w)
    for f in frs[:2]:
        cam.submit(f)
    rows = eng.run()
    ckpts = {sid: h.checkpoint() for sid, h in hs.items()}
    for sid, ws in evs.items():
        hs[sid].submit(ws[2])
    cam.submit(frs[2])
    eng.step()                                   # both lanes in flight
    with pytest.raises(ValueError, match="in-flight"):
        eng.replace_lane_engine("event", engine=s.loop())
    requeued = eng.abort_lane("event")
    assert eng.telemetry("frame").in_flight == 1
    mega_before = len(eng.compiled_megastep_keys())
    eng.replace_lane_engine("event", engine=s.loop())
    mega_after = len(eng.compiled_megastep_keys())
    for sid in evs:
        hs[sid].close()                          # restart from checkpoint
        h = eng.restore(ckpts[sid])
        for w in evs[sid][2:]:
            h.submit(w)
    for f in frs[3:]:
        cam.submit(f)
    rows += eng.run()
    alone = {sid: s.alone(sid, ws) for sid, ws in evs.items()}
    return rows, requeued, (mega_before, mega_after), eng.fault_log, alone


@pytest.mark.parametrize("megastep", [False, True], ids=["lanes", "mega"])
def test_abort_replace_and_restore_equals_uninterrupted(megastep):
    j, t = both(_abort_replace_restore, megastep)
    (j_rows, j_req, j_mega, j_log, _), (t_rows, t_req, t_mega, t_log,
                                        t_alone) = j, t
    assert_rows_match(j_rows, t_rows)
    assert t_req == j_req == 2
    assert t_mega == j_mega == ((1, 0) if megastep else (0, 0))
    assert [f["kind"] for f in t_log] == [f["kind"] for f in j_log] == [
        "requeue", "requeue", "lane_replaced"]
    for sid, alone in t_alone.items():
        assert_bitwise(alone, [r for r in t_rows if r.stream_id == sid])


@pytest.mark.parametrize("name", ["jax", "port"])
def test_replace_lane_engine_validation(name):
    s = side(name)
    eng = s.engine(lanes=("event", "frame"), max_streams=1,
                   duration_us=300_000)
    eng.open("event", stateful=True)
    with pytest.raises(ValueError, match="modality"):
        eng.replace_lane_engine("event", engine=s.frame())
    with pytest.raises(ValueError, match="carried-state"):
        eng.replace_lane_engine("event", engine=s.stub("event"))
    with pytest.raises(ValueError, match="duration_us"):
        eng.replace_lane_engine("event",
                                engine=s.loop(duration_us=150_000))
    fresh = s.loop()
    eng.replace_lane_engine("event", engine=fresh)
    assert eng.engines["event"] is fresh and fresh.duration_us == 300_000
    assert [f["kind"] for f in eng.fault_log] == ["lane_replaced"]
