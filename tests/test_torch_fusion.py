"""Heterogeneous lanes, fusion sessions and co-scheduling in the port.

Mirrors the JAX package's session and fusion-scheduling tests
(``test_session_api.py``, ``test_fusion_sched.py``) inside the port, on
the CPU at a small size:

  * one lane per modality; ``open``/``submit`` by modality;
  * a fused tick is bitwise ``late_logit_fusion`` of the two wings served
    on separate single-wing engines, at 1/4/8 sessions, sync and
    pipelined, stateless and stateful (scheduling moves, results do not);
  * foreign rows go to ``unclaimed``; ``submit`` is atomic and detects
    desynchronized wings before queueing anything;
  * co-scheduling keeps both wings of a tick in one engine step under slot
    contention (``fusion_ticks_paired``);
  * the cross-wing megastep (``EngineConfig.megastep``) serves the same
    bits as the per-lane path and as separate engines, keeps its own
    cache of ``(event key, frame key)`` pairs that ``warmup_megastep``
    fills, refuses what the JAX package refuses, and agrees with the JAX
    package's megastep engine on the same inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import snn as jsnn  # noqa: E402
from repro.core import tcn as jtcn  # noqa: E402

from repro_torch.configs import TCN_SMOKE  # noqa: E402
from repro_torch.convert import (snn_params_from_numpy,  # noqa: E402
                                 tcn_params_from_numpy)
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import frames as fr  # noqa: E402
from repro_torch.core import snn as tsnn  # noqa: E402
from repro_torch.core._api import EngineConfig  # noqa: E402
from repro_torch.core.engine import FrameTCNEngine  # noqa: E402
from repro_torch.core.pipeline import (BatchedClosedLoop,  # noqa: E402
                                       pwm_from_logits)
from repro_torch.serving import (FairQuantumPolicy,  # noqa: E402
                                 FusionSession, StreamEngine,
                                 late_logit_fusion)

CFG = tsnn.SNNConfig(height=32, width=32, time_bins=4, conv1_features=4,
                     conv2_features=8, hidden=32, num_classes=11)
TICKS = 3


@pytest.fixture(scope="module")
def params():
    jcfg = jsnn.SNNConfig(height=32, width=32, time_bins=4,
                          conv1_features=4, conv2_features=8, hidden=32,
                          num_classes=11)
    return snn_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jsnn.init_snn(jax.random.PRNGKey(0), jcfg)))


@pytest.fixture(scope="module")
def tparams():
    jcfg = jtcn.TCNConfig(height=32, width=32, conv1_features=4,
                          conv2_features=8, hidden=32, num_classes=11)
    return tcn_params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jtcn.init_tcn(jax.random.PRNGKey(1), jcfg)))


def _windows(n, seed):
    rng = np.random.default_rng(seed)
    return [ev.synthetic_gesture_events(rng, (seed + i) % 11,
                                        mean_events=1200, height=32,
                                        width=32)
            for i in range(n)]


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [fr.synthetic_gesture_frames(rng, (seed + i) % 11, height=32,
                                        width=32)
            for i in range(n)]


def _hetero(params, tparams, **kw):
    return StreamEngine(
        engines=[BatchedClosedLoop(params, CFG, device="cpu"),
                 FrameTCNEngine(tparams, TCN_SMOKE, device="cpu")],
        config=EngineConfig(**kw))


def _tick_data(sessions, ticks=TICKS):
    return [(_windows(ticks, seed=10 + i), _frames(ticks, seed=20 + i))
            for i in range(sessions)]


def _run_fused(params, tparams, data, *, stateful=False, solo=0, **kw):
    """Serve ``data`` through FusionSessions on one engine, routing the
    rows of every step between the sessions; returns ({session_id:
    ticks in seq order}, engine). ``solo`` frames go first to a frame
    stream of no session, opened before the sessions."""
    eng = _hetero(params, tparams, **kw)
    if solo:
        h = eng.open(modality="frame", stream_id="solo")
        for f in _frames(solo, seed=99):
            h.submit(f)
    sess = [FusionSession(eng, session_id=f"s{i}", stateful=stateful)
            for i in range(len(data))]
    for t in range(len(data[0][0])):
        for s, (evs, frs) in zip(sess, data):
            s.submit(evs[t], frs[t])
    out = {s.session_id: [] for s in sess}
    want = len(data) * len(data[0][0])
    done = steps = 0
    foreign = []
    while done < want or len(foreign) < solo:
        rows = eng.step()
        steps += 1
        assert steps < 50 * want
        for s in sess:
            rows = s.absorb(rows)
            got = s.drain()
            out[s.session_id] += got
            done += len(got)
        foreign += rows
    assert [r.stream_id for r in foreign] == ["solo"] * solo
    return out, eng


def _run_separate(params, tparams, data, *, stateful=False):
    """Each session's wings on their own single-wing sync engines."""
    outs = {}
    for i, (evs, frs) in enumerate(data):
        e1 = StreamEngine(engines=[BatchedClosedLoop(params, CFG,
                                                     device="cpu")],
                          config=EngineConfig(max_streams=1))
        e2 = StreamEngine(engines=[FrameTCNEngine(tparams, TCN_SMOKE,
                                                  device="cpu")],
                          config=EngineConfig(max_streams=1))
        he = e1.open(modality="event", stateful=stateful)
        hf = e2.open(modality="frame", stateful=stateful)
        for t in range(len(evs)):
            he.submit(evs[t])
            hf.submit(frs[t])
        outs[f"s{i}"] = (e1.run(), e2.run())
    return outs


def _assert_fused(tick, e, f):
    """One fused tick against late fusion of the two wings' rows."""
    want = np.asarray(late_logit_fusion()(e.result, f.result))
    np.testing.assert_array_equal(tick.result.logits, want)
    np.testing.assert_array_equal(
        tick.result.pwm, pwm_from_logits(torch.from_numpy(want)).numpy())
    np.testing.assert_array_equal(tick.result.label_pred,
                                  np.argmax(want, axis=-1))
    assert tick.result.energy_mj == e.result.energy_mj + f.result.energy_mj
    assert tick.result.latency_ms == max(e.result.latency_ms,
                                         f.result.latency_ms)
    assert tick.result.breakdown["per_wing_energy_mj"] == {
        "event": e.result.energy_mj, "frame": f.result.energy_mj}


def test_hetero_lanes_open_and_submit_by_modality(params, tparams):
    eng = _hetero(params, tparams, max_streams={"event": 2, "frame": 3})
    assert sorted(eng.engines) == ["event", "frame"]
    assert [len(eng._lanes[m].slots) for m in ("event", "frame")] == [2, 3]
    with pytest.raises(AttributeError, match="ambiguous"):
        eng.loop
    with pytest.raises(ValueError, match="modality required"):
        eng.open()
    with pytest.raises(ValueError, match="no engine"):
        eng.open(modality="audio")
    he = eng.open(modality="event", stream_id="cam")
    hf = eng.open("frame")
    assert (he.modality, hf.modality) == ("event", "frame")
    assert eng.modality_of("cam") == "event"
    assert hf.stream_id == "frame-0"
    with pytest.raises(ValueError, match="already open"):
        eng.open(modality="frame", stream_id="cam")
    assert he.submit(_windows(1, seed=1)[0]) == 0
    with pytest.raises(ValueError, match="geometry"):
        hf.submit(fr.synthetic_gesture_frames(np.random.default_rng(0), 1,
                                              height=16, width=16))
    assert hf.submit(_frames(1, seed=2)[0]) == 0
    out = eng.run()
    assert sorted((r.stream_id, r.modality) for r in out) == [
        ("cam", "event"), ("frame-0", "frame")]
    assert eng.compiled_shapes("frame") == {(3, 32, 32, 300_000)}
    assert len(eng.compiled_shapes("event")) == 1
    eng.warmup([(3, 32, 32)], modality="frame")
    with pytest.raises(ValueError, match="modality required"):
        eng.compiled_shapes()
    with pytest.raises(ValueError, match="mutually exclusive"):
        StreamEngine(params, CFG, engines=[
            FrameTCNEngine(tparams, TCN_SMOKE, device="cpu")])
    with pytest.raises(ValueError, match="fuse_fc"):
        StreamEngine(engines=[FrameTCNEngine(tparams, TCN_SMOKE,
                                             device="cpu")],
                     config=EngineConfig(fuse_fc=True))
    with pytest.raises(ValueError, match="duplicate"):
        StreamEngine(engines=[FrameTCNEngine(tparams, TCN_SMOKE,
                                             device="cpu")] * 2)


@pytest.mark.parametrize("megastep", [False, True],
                         ids=["lanes", "megastep"])
@pytest.mark.parametrize("stateful", [False, True],
                         ids=["stateless", "stateful"])
@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "pipelined"])
@pytest.mark.parametrize("sessions", [1, 4, 8])
def test_fused_bitwise_vs_separate(params, tparams, sessions, depth,
                                   stateful, megastep):
    data = _tick_data(sessions)
    fused, eng = _run_fused(params, tparams, data, stateful=stateful,
                            max_streams=sessions, pipeline_depth=depth,
                            megastep=megastep)
    # Every step had work on both lanes: with the megastep on, all of
    # them went through the fused call and none through an engine's own.
    fused_keys = eng.compiled_megastep_keys()
    lane_keys = [e.compiled_shape_keys() for e in eng.engines.values()]
    assert bool(fused_keys) == megastep
    assert all(bool(k) != megastep for k in lane_keys)
    sep = _run_separate(params, tparams, data, stateful=stateful)
    for sid, ticks in fused.items():
        res_e, res_f = sep[sid]
        assert [t.seq for t in ticks] == list(range(TICKS))
        assert all(t.modality == "fusion" and t.stream_id == sid
                   for t in ticks)
        for tick, e, f in zip(ticks, res_e, res_f):
            _assert_fused(tick, e, f)
    for st in eng.stream_stats.values():
        assert st.fusion_ticks == TICKS
        assert st.paired_tick_rate == 1.0


def test_pluggable_rule_and_stats(params, tparams):
    """Weights (1, 0): the fused actuation is the event wing's, bit for
    bit, while the energy still counts both wings."""
    eng = _hetero(params, tparams, max_streams=1)
    sess = FusionSession(eng, fusion=late_logit_fusion(1.0, 0.0))
    evs, frs = _windows(2, seed=200), _frames(2, seed=201)
    for k in range(2):
        assert sess.submit(evs[k], frs[k]) == k
    fused = sess.run()
    sep = StreamEngine(engines=[BatchedClosedLoop(params, CFG,
                                                  device="cpu")],
                       config=EngineConfig(max_streams=1))
    h = sep.open()
    for w in evs:
        h.submit(w)
    for r, ref in zip(fused, sep.run()):
        np.testing.assert_array_equal(r.result.pwm, ref.result.pwm)
        np.testing.assert_array_equal(r.result.label_pred,
                                      ref.result.label_pred)
        assert r.result.energy_mj > ref.result.energy_mj
        assert r.result.breakdown["fusion_rule"] == \
            "late_logit(event=1, frame=0)"
    assert sess.stats["ticks_fused"] == 2
    assert sess.stats["event"].windows == sess.stats["frame"].windows == 2


def test_foreign_rows_go_to_unclaimed(params, tparams):
    eng = _hetero(params, tparams, max_streams={"event": 2, "frame": 1})
    sess = FusionSession(eng)
    solo = eng.open(modality="event", stream_id="solo")
    evs, frs = _windows(2, seed=210), _frames(1, seed=211)
    sess.submit(evs[0], frs[0])
    solo.submit(evs[1])
    fused = sess.run()
    assert [r.stream_id for r in fused] == [sess.session_id]
    assert [r.stream_id for r in sess.unclaimed] == ["solo"]


def test_submit_is_atomic_and_detects_desync(params, tparams):
    eng = _hetero(params, tparams, max_streams=1)
    sess = FusionSession(eng)
    bad = fr.synthetic_gesture_frames(np.random.default_rng(240), 0,
                                      height=16, width=16)
    with pytest.raises(ValueError, match="geometry"):
        sess.submit(_windows(1, seed=241)[0], bad)
    assert sess.event.queued == 0 and sess.frame.queued == 0
    assert sess.submit(_windows(1, seed=242)[0],
                       _frames(1, seed=243)[0]) == 0
    assert len(sess.run()) == 1
    # A submit on one wing's handle outside the session desynchronizes
    # the pair; the next session submit refuses before queueing anything.
    sess.event.submit(_windows(1, seed=230)[0])
    with pytest.raises(RuntimeError, match="desynchronized"):
        sess.submit(_windows(1, seed=231)[0], _frames(1, seed=232)[0])
    assert sess.event.queued == 1 and sess.frame.queued == 0
    eng.run()


def test_construction_is_leak_free_and_close_unpairs(params, tparams):
    eng = _hetero(params, tparams, max_streams=1)
    wrong = eng.open(modality="frame", stream_id="not-an-event")
    with pytest.raises(ValueError, match="event_handle"):
        FusionSession(eng, session_id="s", event_handle=wrong)
    assert set(eng.handles) == {"not-an-event"}
    sess = FusionSession(eng, session_id="s", stateful=True)
    assert eng._pairs == {"s:event": "s:frame", "s:frame": "s:event"}
    with pytest.raises(ValueError, match="already paired"):
        eng.pair_streams("s:event", "not-an-event")
    with pytest.raises(ValueError, match="different lanes"):
        eng.pair_streams("s:frame", "not-an-event")
    sess.submit(_windows(1, seed=250)[0], _frames(1, seed=251)[0])
    sess.reset_state()
    assert sess.close() == 2
    assert eng._pairs == {} and set(eng.handles) == {"not-an-event"}
    # The auto-chosen id skips ids that are taken.
    eng.open(modality="event", stream_id="fusion-0:event")
    assert FusionSession(eng).session_id == "fusion-1"


def _contended(params, tparams, coschedule):
    """Three sessions over 2 slots a lane, quantum 1, and a frame stream
    of no session that holds a frame slot first: the two lanes' policies
    seat different sessions."""
    return _run_fused(params, tparams, _tick_data(3), coschedule=coschedule,
                      solo=TICKS, max_streams=2,
                      policy=FairQuantumPolicy(1))


def test_coschedule_keeps_pairs_in_one_step(params, tparams):
    fused, eng = _contended(params, tparams, coschedule=True)
    sep = _run_separate(params, tparams, _tick_data(3))
    for sid, ticks in fused.items():
        for tick, e, f in zip(ticks, *sep[sid]):
            _assert_fused(tick, e, f)
    for sid, st in eng.stream_stats.items():
        if sid != "solo":
            assert st.fusion_ticks == TICKS
            assert st.fusion_ticks_paired == TICKS
    # The same traffic without co-scheduling splits some ticks' wings
    # over two steps: the knob is what keeps them together.
    _, loose = _contended(params, tparams, coschedule=False)
    rates = [st.paired_tick_rate for st in loose.stream_stats.values()]
    assert min(rates) < 1.0


def test_unpaired_streams_report_unit_rate(params, tparams):
    eng = _hetero(params, tparams, max_streams=1)
    h = eng.open(modality="frame")
    h.submit(_frames(1, seed=3)[0])
    eng.run()
    st = eng.stream_stats[h.stream_id]
    assert st.fusion_ticks == 0 and st.paired_tick_rate == 1.0


# -- the cross-wing megastep ---------------------------------------------------

def test_megastep_off_is_bitwise_identical_to_megastep_on(params, tparams):
    """The megastep is a pure dispatch fusion: same engine, same sessions,
    megastep on vs off -- byte-equal fused ticks (stateful, pipelined)."""
    data = _tick_data(2)
    on, _ = _run_fused(params, tparams, data, stateful=True, max_streams=2,
                       megastep=True, pipeline_depth=1)
    off, _ = _run_fused(params, tparams, data, stateful=True, max_streams=2,
                        megastep=False, pipeline_depth=1)
    for sid in on:
        assert [t.seq for t in on[sid]] == [t.seq for t in off[sid]]
        for a, b in zip(on[sid], off[sid]):
            np.testing.assert_array_equal(a.result.logits, b.result.logits)
            np.testing.assert_array_equal(a.result.pwm, b.result.pwm)
            assert a.result.energy_mj == b.result.energy_mj


def test_megastep_single_winged_steps_take_the_lane_path(params, tparams):
    """Frames of no session queued ahead of the sessions' ticks: steps
    with frame work only take the frame lane's own path, steps with both
    the fused one, and every tick still equals separate serving."""
    data = _tick_data(2)
    fused, eng = _run_fused(params, tparams, data, solo=TICKS,
                            max_streams={"event": 2, "frame": 1},
                            policy=FairQuantumPolicy(1), megastep=True,
                            pipeline_depth=1)
    assert eng.compiled_megastep_keys()
    assert eng.engines["frame"].compiled_shape_keys()
    sep = _run_separate(params, tparams, data)
    for sid, ticks in fused.items():
        for tick, e, f in zip(ticks, *sep[sid]):
            _assert_fused(tick, e, f)


def test_megastep_parks_and_restores_carries(params, tparams):
    """8 stateful sessions over 4 slots a lane, quantum 1, pipelined: the
    wings' carries are parked and restored as sessions lose and regain
    slots, and every tick equals the synchronous per-lane run."""
    data = _tick_data(8)
    kw = dict(stateful=True, max_streams=4, policy=FairQuantumPolicy(1))
    fused, eng = _run_fused(params, tparams, data, megastep=True,
                            pipeline_depth=1, **kw)
    ref, _ = _run_fused(params, tparams, data, megastep=False,
                        pipeline_depth=0, **kw)
    assert eng.compiled_megastep_keys()
    assert eng._lanes["event"].parked and eng.stats["steps"] > TICKS
    for sid in ref:
        for a, b in zip(fused[sid], ref[sid]):
            np.testing.assert_array_equal(a.result.logits, b.result.logits)


def test_megastep_refusals(params, tparams):
    with pytest.raises(ValueError, match="single-device"):
        EngineConfig(megastep=True, mesh=object())
    with pytest.raises(ValueError, match="event and one frame"):
        StreamEngine(engines=[BatchedClosedLoop(params, CFG, device="cpu")],
                     config=EngineConfig(max_streams=1, megastep=True))

    class NoMega:
        duration_us = None

        def __init__(self, modality):
            self.modality = modality

    with pytest.raises(ValueError, match="does not support the fused "
                                         "megastep"):
        StreamEngine(engines=[NoMega("event"), NoMega("frame")],
                     config=EngineConfig(max_streams=1, megastep=True))
    plain = _hetero(params, tparams, max_streams=1)
    assert plain.compiled_megastep_keys() == set()
    with pytest.raises(ValueError, match="megastep"):
        plain.warmup_megastep([((1, 2048, 300_000), (1, 32, 32, 300_000))])


def test_megastep_warmup_precompiles(params, tparams):
    def mk():
        return _hetero(params, tparams, max_streams=1, megastep=True)

    (evs, frs), = _tick_data(1, ticks=1)
    # Discover the workload's fused key pair by serving it once...
    probe = mk()
    s0 = FusionSession(probe, session_id="s0")
    s0.submit(evs[0], frs[0])
    [r] = s0.run()
    assert r.modality == "fusion"
    [key] = probe.compiled_megastep_keys()
    ev_key, fr_key = key
    assert ev_key[0] == fr_key[0] == 1 and fr_key[1:] == (32, 32, 300_000)
    # ...then warm a fresh engine with it: serving hits the cache (no new
    # entry) and leaves the engines' own caches empty.
    eng = mk()
    assert eng.compiled_megastep_keys() == set()
    eng.warmup_megastep([key])
    assert eng.compiled_megastep_keys() == {key}
    s1 = FusionSession(eng, session_id="s0")
    s1.submit(evs[0], frs[0])
    [r1] = s1.run()
    np.testing.assert_array_equal(r1.result.logits, r.result.logits)
    assert eng.compiled_megastep_keys() == {key}
    assert all(e.compiled_shape_keys() == set()
               for e in eng.engines.values())


# Fused logits are 0.5 x event + 0.5 x frame logits: the event wing's are
# exact against JAX given equal spikes (test_torch_pipeline.py), the frame
# wing's within test_torch_tcn.py's LOGITS_ATOL where no fc1 activation
# flipped.
JAX_LOGITS_ATOL = 1e-5


def test_megastep_matches_the_jax_megastep_engine():
    """The same numpy weights and windows through the JAX package's
    megastep engine and the port's: labels equal, fused logits within
    ``JAX_LOGITS_ATOL`` (2 stateful sessions x 3 ticks, pipelined)."""
    from repro.core import EngineConfig as JConfig
    from repro.core import FrameTCNEngine as JFrame
    from repro.core import events as jev
    from repro.core import frames as jfr
    from repro.core.pipeline import BatchedClosedLoop as JLoop
    from repro.kernels import ops as jops
    from repro.serving import FusionSession as JSession
    from repro.serving import StreamEngine as JStream

    jcfg = jsnn.SNNConfig(height=32, width=32, time_bins=4,
                          conv1_features=4, conv2_features=8, hidden=32,
                          num_classes=11)
    jtcfg = jtcn.TCNConfig(height=32, width=32, conv1_features=4,
                           conv2_features=8, hidden=32, num_classes=11)
    np_snn = jax.tree_util.tree_map(
        np.asarray, jsnn.init_snn(jax.random.PRNGKey(0), jcfg))
    np_tcn = jax.tree_util.tree_map(
        np.asarray, jtcn.init_tcn(jax.random.PRNGKey(1), jtcfg))

    def run(eng, make_session, gen_ev, gen_fr):
        """Both packages' generators are the same numpy code: the same
        seeds give the same windows and frames."""
        sess = [make_session(eng, f"s{i}") for i in range(2)]
        data = []
        for i in range(2):
            rng_e = np.random.default_rng(10 + i)
            rng_f = np.random.default_rng(20 + i)
            data.append(([gen_ev(rng_e, (10 + i + k) % 11, mean_events=1200,
                                 height=32, width=32) for k in range(TICKS)],
                         [gen_fr(rng_f, (20 + i + k) % 11, height=32,
                                 width=32) for k in range(TICKS)]))
        for t in range(TICKS):
            for s, (evs, frs) in zip(sess, data):
                s.submit(evs[t], frs[t])
        out = {s.session_id: [] for s in sess}
        for _ in range(10 * TICKS):
            rows = eng.step()
            for s in sess:
                rows = s.absorb(rows)
                out[s.session_id] += s.drain()
        return {sid: sorted(r, key=lambda r: r.seq)
                for sid, r in out.items()}

    jeng = JStream(
        engines=[JLoop(jax.tree_util.tree_map(jnp.asarray, np_snn), jcfg,
                       lif_scan_fn=jops.lif_scan, fuse_fc=True),
                 JFrame(jax.tree_util.tree_map(jnp.asarray, np_tcn), jtcfg)],
        config=JConfig(max_streams=2, megastep=True, pipeline_depth=1))
    want = run(jeng, lambda e, sid: JSession(e, session_id=sid,
                                             stateful=True),
               jev.synthetic_gesture_events, jfr.synthetic_gesture_frames)
    teng = _hetero(snn_params_from_numpy(np_snn),
                   tcn_params_from_numpy(np_tcn), max_streams=2,
                   megastep=True, pipeline_depth=1)
    got = run(teng, lambda e, sid: FusionSession(e, session_id=sid,
                                                 stateful=True),
              ev.synthetic_gesture_events, fr.synthetic_gesture_frames)
    assert jeng.compiled_megastep_keys() == teng.compiled_megastep_keys()
    for sid in want:
        assert [r.seq for r in got[sid]] == [r.seq for r in want[sid]] \
            == list(range(TICKS))
        for a, b in zip(want[sid], got[sid]):
            assert a.status == "ok" and b.modality == "fusion"
            np.testing.assert_array_equal(a.result.label_pred,
                                          b.result.label_pred)
            np.testing.assert_allclose(b.result.logits, a.result.logits,
                                       rtol=0, atol=JAX_LOGITS_ATOL)
