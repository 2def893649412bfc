"""The port's StreamEngine: scheduling, pipelining and carried state.

Six streams over four slots, some stateful, served synchronously and
pipelined. The two modes must emit the same results in the same order,
bit for bit; a stateful stream must equal one uninterrupted scan over its
whole event sequence; a stateless one must equal a fresh B=1 run; and
``reset_state``/``close`` behave as in the JAX package's engine.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.core import snn as jsnn  # noqa: E402

from repro_torch.convert import snn_params_from_numpy  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import snn as tsnn  # noqa: E402
from repro_torch.core._api import EngineConfig, RecoveryConfig  # noqa: E402
from repro_torch.core.pipeline import (ClosedLoopPipeline,  # noqa: E402
                                       pwm_from_logits)
from repro_torch.serving import FairQuantumPolicy, StreamEngine  # noqa: E402

CFG = tsnn.SNNConfig(height=32, width=32, time_bins=4, conv1_features=4,
                     conv2_features=8, hidden=32, num_classes=11)


@pytest.fixture(scope="module")
def params():
    jcfg = jsnn.SNNConfig(height=32, width=32, time_bins=4,
                          conv1_features=4, conv2_features=8, hidden=32,
                          num_classes=11)
    tree = jax.tree_util.tree_map(
        np.asarray, jsnn.init_snn(jax.random.PRNGKey(0), jcfg))
    return snn_params_from_numpy(tree)


def _windows(n, seed, mean_events=1500):
    rng = np.random.default_rng(seed)
    return [ev.synthetic_gesture_events(rng, (seed + i) % 11,
                                        mean_events=mean_events, height=32,
                                        width=32)
            for i in range(n)]


def _engine(params, depth, slots=4, **kw):
    return StreamEngine(params, CFG, EngineConfig(
        max_streams=slots, fuse_fc=True, pipeline_depth=depth, **kw),
        device="cpu")


def _oracle(params, windows):
    """(label_pred, pwm) per window, sliced from ONE uninterrupted scan
    over the stream's concatenated events."""
    d = windows[0].duration_us
    cat = lambda f: torch.from_numpy(np.concatenate(
        [getattr(w, f) + (k * d if f == "t" else 0)
         for k, w in enumerate(windows)]).astype(np.int32))
    vox = ev.voxelize(cat("x"), cat("y"), cat("t"), cat("p"),
                      duration_us=d * len(windows),
                      time_bins=CFG.time_bins * len(windows),
                      height=CFG.height, width=CFG.width)
    out = tsnn.snn_apply(params, vox[None], CFG, mode="layer_serial")
    t = CFG.time_bins
    res = []
    for k in range(len(windows)):
        s = out["out_spikes"][:, k * t:(k + 1) * t].float()
        logits = s.sum(1) / float(t) * 10.0
        res.append((torch.argmax(logits, -1).numpy(),
                    pwm_from_logits(logits).numpy()))
    return res


def _serve(params, depth, streams):
    eng = _engine(params, depth)
    handles = {sid: eng.open(stream_id=sid, stateful=stateful)
               for sid, (stateful, _) in streams.items()}
    for k in range(3):
        for sid, (_, ws) in streams.items():
            assert handles[sid].submit(ws[k]) == k
    out = eng.run()
    assert eng.pending() == 0 and eng.in_flight == 0
    return eng, out


@pytest.fixture(scope="module")
def streams():
    return {f"cam{i}": (i % 2 == 0, _windows(3, seed=10 + i))
            for i in range(6)}


@pytest.fixture(scope="module")
def served(params, streams):
    return {d: _serve(params, d, streams) for d in (0, 1)}


def test_sync_and_pipelined_emit_same_results_in_order(served):
    (_, sync), (_, piped) = served[0], served[1]
    assert len(sync) == len(piped) == 18
    for a, b in zip(sync, piped):
        assert (a.stream_id, a.seq) == (b.stream_id, b.seq)
        np.testing.assert_array_equal(a.result.label_pred,
                                      b.result.label_pred)
        np.testing.assert_array_equal(a.result.pwm, b.result.pwm)
        np.testing.assert_array_equal(a.result.logits, b.result.logits)
        assert a.result.energy_mj == b.result.energy_mj


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "pipelined"])
def test_stateful_streams_equal_uninterrupted_scan(params, streams, served,
                                                   depth):
    _, out = served[depth]
    for sid, (stateful, ws) in streams.items():
        mine = sorted((r for r in out if r.stream_id == sid),
                      key=lambda r: r.seq)
        assert [r.seq for r in mine] == [0, 1, 2]
        if stateful:
            for r, (pred, pwm) in zip(mine, _oracle(params, ws)):
                np.testing.assert_array_equal(r.result.label_pred, pred)
                np.testing.assert_array_equal(r.result.pwm, pwm)


@pytest.mark.parametrize("depth", [0, 1], ids=["sync", "pipelined"])
def test_state_follows_stream_through_rotation(params, depth):
    """Quantum 1 over 2 slots and 3 stateful streams: every step rotates a
    stream out (its carry is parked) and back into another slot (the carry
    is gathered along). Each stream still equals its uninterrupted scan."""
    streams = {f"s{i}": _windows(3, seed=80 + i) for i in range(3)}
    eng = _engine(params, depth, slots=2, policy=FairQuantumPolicy(1))
    hs = {sid: eng.open(stream_id=sid, stateful=True) for sid in streams}
    for k in range(3):
        for sid, ws in streams.items():
            hs[sid].submit(ws[k])
    out = eng.run()
    assert len(out) == 9
    for sid, ws in streams.items():
        mine = sorted((r for r in out if r.stream_id == sid),
                      key=lambda r: r.seq)
        for r, (pred, pwm) in zip(mine, _oracle(params, ws)):
            np.testing.assert_array_equal(r.result.label_pred, pred)
            np.testing.assert_array_equal(r.result.pwm, pwm)


def test_stateless_streams_equal_fresh_b1_runs(params, streams, served):
    _, out = served[0]
    pipe = ClosedLoopPipeline(params, CFG, device="cpu")
    for r in out:
        stateful, ws = streams[r.stream_id]
        if stateful:
            continue
        ref = pipe(ws[r.seq])
        np.testing.assert_array_equal(r.result.pwm, ref.pwm)
        assert r.result.energy_mj == ref.energy_mj


def test_stats_and_occupancy(served):
    eng, out = served[0]
    assert eng.stats["windows"] == 18
    assert eng.mean_occupancy > 1.0
    for h in eng.handles.values():
        assert h.stats.windows == 3 and h.queued == 0


def test_dirty_slot_is_zeroed_and_reset_state(params):
    hot = _windows(2, seed=40, mean_events=2500)
    eng = _engine(params, 0, slots=1)
    h = eng.open(stateful=True)
    for w in hot:
        h.submit(w)
    eng.run()
    pipe = ClosedLoopPipeline(params, CFG, device="cpu")
    w_a, w_b = _windows(2, seed=41)
    newcomer = eng.open(stateful=True)                 # same, dirty slot
    newcomer.submit(w_a)
    r = eng.run()[0]
    np.testing.assert_array_equal(r.result.pwm, pipe(w_a).pwm)
    newcomer.reset_state()                            # gesture boundary
    newcomer.submit(w_b)
    r = eng.run()[0]
    np.testing.assert_array_equal(r.result.pwm, pipe(w_b).pwm)
    plain = eng.open()
    with pytest.raises(ValueError, match="not stateful"):
        plain.reset_state()


def test_close_discards_and_frees(params):
    ws = _windows(2, seed=60)
    eng = _engine(params, 0, slots=2)
    h = eng.open(stream_id="x", stateful=True)
    h.submit(ws[0])
    eng.run()
    assert h.close() == 0 and h.close() == 0
    with pytest.raises(ValueError, match="closed"):
        h.submit(ws[1])
    again = eng.open(stream_id="x", stateful=True)    # a brand-new stream
    assert again.submit(ws[0]) == 0
    assert eng.run()[0].seq == 0
    y = eng.open(stream_id="y")
    y.submit(ws[0])
    y.submit(ws[1])
    assert y.close() == 2 and eng.pending() == 0
    # Closing with a window in flight discards it; nothing is emitted.
    eng2 = _engine(params, 1, slots=1)
    z = eng2.open(stateful=True)
    z.submit(ws[0])
    eng2.step()
    assert eng2.in_flight == 1
    assert z.close() == 1
    assert eng2.flush() == []


def test_fairness_rotation_serves_everyone(params):
    eng = _engine(params, 0, slots=1, policy=FairQuantumPolicy(2))
    a, b = eng.open(), eng.open()
    wins = _windows(4, seed=70)
    for w in wins:
        a.submit(w)
    b.submit(wins[0])
    order = [r.stream_id for r in eng.run()]
    assert order.index(b.stream_id) == 2              # after a's quantum


def test_fuse_fc_values_serve_the_same_bits(params, streams, served):
    """EngineConfig.fuse_fc names two executions of one function in the
    JAX package; the port runs fc1/fc2 through K2 for either value."""
    _, fused = served[0]
    eng = StreamEngine(params, CFG, EngineConfig(max_streams=4,
                                                 fuse_fc=False),
                       device="cpu")
    hs = {sid: eng.open(stream_id=sid, stateful=stateful)
          for sid, (stateful, _) in streams.items()}
    for k in range(3):
        for sid, (_, ws) in streams.items():
            hs[sid].submit(ws[k])
    for a, b in zip(fused, eng.run()):
        assert (a.stream_id, a.seq) == (b.stream_id, b.seq)
        np.testing.assert_array_equal(a.result.logits, b.result.logits)
        np.testing.assert_array_equal(a.result.pwm, b.result.pwm)


def test_unported_config_fields_raise(params):
    """No field is refused any more: ``mesh`` shards the slots (a logical
    mesh of CPU shards here; anything but a ``Mesh`` raises TypeError),
    ``recovery`` and ``DeadlinePolicy`` build an engine, and a bad policy
    is refused as the JAX package refuses it."""
    from repro.core._api import EngineConfig as JConfig
    from repro.serving import DeadlinePolicy as JDeadline

    from repro_torch.distributed import ShardedTensor, make_mesh
    from repro_torch.serving import DeadlinePolicy

    mesh = make_mesh(2, devices=[torch.device("cpu")] * 2)
    sharded = StreamEngine(params, CFG, EngineConfig(max_streams=4,
                                                     mesh=mesh))
    assert sharded.mesh is mesh and sharded.loop.device.type == "cpu"
    assert all(isinstance(a, ShardedTensor)
               for a in sharded.loop.init_state(4).values())
    with pytest.raises(TypeError, match="Mesh"):
        StreamEngine(params, CFG, EngineConfig(mesh=object()), device="cpu")
    eng = StreamEngine(params, CFG, EngineConfig(
        recovery=RecoveryConfig(max_retries=1), policy=DeadlinePolicy()),
        device="cpu")
    assert eng.recovery.max_retries == 1 and eng.fault_log == []
    assert isinstance(eng.policy, DeadlinePolicy)
    for config in (EngineConfig, JConfig):
        with pytest.raises(ValueError, match="fair_quantum"):
            config(policy=DeadlinePolicy(), fair_quantum=2)
    for policy in (DeadlinePolicy, JDeadline):
        with pytest.raises(ValueError, match="aging"):
            policy(aging=-1.0)
        with pytest.raises(ValueError, match="max_wait"):
            policy(max_wait=0)
    with pytest.raises(TypeError, match="RecoveryConfig"):
        EngineConfig(recovery=object())
    with pytest.raises(ValueError, match="duration"):
        eng = _engine(params, 0)
        h = eng.open()
        h.submit(_windows(1, seed=1)[0])
        w = _windows(1, seed=2)[0]
        w.duration_us = 100_000
        h.submit(w)


def test_max_streams_mapping_names_known_modalities(params):
    """A per-modality ``max_streams`` mapping sizes each lane; a key that
    names no engine's modality is refused, as in the JAX package."""
    eng = StreamEngine(params, CFG, EngineConfig(max_streams={"event": 3}),
                       device="cpu")
    assert len(eng._lanes["event"].slots) == 3
    with pytest.raises(ValueError, match="match no engine modality"):
        StreamEngine(params, CFG, EngineConfig(
            max_streams={"event": 2, "frame": 2}), device="cpu")


def test_warmed_keys_are_the_served_keys(params):
    """``StreamEngine.warmup`` forwards to the engine's cache, whose keys
    are the ones the lane serves: a warmed key served again adds no key
    (on the card, no capture)."""
    eng = _engine(params, 1)
    key = (4, 2048, 300_000)
    eng.warmup([key])
    assert eng.loop.compiled_shape_keys() == {key}
    hs = [eng.open(stateful=i == 0) for i in range(2)]
    for k, w in enumerate(_windows(4, seed=30)):
        hs[k % 2].submit(w)
    assert len(eng.run()) == 4
    assert eng.compiled_shapes() == eng.loop.compiled_shape_keys() == {key}
