"""The port's frame wing against the JAX package.

  * ``normalize_frames`` and ``pad_frame_windows``: bitwise (one f32
    multiply and subtract per pixel; the padding is copied numpy code);
  * ``tcn_apply`` with the JAX package's packed parameters carried across
    by ``tcn_params_from_numpy``: the ternary activations of conv1, conv2
    and fc1 may flip only where a pre-activation lies within rounding of
    its threshold (the convs sum in another order than XLA's); at most
    ``MAX_FLIPPED`` of them, and logits within ``LOGITS_ATOL`` where no
    fc1 activation flipped (fc2 sums ternary x f32 products, exact each,
    in ascending k against XLA's order);
  * ``FrameTCNEngine`` rows at B in {1, 4, 8}: bitwise inside the port (a
    frame's result does not depend on its batch);
  * ``ClosedLoopResult`` and the Kraken energy against JAX's
    ``FrameTCNEngine``: labels and activities equal, PWM within
    ``PWM_ATOL``, energy and latency equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as jengine  # noqa: E402
from repro.core import frames as jfr  # noqa: E402
from repro.core import tcn as jtcn  # noqa: E402

from repro_torch.configs import TCN_SMOKE  # noqa: E402
from repro_torch.convert import tcn_params_from_numpy  # noqa: E402
from repro_torch.core import frames as tfr  # noqa: E402
from repro_torch.core import tcn as ttcn  # noqa: E402
from repro_torch.core.engine import FrameTCNEngine  # noqa: E402

JCFG = jtcn.TCNConfig(height=32, width=32, conv1_features=4,
                      conv2_features=8, hidden=32, num_classes=11)
MAX_FLIPPED = 1e-3
LOGITS_ATOL = 1e-5
PWM_ATOL = 1e-6


@pytest.fixture(scope="module")
def jparams():
    return jtcn.init_tcn(jax.random.PRNGKey(1), JCFG)


@pytest.fixture(scope="module")
def jpacked(jparams):
    return jtcn.pack_tcn(jparams)


@pytest.fixture(scope="module")
def packed(jpacked):
    return tcn_params_from_numpy(jax.tree_util.tree_map(np.array, jpacked))


def _frames(n, seed):
    rng = np.random.default_rng(seed)
    return [jfr.synthetic_gesture_frames(rng, i % 11, height=32, width=32)
            for i in range(n)]


def test_config_is_the_jax_smoke_config():
    from repro.configs.colibries import TCN_CONFIG as JFULL
    from repro.configs.colibries import TCN_SMOKE as JSMOKE
    from repro_torch.configs import TCN_CONFIG
    for mine, theirs in ((TCN_SMOKE, JSMOKE), (TCN_CONFIG, JFULL)):
        assert mine.flat_dim == theirs.flat_dim
        assert ttcn.tcn_layer_macs(mine) == jtcn.tcn_layer_macs(theirs)
        assert mine.spatial_sizes() == theirs.spatial_sizes()


def test_normalize_and_pad_match_jax():
    frs = _frames(3, seed=0)
    for slots in ([frs[0], None, frs[1], frs[2]], frs):
        jb = jfr.pad_frame_windows(slots)
        tb = tfr.pad_frame_windows(slots)
        np.testing.assert_array_equal(tb.pixels, jb.pixels)
        np.testing.assert_array_equal(tb.occupied, jb.occupied)
        np.testing.assert_array_equal(tb.num_pixels, jb.num_pixels)
        assert tb.duration_us == jb.duration_us
        np.testing.assert_array_equal(
            tfr.normalize_frames(torch.from_numpy(tb.pixels)).numpy(),
            np.asarray(jfr.normalize_frames(jnp.asarray(jb.pixels))))
    rng = np.random.default_rng(5)
    a = tfr.synthetic_gesture_frames(np.random.default_rng(5), 3)
    b = jfr.synthetic_gesture_frames(rng, 3)
    np.testing.assert_array_equal(a.pixels, b.pixels)


def test_params_from_numpy_layouts(jparams, jpacked, packed):
    """Float params repack in the port to JAX's packed bytes and ternary
    weights; packed params pass through with OIHW convs."""
    floats = tcn_params_from_numpy(jax.tree_util.tree_map(np.array,
                                                          jparams))
    assert tuple(floats["conv1"]["w"].shape) == (4, 1, 3, 3)
    mine = ttcn.pack_tcn(floats)
    for name in ("conv1", "conv2"):
        assert torch.equal(mine[name]["q"], packed[name]["q"])
        assert tuple(packed[name]["scale"].shape) == (
            packed[name]["q"].shape[0], 1, 1, 1)
        np.testing.assert_allclose(mine[name]["scale"].numpy(),
                                   packed[name]["scale"].numpy(), rtol=1e-6)
    np.testing.assert_array_equal(packed["fc1"]["packed"].numpy(),
                                  np.asarray(jpacked["fc1"]["packed"]))
    assert torch.equal(mine["fc1"]["packed"], packed["fc1"]["packed"])


def _jax_activations(jpacked, x):
    thr = JCFG.act_threshold
    s1 = jtcn._ternarize_act(jtcn._ternary_conv(
        jtcn._avg_pool(x, JCFG.pool0), jpacked["conv1"]), thr)
    s2 = jtcn._ternarize_act(jtcn._ternary_conv(
        jtcn._avg_pool(s1, 2), jpacked["conv2"]), thr)
    flat = jtcn._avg_pool(s2, 2).reshape(x.shape[0], -1)
    h = jtcn.ternary_matmul_pallas(flat, jpacked["fc1"]["packed"],
                                   jpacked["fc1"]["scale"], interpret=True)
    return {"conv1": s1, "conv2": s2,
            "fc1": jtcn._ternarize_act(h, thr)}


def test_tcn_apply_matches_jax(jpacked, packed):
    batch = jfr.pad_frame_windows(_frames(8, seed=9))
    jx = jfr.normalize_frames(jnp.asarray(batch.pixels))
    want = jtcn.tcn_apply(jpacked, jx, JCFG)
    got = ttcn.tcn_apply(packed, tfr.normalize_frames(
        torch.from_numpy(batch.pixels)), TCN_SMOKE)
    acts = _jax_activations(jpacked, jx)
    flipped = sum(int((got["activations"][k].numpy()
                       != np.asarray(acts[k])).sum()) for k in acts)
    total = sum(int(np.asarray(a).size) for a in acts.values())
    assert flipped / total <= MAX_FLIPPED, (flipped, total)
    same_rows = (got["activations"]["fc1"].numpy()
                 == np.asarray(acts["fc1"])).all(axis=1)
    assert same_rows.any()
    np.testing.assert_allclose(got["logits"].numpy()[same_rows],
                               np.asarray(want["logits"])[same_rows],
                               rtol=0, atol=LOGITS_ATOL)
    for k, dens in want["activity_per_stream"].items():
        np.testing.assert_array_equal(
            got["activity_per_stream"][k].numpy()[same_rows],
            np.asarray(dens)[same_rows])


@pytest.fixture(scope="module")
def engine(packed):
    return FrameTCNEngine(packed, TCN_SMOKE, prepacked=True, device="cpu")


def test_frame_engine_rows_do_not_depend_on_the_batch(engine):
    frs = _frames(8, seed=21)
    full = engine.infer_frames(frs)
    for b in (1, 4):
        for start in range(0, 8, b):
            part = engine.infer_frames(frs[start:start + b])
            for i, r in enumerate(part):
                ref = full[start + i]
                np.testing.assert_array_equal(r.logits, ref.logits)
                np.testing.assert_array_equal(r.pwm, ref.pwm)
                assert r.energy_mj == ref.energy_mj
    # Empty slots change nothing either.
    sparse = engine.infer_frames([frs[0], None, frs[1], None])
    assert sparse[1] is None and sparse[3] is None
    np.testing.assert_array_equal(sparse[2].logits, full[1].logits)


def test_frame_engine_results_match_jax(jpacked, engine):
    frs = _frames(6, seed=31)
    jeng = jengine.FrameTCNEngine(jpacked, JCFG, prepacked=True)
    want = jeng.infer_frames(frs)
    got = engine.infer_frames(frs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.label_pred, b.label_pred)
        np.testing.assert_allclose(a.pwm, b.pwm, rtol=0, atol=PWM_ATOL)
        np.testing.assert_allclose(a.logits, b.logits, rtol=0,
                                   atol=LOGITS_ATOL)
        assert a.energy_mj == b.energy_mj
        assert a.latency_ms == b.latency_ms
        assert a.realtime == b.realtime
        assert a.sustained_rate_hz == b.sustained_rate_hz
        assert a.breakdown["cutie_activity"] == b.breakdown["cutie_activity"]
        assert set(a.breakdown["stages"]) == set(b.breakdown["stages"])


def test_frame_engine_protocol(engine, packed):
    f = _frames(1, seed=40)[0]
    eng = FrameTCNEngine(packed, TCN_SMOKE, prepacked=True, device="cpu")
    assert eng.modality == "frame" and eng.duration_us is None
    with pytest.raises(ValueError, match="latch duration_us first"):
        eng.warmup([(2, 32, 32)])
    eng.validate(f)
    assert eng.duration_us == f.duration_us
    with pytest.raises(ValueError, match="period"):
        eng.validate(tfr.FrameWindow(pixels=f.pixels,
                                     duration_us=f.duration_us // 2))
    with pytest.raises(ValueError, match="geometry"):
        eng.validate(tfr.FrameWindow(pixels=f.pixels[:16, :16],
                                     duration_us=f.duration_us))
    eng.warmup([(2, 32, 32)])
    assert eng.compiled_shape_keys() == {(2, 32, 32, f.duration_us)}
    with pytest.raises(ValueError, match="geometry"):
        eng.warmup([(2, 16, 16)])
    state = eng.init_state(2)
    assert state == {} and eng.export_state(state, 0) == {}
    assert eng.import_state(state, 0, {}) == {}
    batch = eng.prepare([f, None], batch_size=2)
    res, carry = eng.infer(batch, state)
    assert carry == {} and res[1] is None
    assert res[0].breakdown["stages"]["tcn_inference"]["domain"] == "cutie"
    # A mesh shards the slots: a logical mesh of two CPU shards classifies
    # each half of the batch on its own and gives the same rows.
    from repro_torch.distributed import make_mesh
    sharded = FrameTCNEngine(packed, TCN_SMOKE, prepacked=True,
                             mesh=make_mesh(2, devices=[
                                 torch.device("cpu")] * 2))
    sharded.validate(f)
    assert sharded.devices == (torch.device("cpu"),) * 2
    rows = sharded.infer(sharded.prepare([f, None], batch_size=2))
    assert rows[1] is None
    np.testing.assert_array_equal(rows[0].logits, res[0].logits)
    with pytest.raises(TypeError, match="Mesh"):
        FrameTCNEngine(packed, TCN_SMOKE, prepacked=True, device="cpu",
                       mesh=object())
