"""The port's RWKV-6 model against the JAX package at SMOKE size.

The JAX package's ``Model.init`` makes the parameters; ``u``, ``mu``,
``mu_k`` and ``mu_r`` (zero at init, so the bonus term and the ddlerp
would never be exercised) are set from a numpy seed; the tree goes to
both packages as numpy arrays (``convert.lm_params_from_numpy`` for the
port). In f32 the port's forward and stepped decode hold the tolerance of
``tests/test_models.py``'s decode-vs-forward check, rtol = atol = 2e-4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.rwkv6_7b import CONFIG as JAX_CONFIG  # noqa: E402
from repro.configs.rwkv6_7b import SMOKE as JAX_SMOKE  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.rwkv6_7b import CONFIG, SMOKE  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)


def np_lm_params(jcfg, seed=0):
    """JAX-initialised RWKV-6 parameters as numpy arrays, with nonzero
    ``u``/``mu``/``mu_k``/``mu_r`` from a numpy seed."""
    init = jax.jit(jax_build_model(jcfg).init)
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tm, cm = p["layers"]["tm"], p["layers"]["cm"]
    tm["u"] = (rng.normal(size=tm["u"].shape) * 0.5).astype(np.float32)
    for tree, key in ((tm, "mu"), (cm, "mu_k"), (cm, "mu_r")):
        tree[key] = rng.uniform(0.0, 1.0, tree[key].shape).astype(np.float32)
    return p


def _tokens(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module")
def f32():
    p = np_lm_params(JAX_SMOKE)
    return p, jax.tree.map(jnp.asarray, p), lm_params_from_numpy(p)


def test_registry_names_the_jax_archs():
    assert get_config("rwkv6-7b", smoke=True) == SMOKE
    assert get_config("rwkv6-7b").num_layers == 32
    assert dataclasses.asdict(get_config("zamba2-1.2b")) \
        == dataclasses.asdict(jax_get_config("zamba2-1.2b"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


def test_full_width_defs_match_jax():
    """rwkv6-7b's parameter tree at full width, as meta tensors (no
    storage): the same leaves, shapes and count as the JAX package's."""
    meta = build_model(CONFIG).abstract_params()
    want = jax_build_model(JAX_CONFIG).abstract_params()
    got = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(got) == 29
    for path, spec in got.items():
        t = meta
        for key in path:
            t = t[key.key]
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == spec.shape, path
    assert build_model(CONFIG).num_params() == \
        jax_build_model(JAX_CONFIG).num_params() == 7_618_838_528


def test_apply_matches_jax(f32):
    _, jp, tp = f32
    toks = _tokens(2, 16, SMOKE.vocab_size, 1)
    want, _ = jax_build_model(JAX_SMOKE).apply(jp, {"tokens": toks})
    got, aux = build_model(SMOKE).apply(tp,
                                        {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_matches_jax_and_the_forward(f32):
    """Decode stepped over the prompt: each step's logits against JAX's,
    the caches' state/tm_x/cm_x after the prompt against JAX's, and the
    logits against the port's own full-sequence forward."""
    _, jp, tp = f32
    toks = _tokens(2, 12, SMOKE.vocab_size, 2)
    jm, tm = jax_build_model(JAX_SMOKE), build_model(SMOKE)
    jc = jm.init_cache(2, 12)
    tc = tm.init_cache(2, 12, device="cpu")
    dec = jax.jit(jm.decode)
    steps = []
    for i in range(toks.shape[1]):
        want, jc = dec(jp, jc, toks[:, i:i + 1])
        got, tc = tm.decode(tp, tc, torch.from_numpy(toks[:, i:i + 1]))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        steps.append(got[:, 0])
    for key in ("state", "tm_x", "cm_x"):
        assert tc[key].shape == jc[key].shape
        np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                   **TOL)
    assert int(tc["pos"]) == int(jc["pos"]) == 12
    full, _ = tm.apply(tp, {"tokens": torch.from_numpy(toks)})
    torch.testing.assert_close(torch.stack(steps, dim=1), full, **TOL)


@pytest.mark.parametrize("s", [20, 24])
def test_sequence_length_contract_matches_jax(f32, s):
    """Both packages refuse S that is not a multiple of min(16, S)."""
    _, jp, tp = f32
    toks = _tokens(1, s, SMOKE.vocab_size, 3)
    with pytest.raises(ValueError, match="not divisible"):
        jax_build_model(JAX_SMOKE).apply(jp, {"tokens": toks})
    with pytest.raises(ValueError, match="not divisible"):
        build_model(SMOKE).apply(tp, {"tokens": torch.from_numpy(toks)})


def test_remat_is_refused(f32):
    """``remat=True``, once refused, now recomputes each layer in the
    backward: the forward's logits are ``remat=False``'s bits."""
    batch = {"tokens": torch.from_numpy(_tokens(1, 16, SMOKE.vocab_size,
                                                5))}
    want, _ = build_model(SMOKE).apply(f32[2], batch)
    got, _ = build_model(SMOKE).apply(f32[2], batch, remat=True)
    assert torch.equal(got, want)


def test_bf16_params_convert_bit_for_bit(f32):
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(
        jnp.bfloat16)), f32[0])
    tp = lm_params_from_numpy(p)
    flat = jax.tree_util.tree_leaves_with_path(p)
    assert flat
    for path, a in flat:
        t = tp
        for key in path:
            t = t[key.key]
        assert t.dtype == torch.bfloat16 and tuple(t.shape) == a.shape
        assert np.array_equal(t.view(torch.int16).numpy(),
                              a.view(np.int16)), path


def test_bf16_model_within_jax_bf16_error(f32):
    """The bf16 SMOKE model. bf16 keeps 8 significant bits, and the two
    packages round at different places (XLA keeps excess precision inside
    a fusion, torch rounds after every op), so the two bf16 runs are held
    against their common reference: the f32 run of the same bf16-valued
    parameters, over 8 sequences. The port's RMS error against it may not
    exceed 1.25x the JAX bf16 run's own, and its largest error 2x JAX's
    largest (over 10 token seeds the ratios were 0.96-1.05 and
    0.82-1.42: bf16's largest errors are heavy-tailed in both packages).
    Greedy tokens agree wherever the top-2 gap exceeds both errors."""
    jcfg = dataclasses.replace(JAX_SMOKE, dtype="bfloat16")
    cfg = dataclasses.replace(SMOKE, dtype="bfloat16")
    p = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(
        jnp.bfloat16)), f32[0])
    toks = _tokens(8, 16, SMOKE.vocab_size, 5)
    want = np.asarray(jax_build_model(jcfg).apply(
        jax.tree.map(jnp.asarray, p), {"tokens": toks})[0])
    tp = lm_params_from_numpy(p)
    assert tp["embed"].dtype == torch.bfloat16
    got = build_model(cfg).apply(tp, {"tokens": torch.from_numpy(toks)})[0]
    assert got.dtype == torch.float32
    got = got.numpy()
    p32 = lm_params_from_numpy(jax.tree.map(
        lambda a: a.astype(np.float32), p))
    ref = build_model(SMOKE).apply(
        p32, {"tokens": torch.from_numpy(toks)})[0].numpy()
    err_jax, err_port = np.abs(want - ref), np.abs(got - ref)
    rms = lambda e: float(np.sqrt((e ** 2).mean()))
    assert rms(err_port) <= 1.25 * rms(err_jax)
    assert err_port.max() <= 2.0 * err_jax.max()
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = top2[..., 1] - top2[..., 0] > err_jax.max() + err_port.max()
    assert clear.any()
    assert np.array_equal(got.argmax(-1)[clear], want.argmax(-1)[clear])
