"""The port's transformer families (dense, MoE, VLM) against the JAX
package at SMOKE size: configs, every layer of ``models/layers.py`` and
the backbone of ``models/transformer.py``.

Inputs come from numpy seeds; the parameters from the JAX package's
``Model.init``, carried across as numpy arrays
(``convert.lm_params_from_numpy``). Tolerances, all f32:

  * ``LAYER_TOL`` (1e-5): one layer's output of O(1) values, the same
    formula with ulp-level differences (f32 ``cos``/``sin``/``exp`` and
    sum orders differ between XLA CPU and torch CPU);
  * ``LOGIT_TOL`` (2e-4): the whole model's f32 logits, as
    ``tests/test_torch_rwkv6.py`` holds them;
  * exact: integer positions, top-k choices, capacity slots and drops.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes as jax_shapes  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config, shapes  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402

LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
LOGIT_TOL = 2e-4
TRANSFORMER_ARCHS = ["h2o-danube-1.8b", "glm4-9b", "nemotron-4-340b",
                     "llama3.2-1b", "llama4-scout-17b-a16e",
                     "deepseek-moe-16b", "qwen2-vl-2b"]


def np_init(jcfg, seed=0):
    """The JAX package's ``Model.init`` of ``jcfg`` as numpy arrays. The
    key is an "rbg" key: threefry's per-leaf programs take ~10 s to
    compile on one core at SMOKE size, rbg's ~2 s."""
    init = jax.jit(jax_build_model(jcfg).init)
    return jax.tree.map(np.asarray, init(jax.random.key(seed, impl="rbg")))


@functools.lru_cache(maxsize=None)
def np_params(arch, seed=0):
    """The JAX package's SMOKE parameters of ``arch`` as numpy arrays."""
    return np_init(jax_get_config(arch, smoke=True), seed)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.ascontiguousarray(a))


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **(tol or LAYER_TOL))


# ----------------------------------------------------------------------
# Configs, names, parameter trees
# ----------------------------------------------------------------------


def test_registry_returns_the_transformer_configs():
    for arch in TRANSFORMER_ARCHS:
        for smoke in (False, True):
            got, want = get_config(arch, smoke), jax_get_config(arch, smoke)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for arch in ("zamba2-1.2b", "seamless-m4t-medium"):
        for smoke in (False, True):
            got, want = get_config(arch, smoke), jax_get_config(arch, smoke)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert set(TRANSFORMER_ARCHS) < set(ARCHS)


def test_shapes_match_jax():
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}
    for arch in ARCHS:
        got = shapes.cells_for(get_config(arch))
        want = jax_shapes.cells_for(jax_get_config(arch))
        assert [c.name for c in got] == [c.name for c in want]


def test_public_names_exist_in_the_port():
    assert set(JL.__all__) <= set(L.__all__)
    assert all(hasattr(L, n) for n in L.__all__)
    assert set(JT.__all__) == set(T.__all__)
    assert all(hasattr(T, n) for n in T.__all__)
    assert hasattr(L, "blockwise_attention")


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-moe-16b",
                                  "qwen2-vl-2b"])
def test_full_width_defs_match_jax(arch):
    """The full-width parameter tree as meta tensors (no storage): the
    JAX package's leaves, shapes and count."""
    meta = build_model(get_config(arch)).abstract_params()
    want = jax_build_model(jax_get_config(arch)).abstract_params()
    leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, spec in leaves.items():
        t = meta
        for key in path:
            t = t[key.key]
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == spec.shape, path
    n = build_model(get_config(arch)).num_params()
    assert n == jax_build_model(jax_get_config(arch)).num_params()
    if arch == "llama3.2-1b":
        assert n == 1_235_814_400 == get_config(arch).param_count()


# ----------------------------------------------------------------------
# Norms and rotary embeddings
# ----------------------------------------------------------------------


def test_rms_norm_matches_jax():
    x, s = _normal(0, 2, 5, 64, scale=3.0), _normal(1, 64)
    (jx, tx), (js, ts) = _both(x), _both(s)
    _close(L.rms_norm(tx, ts, 1e-5), JL.rms_norm(jx, js, 1e-5))
    # bf16: f32 statistics, one cast, then the scale in bf16.
    got = L.rms_norm(tx.bfloat16(), ts.bfloat16(), 1e-5)
    want = JL.rms_norm(jx.astype(jnp.bfloat16), js.astype(jnp.bfloat16),
                       1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def test_rope_freqs_and_1d_rope_match_jax():
    _close(L.rope_freqs(64, 500_000.0, "cpu"), JL.rope_freqs(64, 500_000.0),
           rtol=1e-6, atol=0)
    x = _normal(2, 2, 7, 4, 16)
    pos = np.random.default_rng(3).integers(0, 3000, (2, 7)).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    # Angles up to 3000 rad: f32 sin/cos of large arguments differ by a
    # few ulps of the angle between libraries.
    _close(L.apply_rope(tx, tp, 10_000.0), JL.apply_rope(jx, jp, 10_000.0),
           rtol=1e-4, atol=1e-4)


def test_mrope_positions_and_rotation_match_jax():
    got = L.mrope_positions(2, 11, 4, (2, 2), device="cpu")
    want = JL.mrope_positions(2, 11, 4, (2, 2))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = _normal(4, 2, 11, 4, 16)
    jx, tx = _both(x)
    _close(L.apply_rope(tx, got, 1e6, (4, 2, 2)),
           JL.apply_rope(jx, want, 1e6, (4, 2, 2)))
    with pytest.raises(ValueError, match="sections"):
        L.apply_rope(tx, got, 1e6, (4, 2, 3))


# ----------------------------------------------------------------------
# Attention
# ----------------------------------------------------------------------


@pytest.mark.parametrize("causal,window,kv_chunk", [
    (True, None, 4),      # causal, 3 chunks, the last one short (Sk=11)
    (True, 3, 4),         # sliding window across chunk edges
    (True, None, 2048),   # one chunk
    (False, None, 11),    # non-causal, Sk a whole chunk
])
def test_blockwise_attention_matches_jax(causal, window, kv_chunk):
    """GQA (8 heads over 2 kv heads) at Sq = Sk = 11."""
    q, k, v = (_normal(10 + i, 2, 11, h, 16) for i, h in enumerate((8, 2, 2)))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    got = L.blockwise_attention(tq, tk, tv, causal=causal, window=window,
                                kv_chunk=kv_chunk)
    want = JL.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                  kv_chunk=kv_chunk)
    _close(got, want)


def test_blockwise_attention_never_counts_padded_keys():
    """Non-causal with Sk not a multiple of ``kv_chunk``: the port's
    result does not depend on the chunking and equals the JAX package's
    unpadded call. The JAX package pads the last chunk with zero keys and
    counts them in the softmax's denominator when nothing else masks them
    (its result then moves with ``kv_chunk``)."""
    q, k, v = _normal(20, 1, 5, 4, 8), _normal(21, 1, 7, 2, 8), \
        _normal(22, 1, 7, 2, 8)
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    unpadded = JL.blockwise_attention(jq, jk, jv, causal=False, kv_chunk=7)
    for chunk in (3, 4, 7):
        _close(L.blockwise_attention(tq, tk, tv, causal=False,
                                     kv_chunk=chunk), unpadded)
    padded = JL.blockwise_attention(jq, jk, jv, causal=False, kv_chunk=4)
    assert float(jnp.abs(padded - unpadded).max()) > 1e-2


def _attn_params(cfg, seed):
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    shapes_ = dict(wq=(d, h, hd), wk=(d, kvh, hd), wv=(d, kvh, hd),
                   wo=(h, hd, d))
    return {k: _normal(seed + i, *s, scale=0.2)
            for i, (k, s) in enumerate(shapes_.items())}


@pytest.mark.parametrize("arch,mrope", [("llama3.2-1b", False),
                                        ("qwen2-vl-2b", True)])
def test_attention_apply_matches_jax(arch, mrope):
    cfg, jcfg = get_config(arch, True), jax_get_config(arch, True)
    p = _attn_params(cfg, 30)
    x = _normal(35, 2, 9, cfg.d_model)
    jx, tx = _both(x)
    if mrope:
        tpos = L.mrope_positions(2, 9, 4, (2, 2), device="cpu")
        jpos = JL.mrope_positions(2, 9, 4, (2, 2))
    else:
        jpos, tpos = _both(np.tile(np.arange(9, dtype=np.int32), (2, 1)))
    got = L.attention_apply(lm_params_from_numpy(p), tx, tpos, cfg,
                            mrope=mrope)
    want = JL.attention_apply(jax.tree.map(jnp.asarray, p), jx, jpos, jcfg,
                              mrope=mrope)
    _close(got, want)


@pytest.mark.parametrize("window", [None, 4])
def test_attention_decode_matches_jax_across_a_ring_wrap(window):
    """Ten steps into a 4-slot cache: with a window the ring wraps twice;
    without one the slot clamps to the last. The cache passed in is not
    modified."""
    cfg, jcfg = get_config("glm4-9b", True), jax_get_config("glm4-9b", True)
    p = _attn_params(cfg, 40)
    tp, jp = lm_params_from_numpy(p), jax.tree.map(jnp.asarray, p)
    shape = (2, 4, cfg.num_kv_heads, cfg.head_dim)
    tc = {"k": torch.zeros(shape), "v": torch.zeros(shape),
          "pos": torch.zeros((), dtype=torch.int32)}
    jc = {"k": jnp.zeros(shape), "v": jnp.zeros(shape),
          "pos": jnp.zeros((), jnp.int32)}
    for step in range(10):
        jx, tx = _both(_normal(50 + step, 2, 1, cfg.d_model))
        before = tc["k"].clone()
        got, tc_new = L.attention_decode(tp, tx, tc, cfg, window=window)
        want, jc = JL.attention_decode(jp, jx, jc, jcfg, window=window)
        assert torch.equal(tc["k"], before)
        tc = tc_new
        _close(got, want)
        for key in ("k", "v"):
            _close(tc[key], jc[key])
        assert int(tc["pos"]) == int(jc["pos"]) == step + 1


# ----------------------------------------------------------------------
# MLPs and MoE
# ----------------------------------------------------------------------


@pytest.mark.parametrize("activation", ["swiglu", "squared_relu", "gelu"])
def test_mlp_apply_matches_jax(activation):
    """Each activation; jax.nn.gelu's tanh form (erf differs by ~1e-3)."""
    kw = dict(name="mlp", family="dense", num_layers=1, d_model=32,
              vocab_size=16, d_ff=48, num_heads=2, activation=activation,
              dtype="float32")
    cfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    p = {"w_up": _normal(60, 32, 48, scale=0.5),
         "w_down": _normal(61, 48, 32, scale=0.3)}
    if activation == "swiglu":
        p["w_gate"] = _normal(62, 32, 48, scale=0.5)
    jx, tx = _both(_normal(63, 2, 5, 32))
    _close(L.mlp_apply(lm_params_from_numpy(p), tx, cfg),
           JL.mlp_apply(jax.tree.map(jnp.asarray, p), jx, jcfg))


_MOE = dict(name="moe", family="moe", num_layers=1, d_model=32,
            vocab_size=16, d_ff=32, num_heads=2, num_experts=8, top_k=2,
            num_shared_experts=1, expert_d_ff=24, moe_group_size=8,
            dtype="float32")


def _moe_params(seed, e=8):
    d, f = 32, 24
    return {"router": _normal(seed, d, e),
            "we_gate": _normal(seed + 1, e, d, f, scale=0.3),
            "we_up": _normal(seed + 2, e, d, f, scale=0.3),
            "we_down": _normal(seed + 3, e, f, d, scale=0.3),
            "shared": {"w_gate": _normal(seed + 4, d, f, scale=0.3),
                       "w_up": _normal(seed + 5, d, f, scale=0.3),
                       "w_down": _normal(seed + 6, f, d, scale=0.3)}}


def _jax_route(p, x, cfg):
    """The JAX package's routing (``layers.py:431-453``) for one group
    layout: chosen experts, slots and the kept mask."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    g = min(cfg.moe_group_size, b * s)
    cap = min(int(np.ceil(g * k * cfg.capacity_factor / e)), g)
    xg = x.reshape(-1, g, d)
    probs = jax.nn.softmax(jnp.einsum("ngd,de->nge", xg, p["router"]), -1)
    _, idx = jax.lax.top_k(probs, k)
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.float32)
    flat = onehot.reshape(xg.shape[0], g * k, e)
    pos = ((jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
           * onehot).sum(-1)
    return np.asarray(idx), np.asarray(pos), np.asarray(pos < cap), cap


@pytest.mark.parametrize("batch,seq,experts", [(2, 8, 8), (4, 1, 8),
                                               (4, 1, 64)])
def test_moe_apply_matches_jax_with_drops(batch, seq, experts):
    """Outputs, aux, and the routing: the same experts, slots and dropped
    (token, choice) pairs. (2, 8) is two groups of 8 tokens at cap 3;
    (4, 1) a decode step, one group of 4 at cap 2; with 64 experts and
    top 6 it is deepseek-moe-16b's decode routing at B=4 (cap 1: of two
    tokens sharing an expert, the later one drops). A few tokens repeat
    the first one, so their experts overflow."""
    kw = dict(_MOE, num_experts=experts,
              top_k=6 if experts == 64 else 2)
    cfg, jcfg = ModelConfig(**kw), JaxModelConfig(**kw)
    p = _moe_params(70, experts)
    x = _normal(80, batch * seq, 32)
    x[-3:] = x[0]
    jx, tx = _both(x.reshape(batch, seq, 32))
    tp, jp = lm_params_from_numpy(p), jax.tree.map(jnp.asarray, p)
    out, aux = L.moe_apply(tp, tx, cfg)
    want, jaux = JL.moe_apply(jp, jx, jcfg)
    _close(out, want)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    idx, pos, keep, cap = _jax_route(jp, jx, jcfg)
    assert cap == (1 if experts == 64 else 3 if seq == 8 else 2)
    r = L.moe_route(tp["router"], tx.reshape(-1, min(8, batch * seq), 32),
                    cfg, cap)
    np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["pos"].numpy(), pos)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    assert not keep.all(), "the case must drop tokens"


def test_moe_ties_go_to_the_lower_experts():
    """A router of zeros: every probability is equal, and jax.lax.top_k
    picks experts 0..k-1 for every token, so slots fill in token order and
    the tokens past the capacity drop; the port picks the same."""
    cfg, jcfg = ModelConfig(**_MOE), JaxModelConfig(**_MOE)
    p = _moe_params(90)
    p["router"] = np.zeros_like(p["router"])
    jx, tx = _both(_normal(91, 1, 8, 32))
    tp, jp = lm_params_from_numpy(p), jax.tree.map(jnp.asarray, p)
    idx, pos, keep, cap = _jax_route(jp, jx, jcfg)
    r = L.moe_route(tp["router"], tx.reshape(1, 8, 32), cfg, cap)
    assert (idx == np.array([0, 1])).all()
    np.testing.assert_array_equal(r["gate_idx"].numpy(), idx)
    np.testing.assert_array_equal(r["keep"].numpy(), keep)
    _close(L.moe_apply(tp, tx, cfg)[0], JL.moe_apply(jp, jx, jcfg)[0])


# ----------------------------------------------------------------------
# The backbone, on every transformer SMOKE config
# ----------------------------------------------------------------------


def _batch(cfg, b, s, seed):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s))
    out = {"tokens": toks.astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = _normal(seed + 1, b, 4, cfg.d_model)
    return out


@pytest.mark.parametrize("arch", TRANSFORMER_ARCHS)
def test_transformer_matches_jax(arch):
    """Model.apply logits and aux, then Model.decode stepped over the
    same 12 tokens (h2o-danube's window of 8 wraps its ring), logits and
    caches at every step."""
    cfg, jcfg = get_config(arch, True), jax_get_config(arch, True)
    p = np_params(arch)
    tp, jp = lm_params_from_numpy(p), jax.tree.map(jnp.asarray, p)
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    nb = _batch(cfg, 2, 12, 100)
    logits, aux = model.apply(tp, {k: torch.from_numpy(v)
                                   for k, v in nb.items()})
    jlogits, jaux = jax.jit(jmodel.apply)(
        jp, {k: jnp.asarray(v) for k, v in nb.items()})
    assert logits.dtype == torch.float32 and logits.shape == (
        2, 12, cfg.vocab_size)
    _close(logits, jlogits, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5,
                               atol=1e-6)

    cache = model.init_cache(2, 12, device="cpu")
    jcache = jmodel.init_cache(2, 12)
    assert cache["k"].shape == jcache["k"].shape
    decode = jax.jit(jmodel.decode)
    toks = nb["tokens"]
    for i in range(12):
        step = toks[:, i:i + 1]
        got, cache = model.decode(tp, cache, torch.from_numpy(step))
        want, jcache = decode(jp, jcache, jnp.asarray(step))
        _close(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], rtol=LOGIT_TOL, atol=LOGIT_TOL)
    assert int(cache["pos"]) == 12


def test_unembed_softcap_matches_jax():
    cfg = dataclasses.replace(get_config("glm4-9b", True),
                              logits_softcap=3.0)
    jcfg = dataclasses.replace(jax_get_config("glm4-9b", True),
                               logits_softcap=3.0)
    p = np_params("glm4-9b")
    h = _normal(110, 2, 3, cfg.d_model, scale=4.0)
    got = T.unembed(lm_params_from_numpy(p), torch.from_numpy(h), cfg)
    want = JT.unembed(jax.tree.map(jnp.asarray, p), jnp.asarray(h), jcfg)
    assert float(got.abs().max()) <= 3.0
    _close(got, want)
