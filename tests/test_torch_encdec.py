"""The port's encoder-decoder (Seamless-M4T medium's transformer core)
against the JAX package at SMOKE size: the full-width parameter tree,
``encode``, ``prefill_cross_kv``, ``encdec_apply``, stepped
``encdec_decode`` with prefilled and with zero cross K/V, ternary serving,
the step builders and the CLI.

Inputs come from numpy seeds; the parameters from the JAX package's
``Model.init``, carried across as numpy arrays
(``convert.lm_params_from_numpy``). Every key count here (encoder frames,
the decode cache) is at most 2,048, one whole ``kv_chunk``: the JAX
package's non-causal ``blockwise_attention`` pads the keys to whole
chunks and counts the padded ones in its softmax (ROADMAP section 3),
while the port's last chunk is short, so the two agree only where no key
is padded. Tolerances, all f32:

  * ``LAYER_TOL`` (1e-5): the encoder output and the cross K/V, the same
    formulas with sum orders and f32 ``exp`` an ulp apart;
  * ``LOGIT_TOL`` (2e-4): the whole model's f32 logits and caches, as
    ``tests/test_torch_transformer.py`` holds them;
  * exact: greedy tokens, packed bytes, quantization stats.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import steps as jax_steps  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import encdec as JE  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import generate as jax_generate  # noqa: E402
from repro.serving import quantize_for_serving as jax_quantize  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as E  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import (ServeConfig, generate,  # noqa: E402
                                 quantize_for_serving)
from test_torch_lm_serving import _assert_no_near_ties  # noqa: E402
from test_torch_transformer import LOGIT_TOL, np_init, np_params  # noqa: E402

ARCH = "seamless-m4t-medium"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
L_TOL = dict(rtol=LOGIT_TOL, atol=LOGIT_TOL)
# Ternary serving packs only dims >= 256, so SMOKE (d=64) packs nothing:
# a 2 + 2-layer enc-dec at d_model 256 packs both stacks' MLPs and
# frontend_proj; the attention weights (cross-attention's included) are
# 4-D stacks and stay float.
_Q = dict(name="seamless-q", family="encdec", num_layers=2, d_model=256,
          vocab_size=254, d_ff=512, num_heads=4, num_kv_heads=4,
          head_dim=64, encoder_layers=2, decoder_layers=2,
          frontend_dim=256, activation="gelu", dtype="float32")


def _smoke():
    p = np_params(ARCH)
    return (get_config(ARCH, True), jax_get_config(ARCH, True),
            jax.tree.map(jnp.asarray, p), lm_params_from_numpy(p))


def _frames(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.frontend_dim)).astype(np.float32)


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def test_public_names_and_full_width_defs_match_jax():
    """The JAX module's names plus ``prefill_cross_kv``, and
    seamless-m4t-medium's tree at full width as meta tensors: the same
    leaves, shapes and count (0.878 B, half of it the 256,206-token
    embedding and LM head)."""
    assert set(JE.__all__) | {"prefill_cross_kv"} <= set(E.__all__)
    assert all(hasattr(E, n) for n in E.__all__)
    cfg = get_config(ARCH)
    meta = build_model(cfg).abstract_params()
    want = jax_build_model(jax_get_config(ARCH)).abstract_params()
    leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, spec in leaves.items():
        t = meta
        for key in path:
            t = t[key.key]
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == spec.shape, path
    n = build_model(cfg).num_params()
    assert n == jax_build_model(jax_get_config(ARCH)).num_params() \
        == 878_143_488
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke)) \
            == dataclasses.asdict(jax_get_config(ARCH, smoke))


def test_encode_and_prefill_cross_kv_match_jax():
    """10 frames at B=2 through the bidirectional encoder, then the
    stacked cross K/V (L, B, S_enc, KVH, hd)."""
    cfg, jcfg, jp, tp = _smoke()
    fr = _frames(cfg, 2, 10, 1)
    enc = E.encode(tp, _t(fr), cfg)
    jenc = JE.encode(jp, jnp.asarray(fr), jcfg)
    assert enc.shape == (2, 10, cfg.d_model)
    _close(enc, jenc, LAYER_TOL)
    ck, cv = E.prefill_cross_kv(tp, enc, cfg)
    jck, jcv = JE.prefill_cross_kv(jp, jenc, jcfg)
    assert ck.shape == (cfg.decoder_layers, 2, 10, cfg.num_kv_heads,
                        cfg.head_dim)
    _close(ck, jck, LAYER_TOL)
    _close(cv, jcv, LAYER_TOL)


def test_encdec_apply_matches_jax():
    """Model.apply on 12 frames and 9 decoder tokens at B=2."""
    cfg, jcfg, jp, tp = _smoke()
    fr, toks = _frames(cfg, 2, 12, 2), _tokens(cfg, 2, 9, 3)
    logits, aux = build_model(cfg).apply(
        tp, {"frames": _t(fr), "tokens": _t(toks)})
    jlogits, _ = jax.jit(jax_build_model(jcfg).apply)(
        jp, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)})
    assert logits.dtype == torch.float32 and logits.shape == (
        2, 9, cfg.vocab_size)
    assert float(aux) == 0.0
    _close(logits, jlogits, L_TOL)


@pytest.mark.parametrize("prefilled", [True, False])
def test_encdec_decode_matches_jax(prefilled):
    """Model.decode stepped 10 times at B=2 from an 8-slot cache (the
    self-attention slot clamps at the last), against the JAX package's:
    with the cross K/V of 10 encoded frames, and with the cache's zero
    cross K/V (what generate and BatchScheduler decode with). The cache
    passed in is never modified; ck and cv pass through."""
    cfg, jcfg, jp, tp = _smoke()
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    cache = model.init_cache(2, 8, device="cpu")
    jcache = jmodel.init_cache(2, 8)
    assert {k: tuple(v.shape) for k, v in cache.items()} \
        == {k: v.shape for k, v in jcache.items()}
    if prefilled:
        fr = _frames(cfg, 2, 10, 4)
        jck, jcv = JE.prefill_cross_kv(
            jp, JE.encode(jp, jnp.asarray(fr), jcfg), jcfg)
        jcache = {**jcache, "ck": jck, "cv": jcv}
        cache = {**cache, "ck": _t(np.asarray(jck)),
                 "cv": _t(np.asarray(jcv))}
    toks = _tokens(cfg, 2, 10, 5)
    decode = jax.jit(jmodel.decode)
    for i in range(10):
        step = toks[:, i:i + 1]
        before = {k: v.clone() for k, v in cache.items()}
        got, new = model.decode(tp, cache, _t(step))
        assert all(torch.equal(before[k], cache[k]) for k in cache)
        assert new["ck"] is cache["ck"] and new["cv"] is cache["cv"]
        cache = new
        want, jcache = decode(jp, jcache, jnp.asarray(step))
        _close(got, want, L_TOL)
    for key in ("k", "v"):
        _close(cache[key], jcache[key], L_TOL)
    assert int(cache["pos"]) == int(jcache["pos"]) == 10


def test_encode_refuses_a_packed_frontend():
    cfg = ModelConfig(**_Q)
    q, _ = quantize_for_serving(build_model(cfg).init(
        torch.Generator().manual_seed(0), device="cpu"))
    with pytest.raises(TypeError, match="frontend_proj"):
        E.encode(q, torch.zeros(1, 3, 256), cfg)


@pytest.fixture(scope="module")
def quantized():
    p = np_init(JaxModelConfig(**_Q), seed=1)
    jq, jstats = jax_quantize(jax.tree.map(jnp.asarray, p))
    tq, tstats = quantize_for_serving(lm_params_from_numpy(p))
    return jq, jstats, tq, tstats


def test_quantize_for_serving_matches_jax(quantized):
    """The same five leaves packed, with the same bytes: both stacks' MLP
    weights and frontend_proj; the scales within 1e-6. Every attention
    weight (4-D stacks), the embedding and the LM head stay float."""
    jq, jstats, tq, tstats = quantized
    assert tstats == jstats and tstats["quantized"] == 5
    for path in (("encoder", "mlp", "w_up"), ("encoder", "mlp", "w_down"),
                 ("decoder", "mlp", "w_up"), ("decoder", "mlp", "w_down"),
                 ("frontend_proj",)):
        j, t = jq, tq
        for key in path:
            j, t = j[key], t[key]
        assert np.array_equal(t["packed"].numpy(), np.asarray(j["packed"]))
        np.testing.assert_allclose(t["scale"].numpy(),
                                   np.asarray(j["scale"]), rtol=1e-6)
    for leaf in (tq["decoder"]["cross_attn"]["wk"],
                 tq["encoder"]["attn"]["wq"], tq["embed"], tq["lm_head"]):
        assert isinstance(leaf, torch.Tensor)


def test_quantized_greedy_tokens_match_jax(quantized):
    """generate on the packed model (zero cross K/V, K3's plain version
    on the CPU): 4-token prompts, 6 new tokens."""
    jq, _, tq, _ = quantized
    prompts = np.random.default_rng(6).integers(2, 254, (2, 4)).astype(
        np.int32)
    want, _ = jax_generate(jax_build_model(JaxModelConfig(**_Q)), jq,
                           jnp.asarray(prompts),
                           JaxServeConfig(max_new_tokens=6))
    model = build_model(ModelConfig(**_Q))
    got, _ = generate(model, tq, prompts, ServeConfig(max_new_tokens=6),
                      device="cpu")
    _assert_no_near_ties(model, tq, prompts, got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_steps_match_jax():
    """make_prefill_step takes ``batch["frames"]``: its last-position
    logits against the JAX package's; make_serve_step's next tokens are
    the argmax of Model.decode's logits."""
    cfg, jcfg, jp, tp = _smoke()
    fr, toks = _frames(cfg, 2, 16, 7), _tokens(cfg, 2, 12, 8)
    got = steps.make_prefill_step(cfg)(
        tp, {"frames": _t(fr), "tokens": _t(toks)})
    want = jax_steps.make_prefill_step(jcfg)(
        jp, {"frames": jnp.asarray(fr), "tokens": jnp.asarray(toks)})
    assert got.shape == (2, cfg.vocab_size) and got.is_contiguous()
    _close(got, want, L_TOL)

    model = build_model(cfg)
    serve = steps.make_serve_step(cfg)
    cache = model.init_cache(2, 8, device="cpu")
    ref = model.init_cache(2, 8, device="cpu")
    tok = _t(toks[:, :1])
    for _ in range(5):
        logits, ref = model.decode(tp, ref, tok)
        tok, cache = serve(tp, cache, tok)
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        assert torch.equal(tok[:, 0].long(), logits[:, -1].argmax(-1))
    assert int(cache["pos"]) == 5


def test_serve_cli_runs_seamless_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--requests", "5", "--new-tokens", "3",
         "--quant", "ternary"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 5 requests in 2 batches" in proc.stdout
    assert "ternary: 0 tensors packed" in proc.stdout
