"""The port's zamba2 hybrid (Mamba-2 + one weight-shared attention block)
against the JAX package at SMOKE size: the full-width parameter tree, the
SSD scan (chunked and stepwise), one Mamba-2 layer in prefill and decode,
the model's logits, stepped decode across a ring wrap, ternary serving and
the step builders and CLI.

Inputs come from numpy seeds; the parameters from the JAX package's
``Model.init``, carried across as numpy arrays
(``convert.lm_params_from_numpy``), with the per-head ``a_log``,
``dt_bias``, ``d_skip`` and the conv bias drawn at random (their inits are
constants, which would leave the per-head broadcasts untested).
Tolerances, all f32:

  * ``SSD_TOL`` (1e-5): the SSD scan and one layer, the same formulas
    with f32 ``exp``/``cumsum`` and sum orders an ulp apart between XLA
    CPU and torch CPU;
  * ``STEP_TOL`` (1e-4): the chunked scan against the stepwise one
    inside the port, the JAX package's own tolerance for that check
    (``tests/test_models.py``);
  * ``LOGIT_TOL`` (2e-4): the whole model's f32 logits and caches, as
    ``tests/test_torch_transformer.py`` holds them;
  * exact: greedy tokens, packed bytes, quantization stats.
"""
import dataclasses
import functools
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
from repro.models import zamba2 as JZ  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import generate as jax_generate  # noqa: E402
from repro.serving import quantize_for_serving as jax_quantize  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import zamba2 as Z  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving import (ServeConfig, generate,  # noqa: E402
                                 quantize_for_serving)
from test_torch_lm_serving import _assert_no_near_ties  # noqa: E402
from test_torch_transformer import LOGIT_TOL, np_init  # noqa: E402

ARCH = "zamba2-1.2b"
SRC = os.path.join(os.path.dirname(__file__), "..", "src")
SSD_TOL = dict(rtol=1e-5, atol=1e-5)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
# Ternary serving packs only dims >= 256, so SMOKE (d=64) packs nothing: a
# 3-layer zamba2 at d_model 256 (ssm_d_inner 512, 8 SSM heads) packs
# in_proj (K 256, N 1064), out_proj (K 512) and the shared block's three
# MLP weights.
_Q = dict(name="zamba2-q", family="zamba2", num_layers=3, d_model=256,
          vocab_size=256, d_ff=512, num_heads=4, num_kv_heads=4,
          head_dim=64, ssm_state=16, ssm_head_dim=64, attn_every=2,
          long_context_window=16, chunk_size=8, dtype="float32")


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _with_ssm_params(p, seed):
    """``p`` with random per-head decay, step bias and skip, and a random
    conv bias (the same arrays for both packages)."""
    layers = dict(p["layers"])
    nl, h = layers["a_log"].shape
    layers["a_log"] = _normal(seed, nl, h, scale=0.5)
    layers["dt_bias"] = _normal(seed + 1, nl, h, scale=0.5)
    layers["d_skip"] = _normal(seed + 2, nl, h)
    layers["conv_b"] = _normal(seed + 3, *layers["conv_b"].shape,
                               scale=0.1)
    return {**p, "layers": layers}


@functools.lru_cache(maxsize=None)
def np_zamba(seed=0):
    return _with_ssm_params(np_init(jax_get_config(ARCH, smoke=True), seed),
                            seed + 100)


def _both_params(p):
    return jax.tree.map(jnp.asarray, p), lm_params_from_numpy(p)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               **tol)


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    a = -np.exp(rng.normal(size=(h,)) * 0.3).astype(np.float32)
    b_in = rng.normal(size=(b, s, n)).astype(np.float32)
    c_in = rng.normal(size=(b, s, n)).astype(np.float32)
    s0 = rng.normal(size=(b, h, p, n)).astype(np.float32)
    return x, dt, a, b_in, c_in, s0


def _t(a):
    return torch.from_numpy(np.array(a, order="C"))


# ----------------------------------------------------------------------
# Names and the full-width tree
# ----------------------------------------------------------------------


def test_public_names_and_full_width_defs_match_jax():
    """The JAX module's names, and zamba2-1.2b's parameter tree at full
    width as meta tensors (no storage): the same leaves, shapes and count
    (1.17 B)."""
    assert set(JZ.__all__) <= set(Z.__all__)
    assert all(hasattr(Z, n) for n in Z.__all__ + [
        "_mamba_step", "_mamba_forward", "_shared_block", "_stage_bounds"])
    cfg = get_config(ARCH)
    assert Z._stage_bounds(cfg) == JZ._stage_bounds(jax_get_config(ARCH))
    assert Z._stage_bounds(cfg)[-1] == (36, 38) \
        and len(Z._stage_bounds(cfg)) == 7
    meta = build_model(cfg).abstract_params()
    want = jax_build_model(jax_get_config(ARCH)).abstract_params()
    leaves = dict(jax.tree_util.tree_leaves_with_path(want))
    for path, spec in leaves.items():
        t = meta
        for key in path:
            t = t[key.key]
        assert t.device.type == "meta" and t.dtype == torch.bfloat16
        assert tuple(t.shape) == spec.shape, path
    assert len(leaves) == sum(1 for _ in jax.tree.leaves(want))
    n = build_model(cfg).num_params()
    assert n == jax_build_model(jax_get_config(ARCH)).num_params() \
        == 1_170_473_856


# ----------------------------------------------------------------------
# The SSD scan
# ----------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk,with_state", [
    (24, 8, False),      # three chunks from a zero state
    (24, 8, True),       # three chunks from a given state
    (16, 16, True),      # one chunk
    (10, 64, False),     # the chunk clamps to S
])
def test_mamba2_chunked_matches_jax(s, chunk, with_state):
    x, dt, a, b_in, c_in, s0 = _ssd_inputs(1, 2, s, 3, 4, 5)
    state0 = s0 if with_state else None
    got_y, got_s = Z.mamba2_chunked(
        _t(x), _t(dt), _t(a), _t(b_in), _t(c_in),
        None if state0 is None else _t(state0), chunk=chunk)
    want_y, want_s = JZ.mamba2_chunked(
        jnp.asarray(x), jnp.asarray(dt), jnp.asarray(a), jnp.asarray(b_in),
        jnp.asarray(c_in), None if state0 is None else jnp.asarray(state0),
        chunk=chunk)
    assert got_y.dtype == torch.float32 and got_s.dtype == torch.float32
    _close(got_y, want_y, SSD_TOL)
    _close(got_s, want_s, SSD_TOL)


def test_mamba2_chunked_refuses_a_partial_chunk():
    x, dt, a, b_in, c_in, _ = _ssd_inputs(2, 1, 12, 2, 4, 3)
    with pytest.raises(ValueError, match="chunk"):
        Z.mamba2_chunked(_t(x), _t(dt), _t(a), _t(b_in), _t(c_in), chunk=8)


def test_mamba_step_matches_jax_and_the_chunked_scan():
    """``_mamba_step`` against the JAX package's at every step, and the
    port's stepwise scan against its chunked one (state and outputs)."""
    x, dt, a, b_in, c_in, s0 = _ssd_inputs(3, 2, 24, 3, 4, 5)
    state = _t(s0)
    jstate = jnp.asarray(s0)
    ys = []
    for t in range(24):
        y, state = Z._mamba_step(_t(x[:, t]), _t(dt[:, t]), _t(a),
                                 _t(b_in[:, t]), _t(c_in[:, t]), state)
        jy, jstate = JZ._mamba_step(
            jnp.asarray(x[:, t]), jnp.asarray(dt[:, t]), jnp.asarray(a),
            jnp.asarray(b_in[:, t]), jnp.asarray(c_in[:, t]), jstate)
        _close(y, jy, SSD_TOL)
        _close(state, jstate, SSD_TOL)
        ys.append(y)
    y_chk, s_chk = Z.mamba2_chunked(_t(x), _t(dt), _t(a), _t(b_in),
                                    _t(c_in), _t(s0), chunk=8)
    _close(torch.stack(ys, 1), y_chk.numpy(), STEP_TOL)
    _close(state, s_chk.numpy(), STEP_TOL)


def test_softplus_is_jaxs_above_torchs_threshold():
    v = np.array([-30.0, -1.0, 0.0, 3.0, 19.9, 20.1, 40.0], np.float32)
    _close(Z._softplus(_t(v)), jax.nn.softplus(jnp.asarray(v)),
           dict(rtol=1e-6, atol=0))


# ----------------------------------------------------------------------
# One Mamba-2 layer, the whole model
# ----------------------------------------------------------------------


def test_mamba_forward_matches_jax_in_prefill_and_decode():
    """Layer 1 of the SMOKE model over 32 tokens (two chunks of 16), then
    3 decode steps from the states prefill left (the conv window and the
    SSM state)."""
    cfg, jcfg = get_config(ARCH, True), jax_get_config(ARCH, True)
    jp, tp = _both_params(np_zamba())
    lp = tree_map(lambda x: x[1], tp["layers"])
    jlp = jax.tree.map(lambda x: x[1], jp["layers"])
    x = _normal(5, 2, 32, cfg.d_model)
    out, (conv, ssm) = Z._mamba_forward(lp, _t(x), cfg)
    jout, (jconv, jssm) = JZ._mamba_forward(jlp, jnp.asarray(x), jcfg)
    assert conv.shape == (2, cfg.conv_kernel - 1,
                          cfg.ssm_d_inner + 2 * cfg.ssm_state)
    _close(out, jout, SSD_TOL)
    _close(conv, jconv, SSD_TOL)
    _close(ssm, jssm, SSD_TOL)
    conv, ssm = _t(np.asarray(jconv)), _t(np.asarray(jssm))
    for i in range(3):
        xs = _normal(6 + i, 2, 1, cfg.d_model)
        out, (conv, ssm) = Z._mamba_forward(lp, _t(xs), cfg,
                                            conv_state=conv, ssm_state=ssm,
                                            decode=True)
        jout, (jconv, jssm) = JZ._mamba_forward(
            jlp, jnp.asarray(xs), jcfg, conv_state=jconv, ssm_state=jssm,
            decode=True)
        _close(out, jout, SSD_TOL)
        _close(conv, jconv, SSD_TOL)
        _close(ssm, jssm, SSD_TOL)


def test_zamba2_apply_matches_jax():
    """Model.apply logits at B=2, S=32 (two chunks of 16; two stages,
    each followed by the shared block)."""
    cfg, jcfg = get_config(ARCH, True), jax_get_config(ARCH, True)
    jp, tp = _both_params(np_zamba())
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (2, 32))
    logits, aux = build_model(cfg).apply(tp, {"tokens": _t(toks)})
    jlogits, _ = jax.jit(jax_build_model(jcfg).apply)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert logits.dtype == torch.float32 and logits.shape == (
        2, 32, cfg.vocab_size)
    assert float(aux) == 0.0
    _close(logits, jlogits, dict(rtol=LOGIT_TOL, atol=LOGIT_TOL))


@pytest.mark.parametrize("cache_len,steps", [(12, 12), (40, 26)])
def test_zamba2_decode_matches_jax(cache_len, steps):
    """Model.decode stepped at B=2 against the JAX package's, logits at
    every step and the caches at the end; the cache passed in is never
    modified. (12, 12): below the SMOKE window of 16, so decode also
    equals the port's forward. (40, 26): the cache clamps to the window,
    so the shared block attends over a ring that wraps after step 16."""
    cfg, jcfg = get_config(ARCH, True), jax_get_config(ARCH, True)
    jp, tp = _both_params(np_zamba())
    model, jmodel = build_model(cfg), jax_build_model(jcfg)
    toks = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, steps))
    cache = model.init_cache(2, cache_len, device="cpu")
    jcache = jmodel.init_cache(2, cache_len)
    assert {k: tuple(v.shape) for k, v in cache.items()} \
        == {k: v.shape for k, v in jcache.items()}
    assert cache["ssm"].dtype == torch.float32
    assert cache["attn_k"].shape[2] == min(cache_len, 16)
    decode = jax.jit(jmodel.decode)
    outs = []
    for i in range(steps):
        step = toks[:, i:i + 1]
        before = {k: v.clone() for k, v in cache.items()}
        got, new = model.decode(tp, cache, _t(step))
        assert all(torch.equal(before[k], cache[k]) for k in cache)
        cache = new
        want, jcache = decode(jp, jcache, jnp.asarray(step, jnp.int32))
        _close(got, want, dict(rtol=LOGIT_TOL, atol=LOGIT_TOL))
        outs.append(got[:, 0])
    for key in ("conv", "ssm", "attn_k", "attn_v"):
        _close(cache[key], jcache[key], dict(rtol=LOGIT_TOL, atol=LOGIT_TOL))
    assert int(cache["pos"]) == int(jcache["pos"]) == steps
    if cache_len < 16:
        full, _ = model.apply(tp, {"tokens": _t(toks)})
        _close(torch.stack(outs, 1), full.numpy(),
               dict(rtol=LOGIT_TOL, atol=LOGIT_TOL))


# ----------------------------------------------------------------------
# Ternary serving, steps, CLI
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def quantized():
    p = _with_ssm_params(np_init(JaxModelConfig(**_Q), seed=1), 200)
    jq, jstats = jax_quantize(jax.tree.map(jnp.asarray, p))
    tq, tstats = quantize_for_serving(lm_params_from_numpy(p))
    return jq, jstats, tq, tstats


def test_quantize_for_serving_matches_jax(quantized):
    """The same five leaves packed, with the same bytes: the stacked
    in_proj and out_proj and the shared block's MLP (packed once: it is
    one weight-tied block); the per-channel scales within 1e-6. The
    shared attention's weights (K < 256 on their last two axes), the
    conv, the norms, the embedding and the LM head stay float."""
    jq, jstats, tq, tstats = quantized
    assert tstats == jstats and tstats["quantized"] == 5
    for path in (("layers", "in_proj"), ("layers", "out_proj"),
                 ("shared", "mlp", "w_gate"), ("shared", "mlp", "w_up"),
                 ("shared", "mlp", "w_down")):
        j, t = jq, tq
        for key in path:
            j, t = j[key], t[key]
        assert t["packed"].dtype == torch.uint8
        assert np.array_equal(t["packed"].numpy(), np.asarray(j["packed"]))
        np.testing.assert_allclose(t["scale"].numpy(),
                                   np.asarray(j["scale"]), rtol=1e-6)
    assert tq["layers"]["in_proj"]["packed"].shape == (3, 64, 1064)
    for leaf in (tq["shared"]["attn"]["wq"], tq["layers"]["conv_w"],
                 tq["embed"], tq["lm_head"]):
        assert isinstance(leaf, torch.Tensor)


def test_quantized_greedy_tokens_match_jax(quantized):
    """generate on the packed model (K3's plain version on the CPU) over
    a 4-token prompt and 8 new tokens: cache 12 < the window of 16."""
    jq, _, tq, _ = quantized
    prompts = np.random.default_rng(3).integers(2, 256, (2, 4)).astype(
        np.int32)
    want, _ = jax_generate(jax_build_model(JaxModelConfig(**_Q)), jq,
                           jnp.asarray(prompts),
                           JaxServeConfig(max_new_tokens=8))
    model = build_model(ModelConfig(**_Q))
    got, _ = generate(model, tq, prompts, ServeConfig(max_new_tokens=8),
                      device="cpu")
    _assert_no_near_ties(model, tq, prompts, got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_steps_match_jax():
    """make_prefill_step's last-position logits (S=16) against the JAX
    package's; make_serve_step's next tokens are the argmax of
    Model.decode's logits over a ring wrap (cache 16, 20 steps)."""
    cfg, jcfg = get_config(ARCH, True), jax_get_config(ARCH, True)
    jp, tp = _both_params(np_zamba())
    toks = np.random.default_rng(9).integers(0, cfg.vocab_size, (2, 16))
    got = steps.make_prefill_step(cfg)(tp, {"tokens": _t(toks)})
    want = jax_steps.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks, jnp.int32)})
    assert got.shape == (2, cfg.vocab_size) and got.is_contiguous()
    _close(got, want, dict(rtol=LOGIT_TOL, atol=LOGIT_TOL))

    model = build_model(cfg)
    serve = steps.make_serve_step(cfg)
    cache = model.init_cache(2, 16, device="cpu")
    ref = model.init_cache(2, 16, device="cpu")
    tok = _t(toks[:, :1])
    for _ in range(20):
        logits, ref = model.decode(tp, ref, tok)
        tok, cache = serve(tp, cache, tok)
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        assert torch.equal(tok[:, 0].long(), logits[:, -1].argmax(-1))
    assert int(cache["pos"]) == 20


def test_serve_cli_runs_zamba2_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--device", "cpu", "--requests", "3", "--new-tokens", "4"],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests in 1 batches" in proc.stdout


def test_config_dataclass_equals_jax():
    for smoke in (False, True):
        assert dataclasses.asdict(get_config(ARCH, smoke)) \
            == dataclasses.asdict(jax_get_config(ARCH, smoke))
