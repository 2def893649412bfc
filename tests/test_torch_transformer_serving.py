"""Serving the transformer families in the port against the JAX package:
``generate``, ``BatchScheduler``, ternary ``quantize_for_serving`` (K3's
plain version on the CPU), the step builders and the CLI.

Parameters come from the JAX package's init and cross as numpy arrays.
The models are f32, so greedy tokens must be equal; each comparison first
checks that no generating step is a near-tie within the logits'
tolerance (``test_torch_lm_serving._assert_no_near_ties``, 2 x
``LOGIT_TOL`` = 4e-4), so that a tie would show as such rather than as a
wrong token. Logits hold ``LOGIT_TOL`` = 2e-4, as in
``test_torch_transformer.py``.
"""
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
from repro.models import layers as JL  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import generate as jax_generate  # noqa: E402
from repro.serving import quantize_for_serving as jax_quantize  # noqa: E402
from repro.serving.scheduler import (  # noqa: E402
    BatchScheduler as JaxScheduler, Request as JaxRequest)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ternary_matmul as k3  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import (BatchScheduler, Request,  # noqa: E402
                                 ServeConfig, generate,
                                 quantize_for_serving)
from test_torch_lm_serving import _assert_no_near_ties  # noqa: E402
from test_torch_transformer import (LOGIT_TOL, np_init,  # noqa: E402
                                    np_params)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

# Ternary serving packs only dims >= 256, so the SMOKE configs (d=64)
# pack nothing: 2-layer d_model-256 configs exercise the packed path, a
# dense one (MLP weights) and a MoE one (the shared experts, nested under
# ``moe/shared``; the routed experts are 4-D and stay float).
_Q = dict(name="llama-q", family="dense", num_layers=2, d_model=256,
          vocab_size=256, d_ff=512, num_heads=4, num_kv_heads=2,
          head_dim=64, tie_embeddings=True, dtype="float32")
_QM = dict(name="moe-q", family="moe", num_layers=2, d_model=256,
           vocab_size=256, d_ff=256, num_heads=4, num_kv_heads=4,
           head_dim=64, num_experts=4, top_k=2, num_shared_experts=1,
           expert_d_ff=256, moe_group_size=8, dtype="float32")


@pytest.fixture(scope="module")
def quantized():
    out = {}
    for name, kw in (("dense", _Q), ("moe", _QM)):
        p = np_init(JaxModelConfig(**kw), seed=1)
        jq, jstats = jax_quantize(jax.tree.map(jnp.asarray, p))
        tq, tstats = quantize_for_serving(lm_params_from_numpy(p))
        out[name] = (jq, jstats, tq, tstats)
    return out


def _smoke(arch):
    p = np_params(arch)
    return (get_config(arch, True), jax_get_config(arch, True),
            jax.tree.map(jnp.asarray, p), lm_params_from_numpy(p))


def _prompts(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, s)).astype(
        np.int32)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "h2o-danube-1.8b",
                                  "deepseek-moe-16b", "qwen2-vl-2b",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_greedy_generate_matches_jax(arch):
    """5-token prompts and 8 new tokens at B=3: h2o-danube's window of 8
    wraps its ring, deepseek-moe's decode steps (G=3, cap 1) drop
    tokens, qwen2-vl's text positions run through M-RoPE; zamba2 carries
    its Mamba-2 states and shared-block caches, seamless decodes with zero
    cross K/V (as generate does in the JAX package)."""
    cfg, jcfg, jp, tp = _smoke(arch)
    prompts = _prompts(3, 5, cfg.vocab_size, 0)
    want, _ = jax_generate(jax_build_model(jcfg), jp, jnp.asarray(prompts),
                           JaxServeConfig(max_new_tokens=8))
    model = build_model(cfg)
    got, stats = generate(model, tp, prompts, ServeConfig(max_new_tokens=8),
                          device="cpu")
    assert got.shape == (3, 8) and got.dtype == np.int32
    assert stats.tokens_generated == 24
    _assert_no_near_ties(model, tp, prompts, got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampling_draws_from_the_generator():
    cfg, _, _, tp = _smoke("glm4-9b")
    prompts = _prompts(2, 3, cfg.vocab_size, 1)
    sc = ServeConfig(max_new_tokens=6, greedy=False, temperature=1.5)
    model = build_model(cfg)
    runs = [generate(model, tp, prompts, sc, device="cpu",
                     generator=torch.Generator().manual_seed(s))[0]
            for s in (7, 7, 8)]
    assert np.array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])


def _requests(cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [cls(id=i, prompt=rng.integers(2, vocab, size=rng.integers(2, 6)),
                max_new_tokens=int(rng.integers(2, 6))) for i in range(n)]


@pytest.mark.parametrize("arch", ["llama3.2-1b", "llama4-scout-17b-a16e",
                                  "zamba2-1.2b", "seamless-m4t-medium"])
def test_scheduler_matches_jax(arch):
    cfg, jcfg, jp, tp = _smoke(arch)
    want = JaxScheduler(jax_build_model(jcfg), jp, max_batch=3,
                        cache_len=16).run(
        _requests(JaxRequest, 7, cfg.vocab_size, 0))
    sched = BatchScheduler(build_model(cfg), tp, max_batch=3, cache_len=16,
                           device="cpu")
    got = sched.run(_requests(Request, 7, cfg.vocab_size, 0))
    assert [r.output for r in got] == [r.output for r in want]
    assert sched.stats["batches"] == 3
    assert sched.stats["tokens"] == sum(r.max_new_tokens for r in got)


def test_quantize_for_serving_matches_jax(quantized):
    """Equal stats and packed bytes on the dense and the MoE config; the
    per-channel scales are f32 means whose sums run in another order in
    each package, so within 1e-6. The embedding (tied: also the LM head),
    the attention weights (4-D), the router (N < 256) and the routed
    experts (4-D) stay float."""
    for name, leaves in (("dense", [("mlp", n) for n in
                                    ("w_gate", "w_up", "w_down")]),
                         ("moe", [("moe", "shared", n) for n in
                                  ("w_gate", "w_up", "w_down")])):
        jq, jstats, tq, tstats = quantized[name]
        assert tstats == jstats and tstats["quantized"] == 3, name
        for path in leaves:
            j, t = jq["layers"], tq["layers"]
            for key in path:
                j, t = j[key], t[key]
            assert t["packed"].dtype == torch.uint8
            assert np.array_equal(t["packed"].numpy(),
                                  np.asarray(j["packed"])), (name, path)
            np.testing.assert_allclose(t["scale"].numpy(),
                                       np.asarray(j["scale"]), rtol=1e-6)
        assert isinstance(tq["embed"], torch.Tensor)
        assert isinstance(tq["layers"]["attn"]["wq"], torch.Tensor)


def test_mlp_on_packed_weights_matches_jax(quantized):
    """``mlp_apply`` with packed leaves (K3's plain version on the CPU, no
    launch) against the JAX package's on the same bytes: the same exact
    products summed in another order, within 1e-5."""
    jq, _, tq, _ = quantized["dense"]
    x = np.random.default_rng(2).normal(size=(2, 3, 256)).astype(np.float32)
    j = jax.tree.map(lambda a: a[1], jq["layers"]["mlp"])
    t = {k: {kk: vv[1] for kk, vv in v.items()}
         for k, v in tq["layers"]["mlp"].items()}
    before = k3.launches
    got = L.mlp_apply(t, torch.from_numpy(x), ModelConfig(**_Q))
    want = JL.mlp_apply(j, jnp.asarray(x), JaxModelConfig(**_Q))
    assert k3.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name", ["dense", "moe"])
def test_quantized_greedy_tokens_match_jax(quantized, name):
    jq, _, tq, _ = quantized[name]
    kw = _Q if name == "dense" else _QM
    prompts = _prompts(2, 4, kw["vocab_size"], 3)
    want, _ = jax_generate(jax_build_model(JaxModelConfig(**kw)), jq,
                           jnp.asarray(prompts),
                           JaxServeConfig(max_new_tokens=6))
    model = build_model(ModelConfig(**kw))
    got, _ = generate(model, tq, prompts, ServeConfig(max_new_tokens=6),
                      device="cpu")
    _assert_no_near_ties(model, tq, prompts, got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_steps_match_jax():
    """make_prefill_step's last-position logits on qwen2-vl with patch
    embeddings against the JAX package's; make_serve_step's next tokens
    are the argmax of Model.decode's logits."""
    cfg, jcfg, jp, tp = _smoke("qwen2-vl-2b")
    toks = _prompts(2, 12, cfg.vocab_size, 4)
    pe = np.random.default_rng(5).normal(size=(2, 4, cfg.d_model)).astype(
        np.float32)
    got = steps.make_prefill_step(cfg)(
        tp, {"tokens": torch.from_numpy(toks),
             "patch_embeds": torch.from_numpy(pe)})
    want = jax_steps.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(toks), "patch_embeds": jnp.asarray(pe)})
    assert got.shape == (2, cfg.vocab_size) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)

    model = build_model(cfg)
    serve = steps.make_serve_step(cfg)
    cache, ref = model.init_cache(2, 8, device="cpu"), \
        model.init_cache(2, 8, device="cpu")
    tok = torch.from_numpy(toks[:, :1])
    for _ in range(5):
        logits, ref = model.decode(tp, ref, tok)
        tok, cache = serve(tp, cache, tok)
        assert tok.dtype == torch.int32 and tok.shape == (2, 1)
        assert torch.equal(tok[:, 0].long(), logits[:, -1].argmax(-1))
    assert int(cache["pos"]) == 5


def test_serve_cli_runs_llama_on_the_cpu(monkeypatch, capsys):
    """``--arch llama3.2-1b --device cpu`` in a fresh process, and the
    default arch (llama3.2-1b, as in the JAX package's CLI) in this one."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "llama3.2-1b", "--device", "cpu", "--requests", "3",
         "--new-tokens", "4"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests in 1 batches" in proc.stdout
    from repro_torch.launch import serve as cli
    asked = []
    real = cli.get_config
    monkeypatch.setattr(cli, "get_config",
                        lambda arch, smoke: asked.append(arch)
                        or real(arch, smoke))
    cli.main(["--device", "cpu", "--requests", "2", "--new-tokens", "2"])
    assert asked == ["llama3.2-1b"]
    assert "served 2 requests" in capsys.readouterr().out
