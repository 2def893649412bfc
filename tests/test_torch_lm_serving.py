"""LM serving in the port against the JAX package: ``generate``,
``BatchScheduler``, ternary ``quantize_for_serving`` and the CLI.

Parameters come from the JAX package's init with nonzero ``u``/``mu``
(``tests/test_torch_rwkv6.np_lm_params``) and cross as numpy arrays. The
models are f32, so greedy tokens must be equal; each comparison first
checks that no step is a near-tie within the logits' tolerance, so that a
tie would show as such rather than as a wrong token.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs.rwkv6_7b import SMOKE as JAX_SMOKE  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as jax_layers  # noqa: E402
from repro.models.config import ModelConfig as JaxModelConfig  # noqa: E402
from repro.serving import ServeConfig as JaxServeConfig  # noqa: E402
from repro.serving import generate as jax_generate  # noqa: E402
from repro.serving import quantize_for_serving as jax_quantize  # noqa: E402
from repro.serving.scheduler import (  # noqa: E402
    BatchScheduler as JaxScheduler, Request as JaxRequest)
from repro_torch.configs.rwkv6_7b import SMOKE  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ternary_matmul as k3  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.serving import (BatchScheduler, Request,  # noqa: E402
                                 ServeConfig, generate,
                                 quantize_for_serving)
from test_torch_rwkv6 import np_lm_params  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOGIT_TOL = 2e-4          # f32 logits, port vs JAX (test_torch_rwkv6)

# Ternary serving packs only dims >= 256, so SMOKE (d=64) packs nothing:
# a 2-layer RWKV-6 at d_model 256 exercises the packed path.
_Q = dict(name="rwkv6-q", family="rwkv6", num_layers=2, d_model=256,
          vocab_size=256, d_ff=512, rwkv_head_dim=64, rwkv_lora_rank=8,
          chunk_size=16, dtype="float32")
Q_CFG, JAX_Q_CFG = ModelConfig(**_Q), JaxModelConfig(**_Q)


@pytest.fixture(scope="module")
def smoke():
    p = np_lm_params(JAX_SMOKE)
    return jax.tree.map(jnp.asarray, p), lm_params_from_numpy(p)


@pytest.fixture(scope="module")
def quantized():
    p = np_lm_params(JAX_Q_CFG, seed=1)
    jq, jstats = jax_quantize(jax.tree.map(jnp.asarray, p))
    tq, tstats = quantize_for_serving(lm_params_from_numpy(p))
    return jq, jstats, tq, tstats


def _prompts(b, s, vocab, seed):
    return np.random.default_rng(seed).integers(2, vocab, (b, s)).astype(
        np.int32)


def _assert_no_near_ties(model, params, prompts, tokens):
    """Replay the port's decode over prompt + generated tokens and check
    that each generating step's top-2 logit gap exceeds the tolerance."""
    seq = torch.from_numpy(np.concatenate([prompts, tokens], axis=1)).long()
    cache = model.init_cache(seq.shape[0], seq.shape[1], device="cpu")
    for i in range(seq.shape[1] - 1):
        logits, cache = model.decode(params, cache, seq[:, i:i + 1])
        if i >= prompts.shape[1] - 1:
            top2 = torch.topk(logits[:, -1], 2).values
            assert float((top2[:, 0] - top2[:, 1]).min()) > 2 * LOGIT_TOL


def test_greedy_generate_matches_jax(smoke):
    jp, tp = smoke
    prompts = _prompts(3, 5, SMOKE.vocab_size, 0)
    want, _ = jax_generate(jax_build_model(JAX_SMOKE), jp,
                           jnp.asarray(prompts),
                           JaxServeConfig(max_new_tokens=8))
    model = build_model(SMOKE)
    got, stats = generate(model, tp, prompts, ServeConfig(max_new_tokens=8),
                          device="cpu")
    assert got.shape == (3, 8) and got.dtype == np.int32
    assert stats.tokens_generated == 24
    _assert_no_near_ties(model, tp, prompts, got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sampling_draws_from_the_generator(smoke):
    _, tp = smoke
    prompts = _prompts(2, 3, SMOKE.vocab_size, 1)
    cfg = ServeConfig(max_new_tokens=6, greedy=False, temperature=1.5)
    model = build_model(SMOKE)
    runs = [generate(model, tp, prompts, cfg, device="cpu",
                     generator=torch.Generator().manual_seed(s))[0]
            for s in (7, 7, 8)]
    assert np.array_equal(runs[0], runs[1])
    assert not np.array_equal(runs[0], runs[2])
    assert ((runs[0] >= 0) & (runs[0] < SMOKE.vocab_size)).all()
    with pytest.raises(ValueError, match="Generator"):
        generate(model, tp, prompts, cfg, device="cpu")


def _requests(cls, n, vocab, seed):
    rng = np.random.default_rng(seed)
    return [cls(id=i, prompt=rng.integers(2, vocab, size=rng.integers(2, 6)),
                max_new_tokens=int(rng.integers(2, 6))) for i in range(n)]


def test_scheduler_matches_jax(smoke):
    jp, tp = smoke
    want = JaxScheduler(jax_build_model(JAX_SMOKE), jp, max_batch=3,
                        cache_len=16).run(
        _requests(JaxRequest, 7, SMOKE.vocab_size, 0))
    sched = BatchScheduler(build_model(SMOKE), tp, max_batch=3,
                           cache_len=16, device="cpu")
    got = sched.run(_requests(Request, 7, SMOKE.vocab_size, 0))
    assert [r.output for r in got] == [r.output for r in want]
    assert all(r.done and len(r.output) == r.max_new_tokens for r in got)
    assert sched.stats["batches"] == 3
    assert sched.stats["tokens"] == sum(r.max_new_tokens for r in got)


def test_scheduler_batch_consistency_vs_single(smoke):
    """A request served alone == the same request served in a batch: the
    zero-padded slots do not leak into the real ones."""
    _, tp = smoke
    model = build_model(SMOKE)
    prompt = np.array([5, 9, 11], np.int64)
    solo = Request(id=0, prompt=prompt, max_new_tokens=5)
    BatchScheduler(model, tp, max_batch=1, cache_len=16,
                   device="cpu").run([solo])
    mate = Request(id=1, prompt=prompt, max_new_tokens=5)
    other = Request(id=2, prompt=np.array([30, 31], np.int64),
                    max_new_tokens=5)
    BatchScheduler(model, tp, max_batch=2, cache_len=16,
                   device="cpu").run([mate, other])
    assert solo.output == mate.output


def test_quantize_for_serving_matches_jax(quantized):
    """Equal stats and packed bytes; the per-channel scales are f32 means
    whose sums run in another order in each package, so within 1e-6."""
    jq, jstats, tq, tstats = quantized
    assert tstats == jstats
    assert tstats["quantized"] == 8          # 5 time-mix + 3 channel-mix
    for grp, names in (("tm", ("wr", "wk", "wv", "wg", "wo")),
                       ("cm", ("wk", "wv", "wr"))):
        for name in names:
            j, t = jq["layers"][grp][name], tq["layers"][grp][name]
            assert t["packed"].dtype == torch.uint8
            assert np.array_equal(t["packed"].numpy(),
                                  np.asarray(j["packed"])), (grp, name)
            np.testing.assert_allclose(t["scale"].numpy(),
                                       np.asarray(j["scale"]), rtol=1e-6)
    assert torch.equal(tq["lm_head"], lm_params_from_numpy(
        {"w": np.asarray(jq["lm_head"])})["w"])


def test_dense_on_packed_weights_matches_jax(quantized):
    """``dense`` on a packed leaf (K3's plain version on the CPU) against
    JAX ``dense`` on the same packed bytes: the same exact products,
    summed in another order, so within 1e-5."""
    jq, _, tq, _ = quantized
    x = np.random.default_rng(2).normal(size=(2, 3, 512)).astype(np.float32)
    j = jax.tree.map(lambda a: a[1], jq["layers"]["cm"]["wv"])
    t = {k: v[1] for k, v in tq["layers"]["cm"]["wv"].items()}
    before = k3.launches
    got = layers.dense(torch.from_numpy(x), t, role="down")
    want = jax_layers.dense(jnp.asarray(x), j, role="down")
    assert got.shape == (2, 3, 256) and k3.launches == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_quantized_greedy_tokens_match_jax(quantized):
    jq, _, tq, _ = quantized
    prompts = _prompts(2, 4, Q_CFG.vocab_size, 3)
    want, _ = jax_generate(jax_build_model(JAX_Q_CFG), jq,
                           jnp.asarray(prompts),
                           JaxServeConfig(max_new_tokens=6))
    model = build_model(Q_CFG)
    got, _ = generate(model, tq, prompts, ServeConfig(max_new_tokens=6),
                      device="cpu")
    _assert_no_near_ties(model, tq, prompts, got)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_serve_cli_runs_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "rwkv6-7b", "--device", "cpu", "--requests", "3",
         "--new-tokens", "4"], env=env, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "served 3 requests in 1 batches" in proc.stdout
