"""The transformer, zamba2 and enc-dec families on the card: K3 at their
products and their decode steps, at SMOKE widths except for K3.

Marked ``cuda``: each test asks the ``card`` fixture, which skips without
a GPU (decided inside the fixture, never at import). On the H100 run them
with ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda_transformer.py`` (the suite's conftest imports
jax).

  * K3 against its plain version, bit for bit, at llama3.2-1b's gate/up
    and down, qwen2-vl-2b's down (K = 8960) and deepseek-moe-16b's
    shared-expert down (K = 2816): the last two end in a short 512-k
    segment; zamba2-1.2b's in_proj (N = 8384) and out_proj (K = 4096),
    seamless-m4t-medium's MLP and frontend_proj; each at decode rows
    (the split path) and at rows that take the serial path;
  * a decode step of each family (dense with a sliding window, MoE, VLM,
    zamba2, enc-dec, and ternary dense, zamba2 and enc-dec models whose
    projections go through K3) raises nothing under
    ``torch.cuda.set_sync_debug_mode("error")``, and its logits are the
    CPU's within ``LOGITS_ATOL``; K3 launches as many times a ternary
    step as the model has packed products (3 a dense layer; 2 a Mamba-2
    layer and 3 a shared-block invocation; 2 a decoder layer); the
    ternary zamba2's shared-block ring wraps;
  * the enc-dec's encoder, cross K/V and decode over them on the card
    against the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ternary_matmul as k3  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving import quantize_for_serving  # noqa: E402

pytestmark = pytest.mark.cuda
# f32 logits on the card against the CPU at SMOKE widths: the same
# formulas with sums in other orders and f32 cos/sin/exp an ulp apart;
# a wrong term moves them by O(0.1).
LOGITS_ATOL = 1e-4
# A 2-layer dense model wide enough that ternary serving packs its MLP.
_Q = ModelConfig(name="llama-q", family="dense", num_layers=2, d_model=256,
                 vocab_size=256, d_ff=512, num_heads=4, num_kv_heads=2,
                 head_dim=64, tie_embeddings=True, dtype="float32")
# A 3-layer zamba2 (two shared-block invocations) and a 2 + 2-layer enc-dec
# wide enough that ternary serving packs their projections; the zamba2's
# window of 8 makes its shared-block caches rings that wrap in 12 steps.
_ZQ = ModelConfig(name="zamba2-q", family="zamba2", num_layers=3,
                  d_model=256, vocab_size=256, d_ff=512, num_heads=4,
                  num_kv_heads=4, head_dim=64, ssm_state=16, ssm_head_dim=64,
                  attn_every=2, long_context_window=8, chunk_size=8,
                  dtype="float32")
_EQ = ModelConfig(name="seamless-q", family="encdec", num_layers=2,
                  d_model=256, vocab_size=254, d_ff=512, num_heads=4,
                  num_kv_heads=4, head_dim=64, encoder_layers=2,
                  decoder_layers=2, frontend_dim=256, activation="gelu",
                  dtype="float32")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run on the card only)")
    return torch.device("cuda")


@pytest.mark.parametrize("k,n", [(2048, 8192), (8192, 2048), (8960, 1536),
                                 (2816, 2048), (2048, 8384), (4096, 2048),
                                 (1024, 4096), (4096, 1024), (1024, 1024)])
@pytest.mark.parametrize("m", [4, 96])
def test_k3_matches_its_plain_version(card, m, k, n):
    g = torch.Generator().manual_seed(k + n + m)
    wp, scale = ops.pack_ternary_weights(torch.randn(k, n, generator=g))
    wp, scale = wp.to(card), scale.to(card)
    x = torch.randn(m, k, generator=g).to(torch.bfloat16).to(card)
    assert k3.plan(m, k, n).path == ("split" if m <= 64 else "serial")
    got = k3.ternary_matmul_cuda(x, wp, scale)
    assert torch.equal(got, k3.ternary_matmul_plain(x, wp, scale))
    assert torch.equal(k3.ternary_matmul_cuda(x[-1:].contiguous(), wp,
                                              scale)[0], got[-1])


def _cases():
    """(name, config, leaves ternary serving packs, K3 launches a
    step)."""
    return [("h2o-danube-1.8b", get_config("h2o-danube-1.8b", True), 0, 0),
            ("deepseek-moe-16b", get_config("deepseek-moe-16b", True), 0,
             0),
            ("qwen2-vl-2b", get_config("qwen2-vl-2b", True), 0, 0),
            ("llama-q-ternary", _Q, 3, 3 * 2),
            ("zamba2-1.2b", get_config("zamba2-1.2b", True), 0, 0),
            ("seamless-m4t-medium", get_config("seamless-m4t-medium", True),
             0, 0),
            ("zamba2-q-ternary", _ZQ, 5, 2 * 3 + 3 * 2),
            ("seamless-q-ternary", _EQ, 5, 2 * 2)]


@pytest.mark.parametrize("case", range(8),
                         ids=[c[0] for c in _cases()])
def test_decode_steps_never_sync_and_match_the_cpu(card, case):
    """12 decode steps (h2o-danube's window of 8 and the ternary zamba2's
    wrap their rings), the last 4 under the sync debug mode."""
    _, cfg, packed, per_step = _cases()[case]
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(0), device="cpu")
    if packed:
        cpu, stats = quantize_for_serving(cpu)
        assert stats["quantized"] == packed
    gpu = tree_map(lambda x: x.to(card), cpu)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (3, 12)))
    on_card = toks.to(card)          # copied before the debug mode is on
    cc = model.init_cache(3, 12, device="cpu")
    cg = model.init_cache(3, 12, device=card)
    k3.launches = 0
    for i in range(12):
        if i >= 8:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            lg, cg = model.decode(gpu, cg, on_card[:, i:i + 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        lc, cc = model.decode(cpu, cc, toks[:, i:i + 1])
        diff = float((lg.cpu() - lc).abs().max())
        assert diff <= LOGITS_ATOL, (i, diff)
    torch.cuda.synchronize()
    assert k3.launches == per_step * 12
    assert int(cg["pos"]) == 12


def test_encdec_cross_kv_and_decode_match_the_cpu(card):
    """seamless SMOKE: encode 24 frames at B=2, prefill_cross_kv, then 6
    decode steps over them, the last 3 under the sync debug mode; the
    card against the CPU at every stage."""
    from repro_torch.models import encdec
    cfg = get_config("seamless-m4t-medium", True)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(4), device="cpu")
    gpu = tree_map(lambda x: x.to(card), cpu)
    frames = torch.from_numpy(np.random.default_rng(5).normal(
        size=(2, 24, cfg.frontend_dim)).astype(np.float32))
    caches = {}
    for dev, p in (("cpu", cpu), (card, gpu)):
        enc = encdec.encode(p, frames.to(dev), cfg)
        ck, cv = encdec.prefill_cross_kv(p, enc, cfg)
        caches[str(dev)] = (enc, {**model.init_cache(2, 8, device=dev),
                                  "ck": ck, "cv": cv})
    (ec, cc), (eg, cg) = caches["cpu"], caches[str(card)]
    assert float((eg.cpu() - ec).abs().max()) <= LOGITS_ATOL
    assert float((cg["ck"].cpu() - cc["ck"]).abs().max()) <= LOGITS_ATOL
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 6)))
    on_card = toks.to(card)
    for i in range(6):
        if i >= 3:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            lg, cg = model.decode(gpu, cg, on_card[:, i:i + 1])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        lc, cc = model.decode(cpu, cc, toks[:, i:i + 1])
        assert float((lg.cpu() - lc).abs().max()) <= LOGITS_ATOL, i


def test_prefill_matches_the_cpu_with_patch_embeddings(card):
    cfg = get_config("qwen2-vl-2b", True)
    model = build_model(cfg)
    cpu = model.init(torch.Generator().manual_seed(2), device="cpu")
    gpu = tree_map(lambda x: x.to(card), cpu)
    rng = np.random.default_rng(3)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 256, (2, 40))),
             "patch_embeds": torch.from_numpy(rng.normal(
                 size=(2, 16, cfg.d_model)).astype(np.float32))}
    lc = model.apply(cpu, batch)[0]
    lg = model.apply(gpu, {k: v.to(card) for k, v in batch.items()})[0]
    assert float((lg.cpu() - lc).abs().max()) <= LOGITS_ATOL
