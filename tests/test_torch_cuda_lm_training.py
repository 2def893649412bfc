"""LM training on the card, at SMOKE size, against the port's CPU run.

Marked ``cuda``: each test asks the ``card`` fixture, which skips without
a GPU (decided inside the fixture, never at import). On the H100 run them
with ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda_lm_training.py`` (the suite's conftest imports jax).

  * ``ops.wkv6_scan``'s gradients on the card (K4 forward, the chunked
    form's backward) against the CPU's, f32 and bf16 inputs, within
    ``WKV_TOL`` of each input's largest gradient; K4 launches once a
    forward and never in the backward;
  * ``remat=True`` against ``remat=False`` on the card, per family: the
    loss and every gradient bit for bit;
  * a 2-layer llama3.2-1b SMOKE ``Trainer`` run with a crash and a
    restart from a checkpoint repeats the uninterrupted run bit for bit
    (``deterministic(all_ops=True)`` inside each step), in f32 and with
    bf16 parameters (bf16 checkpoints).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import TokenTaskConfig, token_batch  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6_scan as k4  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (AdamWConfig, Trainer,  # noqa: E402
                                  TrainerConfig, deterministic)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.trainer import loss_and_grads  # noqa: E402

pytestmark = pytest.mark.cuda
# f32: the same chunked formulas summed in other orders (~1e-6 of the
# largest gradient); bf16: those gradients rounded to bf16 (2**-9 of a
# value). A wrong term moves a gradient by O(1) of its largest.
WKV_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}
FAMILY_ARCHS = ["llama3.2-1b", "deepseek-moe-16b", "qwen2-vl-2b",
                "rwkv6-7b", "zamba2-1.2b", "seamless-m4t-medium"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run on the card only)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_gradient_on_the_card_matches_the_cpu(card, dtype):
    g = torch.Generator().manual_seed(0)
    b, t, h, hd = 2, 64, 4, 64
    r, k, v = (torch.randn(b, t, h, hd, generator=g) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(b, t, h, hd, generator=g)
                                  * 0.5 - 0.5), min=-4.0)
    u = torch.randn(h, hd, generator=g) * 0.5
    s0 = torch.randn(b, h, hd, hd, generator=g) * 0.1
    g_o = torch.randn(b, t, h, hd, generator=g).to(dtype)
    g_s = torch.randn(b, h, hd, hd, generator=g)
    dev_in = [x.to(dtype) if i in (0, 1, 2, 4) else x
              for i, x in enumerate((r, k, v, logw, u, s0))]
    dev_in = [x.to(card).requires_grad_() for x in dev_in]
    cpu_in = [x.detach().cpu().float().requires_grad_() for x in dev_in]
    k4.launches = 0
    o, s = ops.wkv6_scan(*dev_in)
    assert k4.launches == 1
    got = torch.autograd.grad((o, s), dev_in, (g_o.to(card), g_s.to(card)))
    torch.cuda.synchronize()
    assert k4.launches == 1
    want = torch.autograd.grad(ops.wkv6_scan(*cpu_in), cpu_in,
                               (g_o.float(), g_s))
    for name, a, x, w in zip("r k v logw u state0".split(), got, dev_in,
                             want):
        assert a.dtype == x.dtype
        err = float((a.float().cpu() - w).abs().max())
        assert err <= WKV_TOL[dtype] * float(w.abs().max()), (name, err)


def _batch(cfg, dev, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32))
    out = {"tokens": torch.from_numpy(tokens).to(dev),
           "targets": torch.from_numpy(np.where(
               rng.random((2, 32)) < 0.2, -1, tokens)).to(dev)}
    if cfg.family == "encdec":
        out["frames"] = torch.from_numpy(rng.normal(
            size=(2, 24, cfg.frontend_dim)).astype(np.float32)).to(dev)
    if cfg.family == "vlm":
        out["patch_embeds"] = torch.from_numpy(rng.normal(
            size=(2, 16, cfg.d_model)).astype(np.float32)).to(dev)
    return out


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_is_bit_for_bit_on_the_card(card, arch):
    cfg = get_config(arch, smoke=True)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=card).manual_seed(1),
                        device=card)
    batch = _batch(cfg, card)
    k4.launches = 0
    with deterministic(all_ops=True):
        plain = loss_and_grads(model, params, batch, remat=False)
        torch.cuda.synchronize()
        once = k4.launches
        remat = loss_and_grads(model, params, batch, remat=True)
    torch.cuda.synchronize()
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(tree_leaves(plain[2]), tree_leaves(remat[2])):
        assert torch.equal(a, b)
    if cfg.family == "rwkv6":
        assert once == cfg.num_layers
        assert k4.launches - once == 2 * cfg.num_layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_two_layer_restart_is_bit_for_bit_on_the_card(card, tmp_path,
                                                      dtype):
    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                              dtype=dtype)
    tk = TokenTaskConfig(vocab_size=cfg.vocab_size, seq_len=32,
                         batch_size=4, task="repeat")

    def trainer(d, every):
        tc = TrainerConfig(total_steps=12, ckpt_every=every,
                           ckpt_dir=str(tmp_path / d), log_every=100,
                           opt=AdamWConfig(lr=3e-3, warmup_steps=2,
                                           total_steps=12))
        return Trainer(build_model(cfg), tc,
                       lambda s: token_batch(tk, s, device=card),
                       device=card)

    crashed = {"done": False}

    def hook(step):
        if step == 6 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    gen = torch.Generator(device=card).manual_seed(2)
    ref = trainer("a", 12).run(gen)
    res = trainer("b", 3).run_with_restarts(gen, failure_hook=hook)
    assert crashed["done"]
    assert [h["loss"] for h in res["history"]] == \
        [h["loss"] for h in ref["history"]][6:]
    for a, b in zip(tree_leaves(res["state"]), tree_leaves(ref["state"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_logits_f32_gradient_on_the_card_matches_the_cpu(card):
    """The card's bf16 x bf16 -> f32 lm_head product under autograd
    (``layers._MmF32``) against the CPU path's f32 casts: f32 logits, and
    gradients rounded to bf16 from f32 products (within one bf16 rounding
    of each gradient's largest entry)."""
    from repro_torch.models import layers as L
    g = torch.Generator().manual_seed(3)
    h = torch.randn(2, 8, 64, generator=g).to(torch.bfloat16)
    w = (torch.randn(64, 300, generator=g) * 0.1).to(torch.bfloat16)
    cot = torch.randn(2, 8, 300, generator=g)
    out = {}
    for dev in (card, torch.device("cpu")):
        hh, ww = (x.to(dev).requires_grad_() for x in (h, w))
        y = L.logits_f32(hh, ww)
        assert y.dtype == torch.float32
        out[dev.type] = (y.detach().cpu(), *(a.cpu() for a in
                         torch.autograd.grad(y, (hh, ww), cot.to(dev))))
    for a, b in zip(out["cuda"], out["cpu"]):
        assert a.dtype == b.dtype
        assert float((a.float() - b.float()).abs().max()) <= \
            2 ** -8 * float(b.float().abs().max())
