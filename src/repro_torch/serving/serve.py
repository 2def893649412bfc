"""Batched LM serving: prefill + decode loop with optional ternary weights
(port of ``repro.serving.serve``).

With ``quantize_for_serving`` the large 2-D projection weights become the
packed 2-bit ternary format, and ``models.layers.dense`` sends each of
them through kernel K3 (``kernels/ternary_matmul``), cutting weight bytes
8x against bf16 for the memory-bound decode products.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.ops import pack_ternary_weights
from repro_torch.models.model import Model

__all__ = ["ServeConfig", "quantize_for_serving", "generate",
           "ServeStats"]

# Leaves eligible for ternary serving quantization: 2-D (K, N) projections
# with both dims >= this (embeddings/norms/tiny projections stay fp).
_MIN_QUANT_DIM = 256


@dataclasses.dataclass
class ServeConfig:
    max_new_tokens: int = 32
    greedy: bool = True
    temperature: float = 1.0


@dataclasses.dataclass
class ServeStats:
    prefill_s: float
    decode_s: float
    tokens_generated: int

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.decode_s, 1e-9)


def _quantizable(path: str, leaf) -> bool:
    if not isinstance(leaf, torch.Tensor) or leaf.ndim not in (2, 3):
        return False
    k, n = leaf.shape[-2:]     # 3-D = layer-stacked (L, K, N)
    if k < _MIN_QUANT_DIM or n < _MIN_QUANT_DIM or k % 4:
        return False
    # Never the embedding table (a gather) or the LM head (kept full
    # precision, as CUTIE keeps its classifier); every other (K, N) leaf
    # is a product weight that goes through layers.dense().
    return "embed" not in path and "lm_head" not in path


def _pack(leaf: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack a (K, N) or layer-stacked (L, K, N) weight, one layer at a
    time, on the leaf's device."""
    if leaf.ndim == 2:
        return pack_ternary_weights(leaf.float())
    parts = [pack_ternary_weights(w.float()) for w in leaf]
    return (torch.stack([p for p, _ in parts]),
            torch.stack([s for _, s in parts]))


def quantize_for_serving(params: Any) -> Tuple[Any, Dict[str, int]]:
    """Convert eligible weight matrices to {"packed","scale"} leaves.

    Returns (new params, stats {quantized, kept, bytes_before,
    bytes_after}); the leaves that stay are the same tensors.
    """
    stats = {"quantized": 0, "kept": 0, "bytes_before": 0, "bytes_after": 0}

    def walk(tree, prefix=""):
        if isinstance(tree, dict):
            if "packed" in tree:
                return tree
            return {k: walk(v, f"{prefix}/{k}") for k, v in tree.items()}
        leaf = tree
        nbytes = leaf.numel() * leaf.element_size()
        if _quantizable(prefix, leaf):
            packed, scale = _pack(leaf)
            stats["quantized"] += 1
            stats["bytes_before"] += nbytes
            stats["bytes_after"] += packed.numel() + scale.numel() * 4
            return {"packed": packed, "scale": scale}
        stats["kept"] += 1
        stats["bytes_before"] += nbytes
        stats["bytes_after"] += nbytes
        return leaf

    return walk(params), stats


def generate(
    model: Model,
    params: Any,
    prompts,                          # (B, S_prompt) int token ids
    cfg: ServeConfig = ServeConfig(),
    *,
    cache_len: Optional[int] = None,
    generator: Optional[torch.Generator] = None,
    device=None,
) -> Tuple[np.ndarray, ServeStats]:
    """Prefill on the prompt, then decode ``max_new_tokens`` tokens.

    Runs on ``device`` (the card by default), where ``params`` must lie.
    Sampling (``cfg.greedy=False``) draws from ``generator``, a
    ``torch.Generator`` on that device. Returns ((B, max_new_tokens)
    int32 tokens, stats).
    """
    dev = resolve_device(device)
    prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.long,
                              device=dev)
    b, s_prompt = prompts.shape
    total = (cache_len or (s_prompt + cfg.max_new_tokens))
    if not cfg.greedy and generator is None:
        raise ValueError("sampling needs a torch.Generator")

    t0 = time.perf_counter()
    cache = model.init_cache(b, total, device=dev)
    # Prefill by stepping the decoder over the prompt (cache-correct for
    # every family; a fused prefill is a serving optimization).
    logits = None
    for i in range(s_prompt):
        logits, cache = model.decode(params, cache, prompts[:, i:i + 1])
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t1 = time.perf_counter()

    out = []
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    for _ in range(cfg.max_new_tokens):
        out.append(tok)
        logits, cache = model.decode(params, cache, tok)
        if cfg.greedy:
            tok = torch.argmax(logits[:, -1], dim=-1)
        else:
            probs = torch.softmax(logits[:, -1] / cfg.temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        tok = tok[:, None]
    tokens = torch.cat(out, dim=1).to(torch.int32).cpu().numpy()
    t2 = time.perf_counter()
    return tokens, ServeStats(prefill_s=t1 - t0, decode_s=t2 - t1,
                              tokens_generated=int(tokens.size))
