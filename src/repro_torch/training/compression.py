"""Gradient compression for the cross-pod all-reduce (port of
``repro.training.compression``).

Top-k magnitude sparsification with error feedback (Deep Gradient
Compression style): each step transmits only the largest ``ratio`` of
gradient entries per leaf; the residual is accumulated locally and added
back next step, so the compressed optimizer tracks the dense one.

A leaf's threshold is its k-th largest |acc|, ``k = max(int(size *
ratio), 1)``, and every entry with |acc| >= threshold is sent, ties
included: the masks are the JAX package's. The threshold is the least of
``torch.topk``'s k values (unsorted: the set is what matters), which is
the k-th largest whatever order ties take. Nothing reads a value back to
the host.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.training.optimizer import tree_leaves, tree_map

__all__ = ["compression_init", "compress_grads"]


def compression_init(grads_like: Any) -> Any:
    """Zero f32 error-feedback buffers matching the gradient tree, on each
    leaf's device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _topk_mask(x: torch.Tensor, ratio: float) -> torch.Tensor:
    k = max(int(x.numel() * ratio), 1)
    flat = torch.abs(x.reshape(-1))
    thresh = torch.topk(flat, k, sorted=False).values.min()  # k-th largest
    return (torch.abs(x) >= thresh).to(x.dtype)


def compress_grads(
    grads: Any, error_state: Any, *, ratio: float = 0.01
) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """Sparsify grads to top-``ratio`` entries with error feedback.

    Returns (compressed grads -- dense tensors with zeros off-mask, in
    each gradient's dtype; the new f32 error state; metrics). ``acc =
    grad + error``; sent is ``acc * mask`` and the residual ``acc -
    sent``, so in f32 sent + residual is ``acc`` exactly.
    """
    def one(g, e):
        acc = g.float() + e
        sent = acc * _topk_mask(acc, ratio)
        return sent.to(g.dtype), acc - sent

    outs = tree_map(one, grads, error_state)
    pick = lambda i: tree_map(lambda g, o: o[i], grads, outs)
    sent, resid = pick(0), pick(1)
    sent_norm = torch.sqrt(sum(torch.sum(torch.square(s.float()))
                               for s in tree_leaves(sent)))
    return sent, resid, {"compressed_grad_norm": sent_norm}
