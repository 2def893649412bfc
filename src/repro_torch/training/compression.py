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

Over a process mesh (``specs`` given) each rank holds a block of each
leaf; the threshold is still the whole leaf's: the blocks' |acc| are
gathered over the leaf's axes, so every rank sends exactly the entries
the one-device mask sends, ties included. The specs never name ``pod``:
the grads come summed over it (``trainer.reduce_grads``), the same on
every pod, as the JAX package compresses the whole gradient.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.distributed import collectives as C
from repro_torch.training.optimizer import global_norm, tree_map

__all__ = ["compression_init", "compress_grads"]


def compression_init(grads_like: Any) -> Any:
    """Zero f32 error-feedback buffers matching the gradient tree, on each
    leaf's device."""
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def _topk_mask(x: torch.Tensor, ratio: float, spec=None) -> torch.Tensor:
    whole = torch.abs(x)
    for dim, e in enumerate(spec or ()):
        for a in reversed((e,) if isinstance(e, str) else (e or ())):
            whole = C.gather_dim(whole, dim, a)
    k = max(int(whole.numel() * ratio), 1)
    thresh = torch.topk(whole.reshape(-1), k, sorted=False).values.min()
    return (torch.abs(x) >= thresh).to(x.dtype)          # k-th largest


def compress_grads(
    grads: Any, error_state: Any, *, ratio: float = 0.01, specs: Any = None
) -> Tuple[Any, Any, Dict[str, torch.Tensor]]:
    """Sparsify grads to top-``ratio`` entries with error feedback.

    Returns (compressed grads -- dense tensors with zeros off-mask, in
    each gradient's dtype; the new f32 error state; metrics). ``acc =
    grad + error``; sent is ``acc * mask`` and the residual ``acc -
    sent``, so in f32 sent + residual is ``acc`` exactly. ``specs``: the
    grads' spec tree when they are blocks over a process mesh.
    """
    def one(g, e, s=None):
        acc = g.float() + e
        sent = acc * _topk_mask(acc, ratio, s if C.active() else None)
        return sent.to(g.dtype), acc - sent

    outs = (tree_map(one, grads, error_state) if specs is None
            else tree_map(one, grads, error_state, specs))
    pick = lambda i: tree_map(lambda g, o: o[i], grads, outs)
    sent, resid = pick(0), pick(1)
    return sent, resid, {"compressed_grad_norm": global_norm(sent, specs)}
