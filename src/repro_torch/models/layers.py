"""Shared neural layers (port of ``repro.models.layers``), as far as
RWKV-6 needs them: ``layer_norm`` and ``dense``.

Attention, RoPE/M-RoPE, the MLPs and MoE come with the transformer
families (ROADMAP queue 1, item 13).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.kernels import ops

__all__ = ["layer_norm", "dense"]


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm as the JAX package computes it: statistics and the
    normalisation in f32, a cast to ``x``'s dtype, then the scale and bias
    in that dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def dense(x: torch.Tensor, w: Any, role: str = "up") -> torch.Tensor:
    """``x @ w`` against a float (K, N) weight or a ternary-packed dict.

    A ``{"packed": (K//4, N) uint8, "scale": (N,)}`` weight is the CUTIE
    serving format: ``x``'s rows go through kernel K3
    (``kernels.ops.ternary_matmul``: in-kernel unpacking, an f32 sum in
    ascending k within each 512-k segment and over the segments in
    ascending order, then the scale) and comes back in ``x``'s dtype.
    A float weight is a library matmul, as the JAX package leaves it to
    XLA. ``role`` (the tensor-parallel orientation in the JAX package) is
    accepted and ignored: there is no mesh.
    """
    del role
    if isinstance(w, dict) and "packed" in w:
        return ops.ternary_matmul(x, w["packed"], w["scale"])
    return torch.matmul(x, w)
