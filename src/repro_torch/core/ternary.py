"""Ternary weight quantization and 2-bit packing: the CUTIE wing's format.

Port of ``repro.core.ternary``:

  * TWN-style quantization: per-output-channel threshold
    ``delta = 0.7 * mean|W|``, ternarize, per-channel scale = mean ``|W|``
    over the surviving weights;
  * 2-bit packing, 4 weights per byte, the storage format kernel K3
    (``kernels/ternary_matmul``) consumes.

The two means are :func:`pairwise_sum` trees of elementwise adds in
float64, divided by their count and rounded to the weight's dtype once,
not reduction kernels: the card then packs the same bytes as the CPU (a
CUDA reduction sums in another order, and a weight at the threshold
would flip). In float64 the tree's rounding stays far below a float32
ulp, so the mean is in practice the correctly rounded one, and agrees
with the reference's float32 reduction wherever that one is correctly
rounded too. The mask count is an exact integer sum.

``ternary_ste`` is the fake-quantized ``q * scale`` with a
straight-through gradient (QAT).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

__all__ = ["ternarize", "ternary_ste", "pack2bit", "unpack2bit",
           "pairwise_sum",
           "TERNARY_DELTA_FACTOR"]

TERNARY_DELTA_FACTOR = 0.7  # TWN threshold heuristic


def pairwise_sum(a: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in a fixed order: pad with zeros to a power
    of two, then add the two halves elementwise until one value is left.
    The same bits on every device and whatever the other axes hold."""
    count = a.shape[-1]
    width = 1 << max(count - 1, 0).bit_length()
    if width > count:
        a = F.pad(a, (0, width - count))
    while a.shape[-1] > 1:
        half = a.shape[-1] // 2
        a = a[..., :half] + a[..., half:]
    return a[..., 0]


def ternarize(w: torch.Tensor, axis: Optional[int] = -1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ternarize weights. Returns ``(q, scale)`` with ``q`` in {-1, 0, +1}
    int8 and ``scale`` in ``w``'s dtype.

    ``axis`` is the output-channel axis (per-channel scale, kept as a
    size-1-elsewhere tensor); ``None`` gives one per-tensor scale. The
    means are float64 :func:`pairwise_sum` trees over each channel's
    weights divided by their count, then cast to ``w``'s dtype.
    """
    absw = w.abs()
    if axis is None:
        rows, keep = absw.reshape(1, -1), ()
    else:
        ax = axis % w.ndim
        rows = absw.movedim(ax, 0).reshape(w.shape[ax], -1)
        keep = [1] * w.ndim
        keep[ax] = -1
    mean = (pairwise_sum(rows.double()) / rows.shape[1]).to(w.dtype)
    delta = (TERNARY_DELTA_FACTOR * mean).reshape(keep)
    mask = absw > delta
    row_mask = rows > delta.reshape(-1, 1)                # mask, as rows
    denom = row_mask.sum(dim=1).clamp(min=1)              # exact integers
    scale = pairwise_sum(torch.where(row_mask, rows, 0.0).double()) / denom
    q = torch.where(mask, torch.sign(w), 0.0).to(torch.int8)
    return q, scale.reshape(keep).to(w.dtype)


class _TernarySTE(torch.autograd.Function):

    @staticmethod
    def forward(ctx, w):
        q, scale = ternarize(w)
        return q.to(w.dtype) * scale

    @staticmethod
    def backward(ctx, g):
        return g  # straight-through


def ternary_ste(w: torch.Tensor) -> torch.Tensor:
    """Fake-quantized ternary weights (per-channel ``q * scale`` over the
    last axis) with straight-through gradients (QAT)."""
    return _TernarySTE.apply(w)


def pack2bit(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 ternary values {-1, 0, 1} 4 per byte along the LAST axis.

    Encoding: value + 1 in {0, 1, 2}, 2 bits each, little-endian within the
    byte. The last axis must be a multiple of 4; it shrinks 4x.
    """
    if q.shape[-1] % 4 != 0:
        raise ValueError(f"last axis {q.shape[-1]} not a multiple of 4")
    enc = (q.to(torch.int32) + 1).reshape(*q.shape[:-1], q.shape[-1] // 4, 4)
    packed = (enc[..., 0] | (enc[..., 1] << 2) | (enc[..., 2] << 4)
              | (enc[..., 3] << 6))
    return packed.to(torch.uint8)


def unpack2bit(packed: torch.Tensor, *,
               out_dtype: torch.dtype = torch.int8) -> torch.Tensor:
    """Inverse of :func:`pack2bit`: uint8 -> ternary values, last axis x4."""
    p = packed.to(torch.int32)
    enc = torch.stack([(p >> (2 * i)) & 0x3 for i in range(4)], dim=-1)
    q = enc - 1
    return q.reshape(*packed.shape[:-1], packed.shape[-1] * 4).to(out_dtype)
