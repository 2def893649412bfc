"""Ternary weight quantization and 2-bit packing: the CUTIE wing's format.

Port of ``repro.core.ternary``:

  * TWN-style quantization: per-output-channel threshold
    ``delta = 0.7 * mean|W|``, ternarize, per-channel scale = mean ``|W|``
    over the surviving weights;
  * 2-bit packing, 4 weights per byte, the storage format kernel K3
    (``kernels/ternary_matmul``) consumes.

``ternary_ste`` (straight-through QAT) waits for the training slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ternarize", "pack2bit", "unpack2bit", "TERNARY_DELTA_FACTOR"]

TERNARY_DELTA_FACTOR = 0.7  # TWN threshold heuristic


def ternarize(w: torch.Tensor, axis: Optional[int] = -1
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ternarize weights. Returns ``(q, scale)`` with ``q`` in {-1, 0, +1}
    int8 and ``scale`` in ``w``'s dtype.

    ``axis`` is the output-channel axis (per-channel scale, kept as a
    size-1-elsewhere tensor); ``None`` gives one per-tensor scale.
    """
    absw = w.abs()
    if axis is None:
        delta = TERNARY_DELTA_FACTOR * absw.mean()
        mask = absw > delta
        denom = mask.sum().clamp(min=1)
        scale = torch.where(mask, absw, 0.0).sum() / denom
    else:
        dims = tuple(i for i in range(w.ndim) if i != axis % w.ndim)
        delta = TERNARY_DELTA_FACTOR * absw.mean(dim=dims, keepdim=True)
        mask = absw > delta
        denom = mask.sum(dim=dims, keepdim=True).clamp(min=1)
        scale = torch.where(mask, absw, 0.0).sum(dim=dims,
                                                 keepdim=True) / denom
    q = torch.where(mask, torch.sign(w), 0.0).to(torch.int8)
    return q, scale.to(w.dtype)


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
