"""K3: packed-ternary matmul, as a CUDA kernel for Hopper.

Replaces ``ternary_matmul_pallas`` (``repro/kernels/ternary_matmul.py``),
which unpacks 2-bit weight tiles in VMEM and feeds the MXU with an f32
accumulator carried across a sequential K grid axis. Here each CUDA
thread owns one output column for a block of 4 rows of ``x`` and walks K
in ascending order with the accumulators in registers, the x and weight
chunks staged in shared memory (``csrc/ternary_matmul.cu``). At the frame
wing's fc1 (M = 8, K = 2048, N = 512) it is bound by latency and launch,
not by bytes or operations. ``choose_blocks_tmm`` (a VMEM-budget chooser)
has no Hopper meaning and is not ported.

    out = (x @ unpack2bit(w_packed)) * scale

``x`` (M, K) f32 or bf16; ``w_packed`` (K/4, N) uint8, byte ``j`` holding
k = 4j..4j+3 as 2-bit fields of value + 1; ``scale`` (N,) f32; ``out``
(M, N) in ``x``'s dtype. Each output is an f32 sum over k in ascending
order, each product and add rounded on its own, then one multiply by the
scale: :func:`ternary_matmul_plain` repeats that arithmetic, so the kernel
equals it bit for bit for any finite ``x``, and a row never depends on the
rows around it. :func:`ternary_matmul_fwd` picks between the two by the
tensor's device alone.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.ternary import unpack2bit
from repro_torch.kernels._build import load_library

__all__ = ["ternary_matmul_cuda", "ternary_matmul_plain",
           "ternary_matmul_fwd", "launches", "KERNEL"]

KERNEL = "ternary_matmul"

# Launches of the CUDA kernel since import (or since a caller reset it to
# 0). Only ternary_matmul_cuda adds to it, once per launch.
launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_M = 65_535 * 4             # grid.y limit x rows per block


def _fn(dtype: torch.dtype):
    lib = load_library(KERNEL)
    fn = getattr(lib, f"ternary_matmul_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w_packed, scale):
    if x.ndim != 2 or w_packed.ndim != 2:
        raise ValueError(f"need (M, K) x and (K/4, N) w_packed, got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    if w_packed.shape[0] * 4 != x.shape[1]:
        raise ValueError(f"w_packed rows {w_packed.shape[0]} != K/4 for "
                         f"K={x.shape[1]}")
    if scale.numel() != w_packed.shape[1]:
        raise ValueError(f"scale has {scale.numel()} values for N="
                         f"{w_packed.shape[1]}")


def ternary_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """K3's plain version: the ascending-k f32 sum, then the scale."""
    _check(x, w_packed, scale)
    wq = unpack2bit(w_packed.t(), out_dtype=torch.float32).t()  # (K, N)
    xf = x.float()
    acc = torch.zeros((x.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k in range(wq.shape[0]):
        acc = acc + xf[:, k, None] * wq[k]
    return (acc * scale.reshape(-1).float()).to(x.dtype)


def ternary_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch K3: contiguous f32 or bf16 ``x`` (M, K), uint8 ``w_packed``
    (K/4, N) and f32 ``scale`` (N,) on one CUDA device. Returns (M, N) in
    ``x``'s dtype, queued on the current stream (no synchronisation)."""
    global launches
    if x.dtype not in _SUFFIX:
        raise TypeError(f"ternary_matmul_cuda takes float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if w_packed.dtype != torch.uint8:
        raise TypeError(f"w_packed must be uint8, got {w_packed.dtype}")
    if scale.dtype != torch.float32:
        raise TypeError(f"scale must be float32, got {scale.dtype}")
    _check(x, w_packed, scale)
    if not (x.is_contiguous() and w_packed.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("ternary_matmul_cuda needs contiguous tensors")
    if not x.is_cuda or w_packed.device != x.device \
            or scale.device != x.device:
        raise ValueError(f"ternary_matmul_cuda needs CUDA tensors on one "
                         f"device, got x on {x.device}")
    m, k = x.shape
    n = w_packed.shape[1]
    if m > _MAX_M:
        raise ValueError(f"M={m} rows exceed the kernel's grid ({_MAX_M})")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(x.dtype)(x.data_ptr(), w_packed.data_ptr(),
                          scale.data_ptr(), out.data_ptr(), m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"ternary_matmul kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def ternary_matmul_fwd(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors."""
    if x.is_cuda:
        return ternary_matmul_cuda(x, w_packed, scale)
    if x.device.type == "cpu":
        return ternary_matmul_plain(x, w_packed, scale)
    raise ValueError(f"unsupported device {x.device}")
