"""K2: fused synapse (``spikes @ W``) + LIF scan, as a CUDA kernel, and the
same current sum on its own.

Replaces ``fc_lif_scan_pallas`` (``repro/kernels/fc_lif_scan.py``), which
keeps the weight panel and the membrane plane in VMEM across the temporal
scan so the (T, B, N) currents never reach HBM. Here each block owns whole
T chunks of a few batch rows and a strip of outputs: it stages K chunks of
spikes and weights into shared memory with ``cp.async``, four deep, sums
them into small register tiles, and runs the LIF update over the chunk's
currents from shared memory (``csrc/fc_lif_scan.cu``).

Each current is defined as an fp32 sum over k in ascending order, every
product and add rounded on its own (:func:`fc_currents_plain`). The kernel
and its plain version follow that order, so they agree bit for bit, and a
stream's rows never depend on the batch around it. The order rules out
splitting K and the tensor cores, so the parallelism is the (t, b, n)
outputs; at fc1 (B=8, T=16, 2048 -> 512) they fill the card only at four
a thread, one warp a scheduler, and that warp's stalls on its
shared-memory loads and barriers hold it to about 0.6 instructions a
cycle (``tools/k2_probe.py``).

:func:`fc_currents` is that sum without the LIF: on a CUDA tensor one
launch of the source's ``fc_currents`` entry, on a CPU tensor the loop.
The frame wing's fc2 calls it. ``choose_fc_blocks`` (a VMEM-budget
chooser) has no Hopper meaning and is not ported.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.core.lif import LIFParams
from repro_torch.kernels._build import load_library
from repro_torch.kernels.lif_scan import lif_loop

__all__ = ["fc_lif_scan_cuda", "fc_lif_scan_plain", "fc_lif_scan_fwd",
           "fc_currents", "fc_currents_cuda", "fc_currents_plain",
           "launches", "currents_launches", "KERNEL"]

KERNEL = "fc_lif_scan"

# Launches since import (or since a caller reset them to 0): of the fused
# kernel, only by fc_lif_scan_cuda, and of the currents entry, only by
# fc_currents_cuda; once per launch each.
launches = 0
currents_launches = 0

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _fn(dtype: torch.dtype):
    lib = load_library(KERNEL)
    fn = getattr(lib, f"fc_lif_scan_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _currents_fn():
    lib = load_library(KERNEL)
    fn = lib.fc_currents_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_weights(spikes, w):
    if w.ndim != 2 or w.shape[0] != spikes.shape[-1]:
        raise ValueError(f"weights {tuple(w.shape)} do not match spikes K="
                         f"{spikes.shape[-1]}")


def _check_cuda_operands(name, spikes, w):
    if spikes.dtype not in _SUFFIX:
        raise TypeError(f"{name} takes float32 or bfloat16 spikes, got "
                        f"{spikes.dtype}")
    if w.dtype != torch.float32:
        raise TypeError(f"{name} takes float32 weights, got {w.dtype}")


def fc_currents_plain(spikes: torch.Tensor, w: torch.Tensor
                      ) -> torch.Tensor:
    """``spikes @ w`` as the port defines it: an f32 sum over k in
    ascending order, each product and add rounded on its own.

    ``spikes`` (..., K), ``w`` (K, N) -> (..., N) float32. This order is
    what K2 computes; a library matmul sums in another order and is not
    row-invariant across batch sizes.
    """
    _check_weights(spikes, w)
    s = spikes.float()
    w = w.float()
    acc = torch.zeros((*s.shape[:-1], w.shape[1]), dtype=torch.float32,
                      device=s.device)
    for k in range(w.shape[0]):
        acc = acc + s[..., k, None] * w[k]
    return acc


def fc_currents_cuda(spikes: torch.Tensor, w: torch.Tensor
                     ) -> torch.Tensor:
    """Launch K2's currents entry: contiguous f32 ``spikes`` (..., K) and
    contiguous f32 ``w`` (K, N) on one CUDA device -> (..., N) float32,
    queued on the current stream."""
    global currents_launches
    if spikes.dtype != torch.float32:
        raise TypeError(f"fc_currents_cuda takes float32 spikes, got "
                        f"{spikes.dtype}")
    _check_cuda_operands("fc_currents_cuda", spikes, w)
    _check_weights(spikes, w)
    if not (spikes.is_contiguous() and w.is_contiguous()):
        raise ValueError("fc_currents_cuda needs contiguous spikes and w")
    if not spikes.is_cuda or w.device != spikes.device:
        raise ValueError(f"fc_currents_cuda needs CUDA tensors on one "
                         f"device, got spikes on {spikes.device}")
    k, n = w.shape
    m = math.prod(spikes.shape[:-1])
    out = torch.empty((*spikes.shape[:-1], n), dtype=torch.float32,
                      device=spikes.device)
    with torch.cuda.device(spikes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _currents_fn()(
            spikes.data_ptr(), w.data_ptr(), out.data_ptr(), m, k, n, stream)
    if rc != 0:
        raise RuntimeError(f"fc_currents kernel launch failed: CUDA error "
                           f"{rc}")
    currents_launches += 1
    return out


def fc_currents(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ascending-k currents ``spikes @ w`` (see
    :func:`fc_currents_plain`): K2's currents entry on CUDA tensors, the
    plain loop on CPU tensors."""
    if spikes.is_cuda:
        return fc_currents_cuda(spikes.contiguous(), w.contiguous())
    if spikes.device.type == "cpu":
        return fc_currents_plain(spikes, w)
    raise ValueError(f"unsupported device {spikes.device}")


def _check_shapes(spikes, w, v0):
    if spikes.ndim not in (2, 3):
        raise ValueError(f"need (T, B, K) or (T, K) spikes, got "
                         f"{tuple(spikes.shape)}")
    _check_weights(spikes, w)
    want = (*spikes.shape[1:-1], w.shape[1])
    if v0 is not None and tuple(v0.shape) != want:
        raise ValueError(f"v0 shape {tuple(v0.shape)} != {want}")


def fc_lif_scan_plain(spikes: torch.Tensor, w: torch.Tensor, p: LIFParams,
                      v0: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2's plain version: ascending-k currents, then the LIF loop.

    ``spikes`` (T, B, K) or (T, K); ``w`` (K, N); ``v0`` (B, N) or (N,).
    Returns (out_spikes, v_final) in the spikes' dtype.
    """
    _check_shapes(spikes, w, v0)
    return lif_loop(fc_currents_plain(spikes, w), p, v0, spikes.dtype)


def fc_lif_scan_cuda(spikes: torch.Tensor, w: torch.Tensor, p: LIFParams,
                     v0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K2: contiguous f32 or bf16 ``spikes`` (T, B, K) or (T, K) and
    contiguous f32 ``w`` (K, N) on one CUDA device; ``v0`` optional
    (B, N) or (N,). Returns (out_spikes, v_final) in the spikes' dtype,
    queued on the current stream (no synchronisation)."""
    global launches
    _check_cuda_operands("fc_lif_scan_cuda", spikes, w)
    _check_shapes(spikes, w, v0)
    if not (spikes.is_contiguous() and w.is_contiguous()):
        raise ValueError("fc_lif_scan_cuda needs contiguous spikes and w")
    if v0 is not None and not v0.is_floating_point():
        raise TypeError(f"v0 must be floating point, got {v0.dtype}")
    if not spikes.is_cuda or w.device != spikes.device or (
            v0 is not None and v0.device != spikes.device):
        raise ValueError(f"fc_lif_scan_cuda needs CUDA tensors on one "
                         f"device, got spikes on {spikes.device}")
    if v0 is not None:
        v0 = v0.to(torch.float32).contiguous()
    t, k = spikes.shape[0], spikes.shape[-1]
    b = spikes.shape[1] if spikes.ndim == 3 else 1
    n = w.shape[1]
    out = torch.empty((*spikes.shape[:-1], n), dtype=spikes.dtype,
                      device=spikes.device)
    v_fin = torch.empty((*spikes.shape[1:-1], n), dtype=spikes.dtype,
                        device=spikes.device)
    with torch.cuda.device(spikes.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(spikes.dtype)(
            spikes.data_ptr(), w.data_ptr(),
            None if v0 is None else v0.data_ptr(), out.data_ptr(),
            v_fin.data_ptr(), t, b, k, n, float(p.alpha), float(p.v_th),
            stream)
    if rc != 0:
        raise RuntimeError(f"fc_lif_scan kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out, v_fin


def fc_lif_scan_fwd(spikes: torch.Tensor, w: torch.Tensor, p: LIFParams,
                    v0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2 on CUDA tensors, its plain version on CPU tensors."""
    if spikes.is_cuda:
        return fc_lif_scan_cuda(spikes, w, p, v0)
    if spikes.device.type == "cpu":
        return fc_lif_scan_plain(spikes, w, p, v0)
    raise ValueError(f"unsupported device {spikes.device}")
