"""K4: the RWKV-6 WKV recurrence, as a CUDA kernel for Hopper.

Replaces ``wkv6_scan_pallas`` (``repro/kernels/wkv6_scan.py``), which
keeps a block of per-head ``hd x hd`` states in VMEM scratch across a
sequential T grid axis after transposing r/k/v/logw to (T, B*H, hd). Here
one CUDA block owns one (b, h) for the whole sequence, thread ``j`` holds
column ``j`` of the f32 state in registers, and the (B, T, H, hd) inputs
are read in place (``csrc/wkv6_scan.cu``). ``block_t``/``block_bh`` are
VMEM-budget choices with no Hopper meaning and are not ported.

    o_t = r_t (S + diag(u) k_t v_t^T)
    S  <- diag(exp(logw_t)) S + k_t v_t^T          (S starts at state0 or 0)

``r, k, v`` (B, T, H, hd) and ``u`` (H, hd) are all f32 or all bf16;
``logw`` (B, T, H, hd) is f32 or ``r``'s dtype; ``state0`` (B, H, hd, hd)
f32 or None. Returns ``o`` (B, T, H, hd) in ``r``'s dtype and the final
f32 state. hd is 16, 32 or 64. Each output is an f32 sum over i in
ascending order, each multiply and add rounded on its own:
:func:`wkv6_scan_plain` repeats that arithmetic, so the kernel equals it
bit for bit on the card. :func:`wkv6_scan_fwd` picks between the two by
the tensor's device alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels._build import load_library

__all__ = ["wkv6_scan_cuda", "wkv6_scan_plain", "wkv6_scan_fwd",
           "launches", "KERNEL", "HEAD_DIMS"]

KERNEL = "wkv6_scan"

# Launches of the CUDA kernel since import (or since a caller reset it to
# 0). Only wkv6_scan_cuda adds to it, once per launch.
launches = 0

HEAD_DIMS = (16, 32, 64)
# (dtype of r/k/v/u, dtype of logw) -> exported C function.
_FN = {(torch.float32, torch.float32): "wkv6_scan_f32",
       (torch.bfloat16, torch.bfloat16): "wkv6_scan_bf16",
       (torch.bfloat16, torch.float32): "wkv6_scan_bf16_lwf32"}


def _fn(name: str):
    fn = getattr(load_library(KERNEL), name)
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(r, k, v, logw, u, state0):
    if r.ndim != 4:
        raise ValueError(f"need (B, T, H, hd) r, got {tuple(r.shape)}")
    b, _, h, hd = r.shape
    for name, x in (("k", k), ("v", v), ("logw", logw)):
        if x.shape != r.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != r shape "
                             f"{tuple(r.shape)}")
    if u.shape != (h, hd):
        raise ValueError(f"u shape {tuple(u.shape)} != (H, hd) = {(h, hd)}")
    if state0 is not None and state0.shape != (b, h, hd, hd):
        raise ValueError(f"state0 shape {tuple(state0.shape)} != "
                         f"(B, H, hd, hd) = {(b, h, hd, hd)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} not supported; the kernel is built "
                         f"for hd in {HEAD_DIMS}")


def wkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor,
                    state0: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: steps over t and over i in ascending order,
    vectorised over (b, h, j), with the kernel's operations in its
    order."""
    _check(r, k, v, logw, u, state0)
    b, t, h, hd = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    uf = u.float()
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float().clone())
    o = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    for step in range(t):
        r_t, k_t, v_t, w_t = rf[:, step], kf[:, step], vf[:, step], \
            wf[:, step]                                  # (b, h, hd)
        acc = torch.zeros((b, h, hd), dtype=torch.float32, device=r.device)
        for i in range(hd):
            kv = k_t[..., i, None] * v_t                 # (b, h, hd_j)
            s_i = s[:, :, i]
            acc = acc + r_t[..., i, None] * (s_i + uf[:, i, None] * kv)
            s[:, :, i] = w_t[..., i, None] * s_i + kv
        o[:, step] = acc
    return o.to(r.dtype), s


def wkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on contiguous tensors of one CUDA device. Returns
    ``(o, state)`` queued on the current stream (no synchronisation)."""
    global launches
    name = _FN.get((r.dtype, logw.dtype))
    if name is None:
        raise TypeError(f"wkv6_scan_cuda takes float32 or bfloat16 r/k/v/u "
                        f"with float32 logw or logw in r's dtype, got r "
                        f"{r.dtype} and logw {logw.dtype}")
    for nm, x in (("k", k), ("v", v), ("u", u)):
        if x.dtype != r.dtype:
            raise TypeError(f"{nm} dtype {x.dtype} != r dtype {r.dtype}")
    if state0 is not None and state0.dtype != torch.float32:
        raise TypeError(f"state0 must be float32, got {state0.dtype}")
    _check(r, k, v, logw, u, state0)
    ins = (r, k, v, logw, u) + (() if state0 is None else (state0,))
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("wkv6_scan_cuda needs contiguous tensors")
    if not r.is_cuda or any(x.device != r.device for x in ins):
        raise ValueError(f"wkv6_scan_cuda needs CUDA tensors on one device, "
                         f"got r on {r.device}")
    b, t, h, hd = r.shape
    o = torch.empty_like(r)
    state = torch.empty((b, h, hd, hd), dtype=torch.float32, device=r.device)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _fn(name)(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                       logw.data_ptr(), u.data_ptr(),
                       None if state0 is None else state0.data_ptr(),
                       o.data_ptr(), state.data_ptr(), b, t, h, hd, stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return o, state


def wkv6_scan_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor,
                  state0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors, its plain version on CPU tensors."""
    if r.is_cuda:
        return wkv6_scan_cuda(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return wkv6_scan_plain(r, k, v, logw, u, state0)
    raise ValueError(f"unsupported device {r.device}")
