"""K1: the fused LIF temporal scan, as a CUDA kernel for Hopper.

Replaces ``lif_scan_pallas`` (``repro/kernels/lif_scan.py``), which keeps
the membrane in VMEM scratch while currents stream through in
(T-chunk, 128-lane row) blocks. Here one CUDA thread owns one neuron
and keeps its membrane in a register for all T steps
(``csrc/lif_scan.cu``). The scan is bound by device memory, about
``2*T*N*esize`` bytes, and neighbouring threads touch neighbouring
addresses so every access coalesces: a thread issues the loads of a
whole time chunk of ``TC`` steps before it runs the chunk's recurrence,
so it waits one round trip a chunk. ``choose_blocks`` (a VMEM-budget
chooser) has no Hopper meaning and is not ported.

:func:`lif_scan_cuda` launches the kernel; :func:`lif_scan_plain` is the
same function in plain PyTorch, each operation rounded on its own, and
gives the kernel's bits. :func:`lif_scan_fwd` picks between them by the
tensor's device alone.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.lif import LIFParams
from repro_torch.kernels._build import load_library

__all__ = ["lif_scan_cuda", "lif_scan_plain", "lif_scan_fwd", "lif_loop",
           "launches", "KERNEL", "TC", "TAIL", "THREADS"]

KERNEL = "lif_scan"

# Launches of the CUDA kernel since import (or since a caller reset it to
# 0). Only lif_scan_cuda adds to it, once per launch.
launches = 0

# The kernel's geometry, as csrc/lif_scan.cu lays it out (checked against
# its lif_scan_geometry when the library loads): steps a chunk, steps a
# chunk of the last T % TC, threads a block. tools/k1_probe.py timed the
# variants on the H100.
TC = 16
TAIL = 4
THREADS = 256

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    lib = load_library(KERNEL)
    geometry = (ctypes.c_int * 3)()
    lib.lif_scan_geometry(geometry)
    if tuple(geometry) != (TC, TAIL, THREADS):
        raise RuntimeError(
            f"csrc/lif_scan.cu's (TC, TAIL, THREADS) {tuple(geometry)} "
            f"differ from the wrapper's {(TC, TAIL, THREADS)}")
    fn = getattr(lib, f"lif_scan_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def lif_loop(cur_f32: torch.Tensor, p: LIFParams,
             v0: Optional[torch.Tensor],
             out_dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The LIF recurrence over f32 currents (T, ...), plain PyTorch.

    ``v = alpha * v * live + cur`` with every operation rounded on its
    own, which is the kernels' arithmetic. Shared by the plain versions of
    K1 and K2.
    """
    v = (torch.zeros(cur_f32.shape[1:], dtype=torch.float32,
                     device=cur_f32.device)
         if v0 is None else v0.float())
    spikes = torch.empty(cur_f32.shape, dtype=out_dtype,
                         device=cur_f32.device)
    # The constants as f32 values, as the kernels receive them.
    alpha = torch.full((), p.alpha, dtype=torch.float32, device=v.device)
    v_th = torch.full((), p.v_th, dtype=torch.float32, device=v.device)
    for t in range(cur_f32.shape[0]):
        live = (v < v_th).float()
        v = alpha * v * live + cur_f32[t]
        spikes[t] = (v >= v_th).to(out_dtype)
    return spikes, v.to(out_dtype)


def lif_scan_plain(currents: torch.Tensor, p: LIFParams,
                   v0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plain version: (T, ...) currents -> (spikes, v_final)."""
    return lif_loop(currents.float(), p, v0, currents.dtype)


def lif_scan_cuda(currents: torch.Tensor, p: LIFParams,
                  v0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on ``currents`` (T, ...), a contiguous f32 or bf16 CUDA
    tensor; ``v0`` is an optional membrane of shape ``currents.shape[1:]``.
    Returns ``(spikes, v_final)`` in the currents' dtype, queued on the
    device's current stream (no synchronisation). The event wing makes
    two calls a step, so the host work is kept to checks and two
    ``torch.empty``."""
    global launches
    if currents.dtype not in _SUFFIX:
        raise TypeError(f"lif_scan_cuda takes float32 or bfloat16 currents, "
                        f"got {currents.dtype}")
    if currents.ndim < 1 or not currents.is_contiguous():
        raise ValueError("lif_scan_cuda needs contiguous (T, ...) currents")
    feat = currents.shape[1:]
    if v0 is not None:
        if v0.shape != feat:
            raise ValueError(f"v0 shape {tuple(v0.shape)} != currents "
                             f"shape[1:] {tuple(feat)}")
        if not v0.is_floating_point():
            raise TypeError(f"v0 must be floating point, got {v0.dtype}")
    idx = currents.get_device()
    if idx < 0 or (v0 is not None and v0.get_device() != idx):
        raise ValueError(f"lif_scan_cuda needs CUDA tensors on one device, "
                         f"got currents on {currents.device}")
    if v0 is not None:
        v0 = v0.to(torch.float32).contiguous()
    spikes = torch.empty_like(currents)
    v_fin = torch.empty(feat, dtype=currents.dtype, device=currents.device)
    args = (currents.data_ptr(), None if v0 is None else v0.data_ptr(),
            spikes.data_ptr(), v_fin.data_ptr(), feat.numel(),
            currents.shape[0], float(p.alpha), float(p.v_th),
            torch.cuda.current_stream(idx).cuda_stream)
    if idx == torch.cuda.current_device():
        rc = _fn(currents.dtype)(*args)
    else:
        with torch.cuda.device(idx):
            rc = _fn(currents.dtype)(*args)
    if rc != 0:
        raise RuntimeError(f"lif_scan kernel launch failed: CUDA error {rc}")
    launches += 1
    return spikes, v_fin


def lif_scan_fwd(currents: torch.Tensor, p: LIFParams,
                 v0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1 on a CUDA tensor, its plain version on a CPU tensor."""
    if currents.is_cuda:
        return lif_scan_cuda(currents, p, v0)
    if currents.device.type == "cpu":
        return lif_scan_plain(currents, p, v0)
    raise ValueError(f"unsupported device {currents.device}")
