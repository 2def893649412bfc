"""K3: packed-ternary matmul, as a CUDA kernel for Hopper.

Replaces ``ternary_matmul_pallas`` (``repro/kernels/ternary_matmul.py``),
which unpacks 2-bit weight tiles in VMEM and feeds the MXU with an f32
accumulator carried across a sequential K grid axis. ``choose_blocks_tmm``
(a VMEM-budget chooser) has no Hopper meaning and is not ported.

    out = (x @ unpack2bit(w_packed)) * scale

``x`` (..., K) f32 or bf16, its leading dims M rows; ``w_packed`` (K/4, N)
uint8, byte ``j`` holding k = 4j..4j+3 as 2-bit fields of value + 1;
``scale`` (N,) f32; ``out`` (..., N) in ``x``'s dtype.

The sum has a fixed order, which mirrors the TPU kernel's K tiling (its
``block_k`` is at most 512, and it adds one K tile's product into the
accumulator at a time, in ascending tile order): K is cut into segments
of :data:`KS` = 512 k, the last one possibly short; each segment's partial
is an f32 sum in ascending k from +0; the partials are added into an f32
accumulator in ascending segment order; the accumulator is multiplied by
the scale once. Each product and add is rounded on its own. For K <= 512
that is the plain ascending-k sum. :func:`ternary_matmul_plain` repeats
that arithmetic, so the kernel (``csrc/ternary_matmul.cu``) equals it bit
for bit for any finite ``x``, and a row never depends on the rows around
it. The order leaves the kernel free to sum the segments of one output in
parallel warps when there are few rows (:func:`plan`), with the same
bits. :func:`ternary_matmul_fwd` picks between kernel and plain version by
the tensor's device alone.

On a tensor without storage (meta, or a fake tensor of the dry run's
trace, ``launch.dryrun``) :func:`ternary_matmul_fwd` launches nothing: it
returns an empty output of the kernel's shape, dtype and device and adds
the call to :data:`shape_only_calls` and its FLOPs to
:data:`shape_only_flops`. A call counts ``2 * M * K * N``, the dense
product it stands for (one multiply and one add a term).
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.core.ternary import unpack2bit
from repro_torch.kernels._build import load_library

__all__ = ["ternary_matmul_cuda", "ternary_matmul_plain",
           "ternary_matmul_fwd", "ternary_matmul_shape_only", "plan",
           "launch_plan", "Plan", "launches", "shape_only_calls",
           "shape_only_flops", "KERNEL", "KS"]

KERNEL = "ternary_matmul"

# Launches of the CUDA kernel since import (or since a caller reset it to
# 0). Only ternary_matmul_cuda adds to it, once per launch.
launches = 0
# Calls on tensors without storage and their FLOPs (2 * M * K * N each),
# since import or since a caller reset them to 0. Only
# ternary_matmul_shape_only adds to them; no launch is made for them.
shape_only_calls = 0
shape_only_flops = 0

# k per segment of the sum. csrc/ternary_matmul.cu names the same
# constexpr KS: the two must agree, or the kernel and its plain version
# part bits.
KS = 512

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
# The kernel's geometry, as csrc/ternary_matmul.cu lays it out (checked
# against its ternary_matmul_geometry when the library loads): a warp's
# tile is R rows by _COLS columns; a split-path block is up to _MAX_WARPS
# warps on one tile, a serial-path block _SERIAL_WARPS tiles.
_COLS = 32
_MAX_WARPS = 16
_SERIAL_WARPS = 4
_MAX_BLOCKS = 2 ** 31 - 1
_SPLIT_MAX_SEGMENTS = 32        # a split block's shared memory stays < 227 KB
# The most rows the split path takes. tools/k3_probe.py (k3_paths) timed
# both paths at the rwkv6-7b products on an H100 80GB HBM3 at 700 W: the
# split path is 9-45% faster at M <= 48 and ties or wins at M = 64; from
# M = 96 the serial path is up to 16% faster (2.8% slower at K x N =
# 4096 x 14,336, M = 96).
_SPLIT_MAX_ROWS = 64
_H100_SMS = 132


class Plan(NamedTuple):
    """One launch of the kernel: ``rows`` R a thread, ``group`` segments
    a warp, ``warps`` a block, ``blocks`` in the grid, and ``path``,
    "split" (a tile's segments spread over the warps of one block) or
    "serial" (one warp walks every segment of its tile)."""
    rows: int
    group: int
    warps: int
    blocks: int
    path: str


def launch_plan(m: int, k: int, n: int, rows: int, group: int) -> Plan:
    """The launch the kernel makes of an (M, K) x (K, N) product with R =
    ``rows`` and G = ``group``: the split path when G is below the
    number of segments, else the serial path."""
    segs = max(1, -(-k // KS))
    tiles = -(-m // rows) * -(-n // _COLS)
    if group < segs:
        return Plan(rows, group, -(-segs // group), tiles, "split")
    return Plan(rows, group, _SERIAL_WARPS, -(-tiles // _SERIAL_WARPS),
                "serial")


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, sms: int = _H100_SMS,
         path: Optional[str] = None) -> Plan:
    """The kernel's launch for an (M, K) x (K, N) product on a card of
    ``sms`` SMs.

    The split path puts ceil(S / G) warps on one tile, each summing G
    segments, and combines them in the block; the serial path has one
    warp walk all S segments of its tile. The split path is taken up to
    :data:`_SPLIT_MAX_ROWS` rows, and ``path`` ("split" or "serial")
    forces one where it can run. R is the largest of 8, 4 and 2 (at most
    M rounded up to a power of two) that still gives the ``sms`` SMs one
    warp a scheduler, else 1. The bits do not depend on the plan.
    """
    segs = max(1, -(-k // KS))
    fill = sms * 128                # lanes of one warp a scheduler
    top = min(8, 1 << max(m - 1, 0).bit_length())
    split = m <= _SPLIT_MAX_ROWS if path is None else path == "split"
    warps = 1
    if split and 1 < segs <= _SPLIT_MAX_SEGMENTS:
        warps = -(-segs // -(-segs // _MAX_WARPS))
    group = -(-segs // warps)
    r = next((c for c in (8, 4, 2)
              if c <= top and -(-m // c) * n * warps >= fill), 1)
    return launch_plan(m, k, n, r, group)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def _fn(dtype: torch.dtype):
    lib = load_library(KERNEL)
    geometry = (ctypes.c_int * 4)()
    lib.ternary_matmul_geometry(geometry)
    if tuple(geometry) != (KS, _COLS, _MAX_WARPS, _SERIAL_WARPS):
        raise RuntimeError(
            f"csrc/ternary_matmul.cu's (KS, COLS, MAX_WARPS, SERIAL_WARPS) "
            f"{tuple(geometry)} differ from the wrapper's "
            f"{(KS, _COLS, _MAX_WARPS, _SERIAL_WARPS)}")
    fn = getattr(lib, f"ternary_matmul_{_SUFFIX[dtype]}")
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(x, w_packed, scale):
    if x.ndim < 2 or w_packed.ndim != 2:
        raise ValueError(f"need (..., K) x and (K/4, N) w_packed, got "
                         f"{tuple(x.shape)} and {tuple(w_packed.shape)}")
    if w_packed.shape[0] * 4 != x.shape[-1]:
        raise ValueError(f"w_packed rows {w_packed.shape[0]} != K/4 for "
                         f"K={x.shape[-1]}")
    if scale.numel() != w_packed.shape[1]:
        raise ValueError(f"scale has {scale.numel()} values for N="
                         f"{w_packed.shape[1]}")


def ternary_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor,
                         scale: torch.Tensor) -> torch.Tensor:
    """K3's plain version: per segment of :data:`KS` k an ascending-k f32
    sum from +0, the partials added into the accumulator in ascending
    segment order, then the scale."""
    _check(x, w_packed, scale)
    wq = unpack2bit(w_packed.t(), out_dtype=torch.float32).t()  # (K, N)
    xf = x.reshape(-1, x.shape[-1]).float()
    acc = torch.zeros((xf.shape[0], wq.shape[1]), dtype=torch.float32,
                      device=x.device)
    for k0 in range(0, wq.shape[0], KS):
        part = torch.zeros_like(acc)
        for k in range(k0, min(k0 + KS, wq.shape[0])):
            part = part + xf[:, k, None] * wq[k]
        acc = acc + part
    out = (acc * scale.reshape(-1).float()).to(x.dtype)
    return out.reshape(*x.shape[:-1], out.shape[1])


def ternary_matmul_cuda(x: torch.Tensor, w_packed: torch.Tensor,
                        scale: torch.Tensor) -> torch.Tensor:
    """Launch K3: contiguous f32 or bf16 ``x`` (..., K), uint8
    ``w_packed`` (K/4, N) and f32 ``scale`` (N,) on one CUDA device.
    Returns (..., N) in ``x``'s dtype, queued on the device's current
    stream (no synchronisation). A decode step makes 256 of these calls,
    so the host work here is kept to checks and one ``torch.empty``."""
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
    idx = x.get_device()
    if idx < 0 or w_packed.get_device() != idx or scale.get_device() != idx:
        raise ValueError(f"ternary_matmul_cuda needs CUDA tensors on one "
                         f"device, got x on {x.device}")
    k, n = x.shape[-1], w_packed.shape[1]
    m = x.shape[:-1].numel()
    p = plan(m, k, n, _sms(idx))
    if p.blocks > _MAX_BLOCKS:
        raise ValueError(f"M={m} rows exceed the kernel's grid "
                         f"({_MAX_BLOCKS} blocks at N={n})")
    out = torch.empty((*x.shape[:-1], n), dtype=x.dtype, device=x.device)
    args = (x.data_ptr(), w_packed.data_ptr(), scale.data_ptr(),
            out.data_ptr(), m, k, n, p.rows, p.group,
            torch.cuda.current_stream(idx).cuda_stream)
    if idx == torch.cuda.current_device():
        rc = _fn(x.dtype)(*args)
    else:
        with torch.cuda.device(idx):
            rc = _fn(x.dtype)(*args)
    if rc != 0:
        raise RuntimeError(f"ternary_matmul kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return out


def ternary_matmul_shape_only(x: torch.Tensor, w_packed: torch.Tensor,
                              scale: torch.Tensor) -> torch.Tensor:
    """K3's output without computing it, for tensors without storage: an
    empty (..., N) tensor in ``x``'s dtype on ``x``'s device. Adds one
    to :data:`shape_only_calls` and ``2 * M * K * N`` to
    :data:`shape_only_flops`."""
    global shape_only_calls, shape_only_flops
    _check(x, w_packed, scale)
    k, n = x.shape[-1], w_packed.shape[1]
    shape_only_calls += 1
    shape_only_flops += 2 * x.shape[:-1].numel() * k * n
    return x.new_empty((*x.shape[:-1], n))


def ternary_matmul_fwd(x: torch.Tensor, w_packed: torch.Tensor,
                       scale: torch.Tensor) -> torch.Tensor:
    """K3 on CUDA tensors, its plain version on CPU tensors, its shape
    alone on tensors without storage (meta or fake). A served decode step
    makes hundreds of these calls, so the card's case is tested first, by
    the cheapest tests."""
    if x.is_cuda and type(x) is not FakeTensor:
        return ternary_matmul_cuda(x, w_packed, scale)
    if x.is_meta or isinstance(x, FakeTensor):
        return ternary_matmul_shape_only(x, w_packed, scale)
    if x.device.type == "cpu":
        return ternary_matmul_plain(x, w_packed, scale)
    raise ValueError(f"unsupported device {x.device}")
