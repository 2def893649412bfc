"""K4: the RWKV-6 WKV recurrence, as a CUDA kernel for Hopper.

Replaces ``wkv6_scan_pallas`` (``repro/kernels/wkv6_scan.py``), which
keeps a block of per-head ``hd x hd`` states in VMEM scratch across a
sequential T grid axis after transposing r/k/v/logw to (T, B*H, hd). Here
one CUDA block owns one (b, h) for the whole sequence; its state threads
hold the f32 state in registers, one segment of :data:`IS` rows of two
columns each, while two helper warps stage the (B, T, H, hd) inputs in
time chunks into shared memory by asynchronous copies, take the bonus
term and write o (``csrc/wkv6_scan.cu``; ``tools/k4_probe.py`` times its
variants).
``block_t``/``block_bh`` are VMEM-budget choices with no Hopper meaning
and are not ported.

    o_t = r_t (S + diag(u) k_t v_t^T)
    S  <- diag(exp(logw_t)) S + k_t v_t^T          (S starts at state0 or 0)

``r, k, v`` (B, T, H, hd) and ``u`` (H, hd) are all f32 or all bf16;
``logw`` (B, T, H, hd) is f32 or ``r``'s dtype; ``state0`` (B, H, hd, hd)
f32 or None. Returns ``o`` (B, T, H, hd) in ``r``'s dtype and the final
f32 state. hd is 16, 32 or 64.

The order of every sum is part of the function. For each (b, h, t), with
S the state before the step and each multiply and add rounded on its own:

    p_g,j = sum over i in [g*IS, (g+1)*IS), ascending, from +0: r_i S_ij
    beta  = sum over i = 0..hd-1, ascending, from +0: (r_i u_i) k_i
    o_j   = (((+0 + p_0,j) + p_1,j) ... + p_last,j) + beta v_j
    S_ij <- exp(logw_i) S_ij + k_i v_j

``beta`` is the bonus term taken as a rank-one dot: r diag(u) k v^T is
((r*u).k) v. The order depends on (b, h, t) alone, never on T, the batch
or the kernel's time chunks, so rows do not depend on the batch and a
scan chained through ``state0`` equals the unbroken one bit for bit.
:func:`wkv6_scan_plain` follows it exactly, so the kernel equals it bit
for bit on the card; :func:`wkv6_scan_fwd` picks between the two by the
tensor's device alone.

The stripe entry (:func:`wkv6_stripe_fwd`) is the same recurrence on a
stripe of the state's rows, for a decode step whose state has dk split
over the ``data`` ranks (``sharding.cache_pspecs`` at a global batch the
batch axes do not divide: context parallelism). It takes the whole r,
k, u, v and logw of the rank's heads and the rows ``[lo, lo + dk_loc)``
of each (b, h) state, and returns, per (b, t, h), the f32 partial
``p_g,j`` of each :data:`IS`-row segment g of the stripe (one segment
of dk_loc rows where dk_loc < IS), ``beta`` whole, and the new state
rows. The caller gathers the partials of every stripe over ``data`` in
ascending row order and adds them by :func:`wkv6_stripe_combine`:

    o_j = (((+0 + p_0,j) + p_1,j) ... + p_last,j) + beta v_j

the module's order wherever dk_loc is a multiple of IS, so ``o`` is the
one-device kernel's bit for bit there (rwkv6-7b's hd 64 over ``data`` 2:
32 rows a rank); stripes of 1 to 8 rows sum each stripe's rows as one
segment, which moves ``o`` by rounding (rwkv6-7b's 4 rows a rank over a
data axis of 16). The state rows' update is the
module's, bit for bit at any stripe.

On tensors without storage (meta, or the fake tensors of the dry run's
trace, ``launch.dryrun``) :func:`wkv6_scan_fwd` launches nothing: it
returns empty outputs of the kernel's shapes, dtypes and device and adds
the call to :data:`shape_only_calls` and its FLOPs to
:data:`shape_only_flops`. The FLOPs are those of the JAX package's
reference recurrence (``repro.kernels.ref.wkv6_ref``, the body of
``wkv6_scan_pallas``), ``7 * hd**2`` a (b, t, h): the outer product
k v^T (hd**2 multiplies), diag(u) k v^T (hd**2), S + diag(u) k v^T
(hd**2 adds), r times that matrix (2 hd**2), diag(w) S (hd**2) and
+ k v^T (hd**2). exp(logw) is a transcendental and not counted, as
XLA's cost analysis keeps transcendentals apart.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.kernels._build import load_library

__all__ = ["wkv6_scan_cuda", "wkv6_scan_plain", "wkv6_scan_fwd",
           "wkv6_scan_shape_only", "wkv6_chunked", "launches",
           "shape_only_calls", "shape_only_flops", "KERNEL", "HEAD_DIMS",
           "IS", "geometry", "CHUNK", "wkv6_stripe_plain",
           "wkv6_stripe_cuda", "wkv6_stripe_shape_only", "wkv6_stripe_fwd",
           "wkv6_stripe_combine", "stripe_launches",
           "stripe_shape_only_calls", "STRIPE_ROWS"]

KERNEL = "wkv6_scan"

# Launches of the CUDA kernel since import (or since a caller reset it to
# 0). Only wkv6_scan_cuda adds to it, once per launch.
launches = 0
# Calls on tensors without storage and their FLOPs (7 * hd**2 a (b, t,
# h)), since import or since a caller reset them to 0. Only
# wkv6_scan_shape_only adds to them; no launch is made for them.
shape_only_calls = 0
shape_only_flops = 0
# The same for the stripe entry: launches of its kernel (wkv6_stripe_cuda
# alone adds to it), and its calls on tensors without storage, which
# wkv6_stripe_shape_only also adds to shape_only_calls and (7 * dk_loc *
# hd a (b, t, h)) to shape_only_flops.
stripe_launches = 0
stripe_shape_only_calls = 0
# Rows a stripe the stripe entry's kernel and its plain version take
# (dk_loc): rwkv6-7b's hd 64 over a data axis of 2 to 16, and the SMOKE
# config's hd 16 over 2 or 4. The shape-only path takes any divisor of hd
# (a SMOKE config's dry run over a data axis of 16).
STRIPE_ROWS = (4, 8, 16, 32, 64)

HEAD_DIMS = (16, 32, 64)
# Width of the i-segments of r.S (Tentpole order above). csrc/wkv6_scan.cu
# has the same constexpr IS and reports it through wkv6_scan_geometry,
# which _fn checks when the library loads: the two must agree, or the
# kernel and its plain version part bits.
IS = 16
# (dtype of r/k/v/u, dtype of logw) -> exported C function.
_FN = {(torch.float32, torch.float32): "wkv6_scan_f32",
       (torch.bfloat16, torch.bfloat16): "wkv6_scan_bf16",
       (torch.bfloat16, torch.float32): "wkv6_scan_bf16_lwf32"}


# Chunk length of wkv6_chunked (the JAX package's _WKV_CHUNK).
CHUNK = 16

_GEOMETRY = ("IS", "TC", "threads", "smem_bytes", "blocks_per_sm")
_STRIPE_FN = {(torch.float32, torch.float32): "wkv6_stripe_f32",
              (torch.bfloat16, torch.bfloat16): "wkv6_stripe_bf16",
              (torch.bfloat16, torch.float32): "wkv6_stripe_bf16_lwf32"}


def geometry(hd: int = 64) -> dict:
    """The kernel's launch geometry at head dim ``hd`` for the bf16 model's
    call (bf16 r/k/v/u, f32 logw), as the built library reports it: IS,
    TC (steps a staged time chunk), threads and dynamic shared bytes a
    block, and resident blocks an SM. Builds the library (card only)."""
    out = (ctypes.c_int * len(_GEOMETRY))()
    rc = load_library(KERNEL).wkv6_scan_geometry(hd, out)
    if rc != 0:
        raise RuntimeError(f"wkv6_scan_geometry failed: CUDA error {rc}")
    return dict(zip(_GEOMETRY, out))


@functools.lru_cache(maxsize=None)
def _fn(name: str):
    found = geometry()["IS"]
    if found != IS:
        raise RuntimeError(f"csrc/wkv6_scan.cu's IS {found} differs from "
                           f"the wrapper's {IS}")
    fn = getattr(load_library(KERNEL), name)
    if name.startswith("wkv6_stripe"):
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
    else:
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
                    state0: Optional[torch.Tensor] = None, *, seg: int = IS
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's plain version: the module's order, step by step over t,
    vectorised over (b, h, j) and over the segments (``seg`` wide, :data:`IS`
    unless a probe of another kernel geometry asks otherwise). Every
    multiply and add is its own elementwise op, so each rounds alone."""
    _check(r, k, v, logw, u, state0)
    b, t, h, hd = r.shape
    seg = min(seg, hd)
    n_seg = hd // seg
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float())
    q = (rf * u.float()) * kf                            # (b, t, h, hd)
    beta = torch.zeros((b, t, h), dtype=torch.float32, device=r.device)
    for i in range(hd):
        beta = beta + q[..., i]
    s = (torch.zeros((b, h, hd, hd), dtype=torch.float32, device=r.device)
         if state0 is None else state0.float().clone())
    o = torch.empty((b, t, h, hd), dtype=torch.float32, device=r.device)
    for step in range(t):
        r_t = rf[:, step].reshape(b, h, n_seg, seg)
        s_g = s.reshape(b, h, n_seg, seg, hd)
        p = torch.zeros((b, h, n_seg, hd), dtype=torch.float32,
                        device=r.device)
        for ii in range(seg):
            p = p + r_t[..., ii, None] * s_g[:, :, :, ii]
        acc = torch.zeros((b, h, hd), dtype=torch.float32, device=r.device)
        for g in range(n_seg):
            acc = acc + p[:, :, g]
        o[:, step] = acc + beta[:, step, :, None] * vf[:, step]
        s = (wf[:, step, :, :, None] * s
             + kf[:, step, :, :, None] * vf[:, step, :, None, :])
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


def wkv6_scan_shape_only(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         logw: torch.Tensor, u: torch.Tensor,
                         state0: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4's outputs without computing them, for tensors without storage:
    an empty ``o`` (B, T, H, hd) in ``r``'s dtype and an empty f32 state
    (B, H, hd, hd), on ``r``'s device. Adds one to
    :data:`shape_only_calls` and ``7 * B * T * H * hd**2`` to
    :data:`shape_only_flops`."""
    global shape_only_calls, shape_only_flops
    _check(r, k, v, logw, u, state0)
    b, t, h, hd = r.shape
    shape_only_calls += 1
    shape_only_flops += 7 * b * t * h * hd * hd
    return (r.new_empty(r.shape),
            r.new_empty((b, h, hd, hd), dtype=torch.float32))


def wkv6_scan_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  logw: torch.Tensor, u: torch.Tensor,
                  state0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4 on CUDA tensors, its plain version on CPU tensors, its shapes
    alone on tensors without storage (meta or fake)."""
    if r.is_cuda and type(r) is not FakeTensor:
        return wkv6_scan_cuda(r, k, v, logw, u, state0)
    if r.is_meta or isinstance(r, FakeTensor):
        return wkv6_scan_shape_only(r, k, v, logw, u, state0)
    if r.device.type == "cpu":
        return wkv6_scan_plain(r, k, v, logw, u, state0)
    raise ValueError(f"unsupported device {r.device}")


def _check_stripe(r, k, v, logw, u, state0, lo, any_divisor=False):
    """(B, H, hd, dk_loc) of a stripe call; dk_loc in STRIPE_ROWS, or any
    divisor of hd where ``any_divisor`` (the shape-only path)."""
    _check(r, k, v, logw, u, None)
    b, _, h, hd = r.shape
    dk = state0.shape[2] if state0.ndim == 4 else -1
    if any_divisor:
        rows, ok = "a divisor of hd", dk > 0 and hd % dk == 0
    else:
        rows, ok = f"in {STRIPE_ROWS}, at most hd", dk in STRIPE_ROWS \
            and dk <= hd
    if state0.shape != (b, h, dk, hd) or not ok:
        raise ValueError(f"state rows {tuple(state0.shape)}: need (B, H, "
                         f"dk_loc, hd) = ({b}, {h}, dk_loc, {hd}) with "
                         f"dk_loc {rows}")
    if lo % dk or not 0 <= lo <= hd - dk:
        raise ValueError(f"a stripe of {dk} rows at {lo} of {hd}")
    return b, h, hd, dk


def wkv6_stripe_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      logw: torch.Tensor, u: torch.Tensor,
                      state0: torch.Tensor, lo: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stripe entry's plain version (its order, above), step by step
    over t: ``r, k, v, logw`` (B, T, H, hd) and ``u`` (H, hd) whole,
    ``state0`` (B, H, dk_loc, hd) f32 the rows ``[lo, lo + dk_loc)``.
    Returns the f32 partials (B, T, H, G, hd) of the stripe's G segments
    (``min(IS, dk_loc)`` rows each, ascending from +0), the f32 ``beta``
    (B, T, H) of the whole head, and the new f32 state rows."""
    b, h, hd, dk = _check_stripe(r, k, v, logw, u, state0, lo)
    t = r.shape[1]
    seg = min(IS, dk)
    n_seg = dk // seg
    rf, kf, vf = r.float(), k.float(), v.float()
    wf = torch.exp(logw.float()[..., lo:lo + dk])
    q = (rf * u.float()) * kf
    beta = torch.zeros((b, t, h), dtype=torch.float32, device=r.device)
    for i in range(hd):
        beta = beta + q[..., i]
    rs, ks = rf[..., lo:lo + dk], kf[..., lo:lo + dk]
    s = state0.float().clone()
    part = torch.empty((b, t, h, n_seg, hd), dtype=torch.float32,
                       device=r.device)
    for step in range(t):
        r_t = rs[:, step].reshape(b, h, n_seg, seg)
        s_g = s.reshape(b, h, n_seg, seg, hd)
        p = torch.zeros((b, h, n_seg, hd), dtype=torch.float32,
                        device=r.device)
        for ii in range(seg):
            p = p + r_t[..., ii, None] * s_g[:, :, :, ii]
        part[:, step] = p
        s = (wf[:, step, :, :, None] * s
             + ks[:, step, :, :, None] * vf[:, step, :, None, :])
    return part, beta, s


def wkv6_stripe_combine(parts: torch.Tensor, beta: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """``o`` (B, T, H, hd) in ``v``'s dtype from the partials of every
    stripe (B, T, H, G_all, hd), in ascending row order, and ``beta``
    (B, T, H): the segments added in ascending order from +0, then
    ``beta v_j`` (the module's order); elementwise, so the bits are the
    same on any device."""
    acc = torch.zeros_like(parts[..., 0, :])
    for g in range(parts.shape[-2]):
        acc = acc + parts[..., g, :]
    return (acc + beta[..., None] * v.float()).to(v.dtype)


def wkv6_stripe_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     logw: torch.Tensor, u: torch.Tensor,
                     state0: torch.Tensor, lo: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Launch the stripe entry (``wkv6_stripe_*`` in ``csrc/wkv6_scan.cu``)
    on contiguous tensors of one CUDA device. Returns ``(partials, beta,
    state rows)`` queued on the current stream (no synchronisation)."""
    global stripe_launches
    name = _STRIPE_FN.get((r.dtype, logw.dtype))
    if name is None:
        raise TypeError(f"wkv6_stripe_cuda takes float32 or bfloat16 r/k/v/u "
                        f"with float32 logw or logw in r's dtype, got r "
                        f"{r.dtype} and logw {logw.dtype}")
    for nm, x in (("k", k), ("v", v), ("u", u)):
        if x.dtype != r.dtype:
            raise TypeError(f"{nm} dtype {x.dtype} != r dtype {r.dtype}")
    if state0.dtype != torch.float32:
        raise TypeError(f"state0 must be float32, got {state0.dtype}")
    b, h, hd, dk = _check_stripe(r, k, v, logw, u, state0, lo)
    ins = (r, k, v, logw, u, state0)
    if not all(x.is_contiguous() for x in ins):
        raise ValueError("wkv6_stripe_cuda needs contiguous tensors")
    if not r.is_cuda or any(x.device != r.device for x in ins):
        raise ValueError(f"wkv6_stripe_cuda needs CUDA tensors on one "
                         f"device, got r on {r.device}")
    t = r.shape[1]
    part = torch.empty((b, t, h, dk // min(IS, dk), hd), dtype=torch.float32,
                       device=r.device)
    beta = torch.empty((b, t, h), dtype=torch.float32, device=r.device)
    state = torch.empty_like(state0)
    fn = _fn(name)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
                u.data_ptr(), state0.data_ptr(), part.data_ptr(),
                beta.data_ptr(), state.data_ptr(), b, t, h, hd, dk, lo,
                stream)
    if rc != 0:
        raise RuntimeError(f"wkv6_stripe kernel launch failed: CUDA error "
                           f"{rc}")
    stripe_launches += 1
    return part, beta, state


def wkv6_stripe_shape_only(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, logw: torch.Tensor,
                           u: torch.Tensor, state0: torch.Tensor, lo: int
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """The stripe entry's outputs without computing them, for tensors
    without storage; adds one to :data:`stripe_shape_only_calls` and
    :data:`shape_only_calls` and ``7 * B * T * H * dk_loc * hd`` to
    :data:`shape_only_flops` (``wkv6_scan_shape_only``'s count on the
    stripe's rows)."""
    global shape_only_calls, shape_only_flops, stripe_shape_only_calls
    b, h, hd, dk = _check_stripe(r, k, v, logw, u, state0, lo,
                                 any_divisor=True)
    t = r.shape[1]
    stripe_shape_only_calls += 1
    shape_only_calls += 1
    shape_only_flops += 7 * b * t * h * dk * hd
    return (r.new_empty((b, t, h, dk // min(IS, dk), hd),
                        dtype=torch.float32),
            r.new_empty((b, t, h), dtype=torch.float32),
            r.new_empty(state0.shape, dtype=torch.float32))


def wkv6_stripe_fwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    logw: torch.Tensor, u: torch.Tensor,
                    state0: torch.Tensor, lo: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The stripe entry on CUDA tensors, its plain version on CPU tensors,
    its shapes alone on tensors without storage (meta or fake)."""
    if r.is_cuda and type(r) is not FakeTensor:
        return wkv6_stripe_cuda(r, k, v, logw, u, state0, lo)
    if r.is_meta or isinstance(r, FakeTensor):
        return wkv6_stripe_shape_only(r, k, v, logw, u, state0, lo)
    if r.device.type == "cpu":
        return wkv6_stripe_plain(r, k, v, logw, u, state0, lo)
    raise ValueError(f"unsupported device {r.device}")


def wkv6_chunked(
    r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor,
    u: torch.Tensor, state0: Optional[torch.Tensor] = None,
    chunk: int = CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's chunked-parallel WKV-6 (``repro.models.rwkv6.
    wkv6_chunked``), differentiable. r/k/v/logw: (B, S, H, hd); u: (H, hd).

    Returns (o (B,S,H,hd) in r's dtype, state (B,H,hd,hd) f32); f32
    internally. Within a chunk of ``min(chunk, S)`` steps the decays
    factor as exp(cumsum) on r and exp(-cumsum) on k; every term that does
    not read the carried state is computed for all chunks at once, and a
    loop over the chunks carries the state alone. It agrees with K4
    within rounding, not bit for bit (its sums run in another order).
    ``kernels.ops.wkv6_scan``'s backward differentiates it.
    """
    b, s, h, hd = r.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} not divisible by chunk {c}")
    nc = s // c
    rc, kc, vc, wc = (x.reshape(b, nc, c, h, hd).float()
                      for x in (r, k, v, logw))
    cum = torch.cumsum(wc, dim=2)                # inclusive, per chunk
    r_dec = rc * torch.exp(cum - wc)             # decay up to t-1
    k_dec = kc * torch.exp(-cum)
    att = torch.einsum("bnthi,bnshi->bnhts", r_dec, k_dec)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    att = torch.where(mask, att, 0.0)
    intra = torch.einsum("bnhts,bnshj->bnthj", att, vc)
    bonus = torch.einsum("bnthi,hi,bnthi->bnth", rc, u.float(), kc)
    intra = intra + bonus[..., None] * vc
    cum_end = cum[:, :, -1:]                     # (b, nc, 1, h, hd)
    kv = torch.einsum("bnshi,bnshj->bnhij", kc * torch.exp(cum_end - cum),
                      vc)                        # each chunk's k v^T
    decay = torch.exp(cum_end[:, :, 0])[..., None]   # (b, nc, h, hd, 1)
    state = (torch.zeros((b, h, hd, hd), dtype=torch.float32,
                         device=r.device) if state0 is None
             else state0.float())
    before = []
    for n in range(nc):
        before.append(state)
        state = decay[:, n] * state + kv[:, n]
    cross = torch.einsum("bnthi,bnhij->bnthj", r_dec,
                         torch.stack(before, dim=1))
    o = (cross + intra).reshape(b, s, h, hd)
    return o.to(r.dtype), state
