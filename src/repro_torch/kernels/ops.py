"""Differentiable public wrappers around the kernels (port of
``repro.kernels.ops``).

``lif_scan``             -- fused LIF scan with the STBP surrogate gradient.
``fc_lif_scan``          -- fused ``spikes @ w`` + LIF scan for the fc layers.
``fc_currents``          -- the fc currents ``spikes @ w`` alone (K2's
                            currents entry), with the product's gradient.
``ternary_matmul``       -- packed-ternary matmul (forward only, K3).
``pack_ternary_weights`` -- (K, N) float weights -> K3's packed layout.
``wkv6_scan``            -- the RWKV-6 WKV recurrence (K4), with the
                            chunked form's gradient.
``wkv6_stripe``          -- K4's stripe entry: one decode step's WKV on a
                            stripe of the state's rows (forward only).

The forward of each is the CUDA kernel on a CUDA tensor and the kernel's
plain version on a CPU tensor (see ``lif_scan_fwd``/``fc_lif_scan_fwd``/
``ternary_matmul_fwd``/``wkv6_scan_fwd``). The backward of the two LIF
scans recomputes the plain reference under autograd, as the JAX package's
custom VJPs do -- a remat policy, not an approximation: the forward values
are the kernel's. ``fc_lif_scan``'s recomputes its currents through
``fc_currents``, in the forward's ascending-k order, so the recomputed
membrane is the forward's bit for bit. ``fc_currents``' backward is the
two plain products ``g @ w.T`` and ``s.T @ g`` (``torch.matmul``), the
products the JAX package leaves to XLA's VJP of ``@``.
``wkv6_scan``'s backward differentiates the chunked-parallel form
(``kernels.wkv6_scan.wkv6_chunked``, what XLA differentiates in the JAX
package) recomputed under autograd, so its gradient agrees with K4's
forward within rounding, not bit for bit.
No backward kernel exists to port; ``ternary_matmul`` is a serving op with
no gradient, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.lif import LIFParams, lif_scan_reference
from repro_torch.core.ternary import pack2bit, ternarize
from repro_torch.kernels import fc_lif_scan as _k2
from repro_torch.kernels.fc_lif_scan import fc_lif_scan_fwd
from repro_torch.kernels.lif_scan import lif_scan_fwd
from repro_torch.kernels.ternary_matmul import ternary_matmul_fwd
from repro_torch.kernels.wkv6_scan import (CHUNK, wkv6_chunked,
                                          wkv6_scan_fwd, wkv6_stripe_fwd)

__all__ = ["lif_scan", "lif_scan_batched", "fc_lif_scan",
           "fc_lif_scan_batched", "fc_currents", "pack_ternary_weights",
           "ternary_matmul",
           "wkv6_scan", "wkv6_stripe"]


def _recompute_grads(fn, inputs, grads_out):
    """Gradients of ``fn(*inputs)`` (the plain reference) for the
    cotangents ``grads_out``; ``None`` inputs get ``None``."""
    with torch.enable_grad():
        live = [None if x is None else x.detach().requires_grad_()
                for x in inputs]
        outs = fn(*live)
        want = [x for x in live if x is not None]
        got = iter(torch.autograd.grad(outs, want, grads_out,
                                       allow_unused=True))
        return [None if x is None else next(got) for x in live]


class _LifScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, currents, v0, p: LIFParams):
        ctx.p = p
        ctx.save_for_backward(currents, v0)
        return lif_scan_fwd(currents, p, v0)

    @staticmethod
    def backward(ctx, g_spikes, g_vfin):
        currents, v0 = ctx.saved_tensors
        p = ctx.p
        g_c, g_v0 = _recompute_grads(
            lambda c, v: lif_scan_reference(c, p, v), (currents, v0),
            (g_spikes, g_vfin))
        return g_c, g_v0, None


def lif_scan(
    currents: torch.Tensor,
    p: LIFParams = LIFParams(),
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused LIF scan over (T, ...) currents -> (spikes, v_final).

    Drop-in for :func:`repro_torch.core.lif.lif_scan_reference` (same
    values bit for bit, same STBP surrogate gradients), with the temporal
    scan in one kernel launch on the card. Where no gradient is wanted
    (the serving engines run under ``no_grad``) it calls the forward
    directly, without the autograd node.
    """
    currents = currents.contiguous()
    if torch.is_grad_enabled() and (
            currents.requires_grad or (v0 is not None and v0.requires_grad)):
        return _LifScan.apply(currents, v0, p)
    return lif_scan_fwd(currents, p, v0)


def lif_scan_batched(
    currents: torch.Tensor,
    p: LIFParams = LIFParams(),
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream-major LIF scan: (B, T, ...) -> ((B, T, ...), (B, ...)).

    One launch scans every stream: the batch folds into the neuron axis of
    the time-major layout, and since the dynamics are elementwise each
    stream's result equals its own :func:`lif_scan` bit for bit.
    """
    if currents.ndim < 2:
        raise ValueError(f"need (B, T, ...) currents, got "
                         f"{tuple(currents.shape)}")
    spikes, v_fin = lif_scan(currents.transpose(0, 1), p, v0)
    return spikes.transpose(0, 1), v_fin


class _FcLifScan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spikes, w, v0, p: LIFParams):
        ctx.p = p
        ctx.save_for_backward(spikes, w, v0)
        return fc_lif_scan_fwd(spikes, w, p, v0)

    @staticmethod
    def backward(ctx, g_spikes, g_vfin):
        spikes, w, v0 = ctx.saved_tensors
        p = ctx.p

        def plain(s, w_, v):
            # K2's plain version, its currents summed in the forward's
            # order; outputs in the spikes' dtype, as the forward's.
            out, v_fin = lif_scan_reference(fc_currents(s.float(), w_), p, v)
            return out.to(s.dtype), v_fin.to(s.dtype)

        g_s, g_w, g_v0 = _recompute_grads(plain, (spikes, w, v0),
                                          (g_spikes, g_vfin))
        return g_s, g_w, g_v0, None


def fc_lif_scan(
    spikes: torch.Tensor,
    w: torch.Tensor,
    p: LIFParams = LIFParams(),
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused ``spikes @ w`` + LIF scan -> (out_spikes, v_final).

    ``spikes``: (T, B, K) or (T, K); ``w``: (K, N); ``v0``: (B, N)/(N,).
    The currents are ascending-k f32 sums (see
    :func:`repro_torch.kernels.fc_lif_scan.fc_currents`) and never reach
    device memory on the card.
    """
    return _FcLifScan.apply(spikes.contiguous(), w.contiguous(), v0, p)


def fc_lif_scan_batched(
    spikes: torch.Tensor,
    w: torch.Tensor,
    p: LIFParams = LIFParams(),
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stream-major fused fc+LIF: (B, T, K) -> ((B, T, N), (B, N))."""
    if spikes.ndim != 3:
        raise ValueError(f"need (B, T, K) spikes, got {tuple(spikes.shape)}")
    out, v_fin = fc_lif_scan(spikes.transpose(0, 1), w, p, v0)
    return out.transpose(0, 1), v_fin


class _FcCurrents(torch.autograd.Function):

    @staticmethod
    def forward(ctx, spikes, w):
        ctx.save_for_backward(spikes, w)
        return _k2.fc_currents(spikes, w)

    @staticmethod
    def backward(ctx, g):
        spikes, w = ctx.saved_tensors
        g_s = g_w = None
        if ctx.needs_input_grad[0]:
            g_s = torch.matmul(g, w.t()).to(spikes.dtype)
        if ctx.needs_input_grad[1]:
            g_w = torch.matmul(spikes.reshape(-1, spikes.shape[-1]).t()
                               .to(g.dtype), g.reshape(-1, g.shape[-1]))
        return g_s, g_w


def fc_currents(spikes: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The ascending-k f32 currents ``spikes @ w`` (see
    :func:`repro_torch.kernels.fc_lif_scan.fc_currents`), differentiable.

    ``spikes`` (..., K), ``w`` (K, N) -> (..., N) float32. The forward is
    one launch of K2's currents entry on a CUDA tensor and the plain loop
    on a CPU tensor, recording no graph either way; the backward is
    ``g @ w.T`` and ``s.T @ g``. Where no gradient is wanted it calls the
    forward directly, so it launches exactly what the forward launches.
    """
    if torch.is_grad_enabled() and (spikes.requires_grad or w.requires_grad):
        return _FcCurrents.apply(spikes, w)
    return _k2.fc_currents(spikes, w)


def pack_ternary_weights(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize (K, N) float weights to K3's packed layout.

    Returns ``(w_packed (K//4, N) uint8, scale (N,) f32)``: per-output-
    channel TWN quantization (the N axis), packed along K.
    """
    k, n = w.shape
    if k % 4:
        raise ValueError(f"K={k} must be a multiple of 4 for 2-bit packing")
    q, scale = ternarize(w, axis=-1)           # q int8 (K, N); scale (1, N)
    packed = pack2bit(q.t()).t().contiguous()  # pack along K -> (K//4, N)
    return packed, scale.reshape(n).float()


def ternary_matmul(x: torch.Tensor, w_packed: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """``x`` (..., K) @ ternary (K, N) with in-kernel unpacking, then the
    per-channel scale (K3). The f32 sum is segmented as the TPU kernel
    tiles K: ascending k within each 512-k segment, the segments' partials
    added in ascending order (``kernels.ternary_matmul.KS``)."""
    if scale.ndim != 1:
        scale = scale.reshape(-1)
    return ternary_matmul_fwd(x.contiguous(), w_packed.contiguous(),
                              scale.contiguous())


class _Wkv6Scan(torch.autograd.Function):

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state0):
        ctx.save_for_backward(r, k, v, logw, u, state0)
        return wkv6_scan_fwd(r, k, v, logw, u, state0)

    @staticmethod
    def backward(ctx, g_o, g_state):
        return tuple(_recompute_grads(wkv6_chunked, ctx.saved_tensors,
                                      (g_o, g_state)))


def wkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor,
              state0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 WKV over (B, T, H, hd) ``r, k, v, logw`` and (H, hd) ``u``
    from ``state0`` (B, H, hd, hd) f32, or zeros (K4).

    Returns ``(o (B, T, H, hd) in r's dtype, state (B, H, hd, hd) f32)``.
    The sums follow K4's fixed order (``kernels/wkv6_scan.py``): r.S in
    ``IS``-wide i-segments added in ascending order, then the bonus term
    as the rank-one ((r*u).k) v; the same on the card and the CPU.

    Where an input wants a gradient, the forward is still one K4 launch
    and the backward recomputes ``wkv6_chunked`` (chunks of 16 steps, so
    T must be a multiple of min(16, T)) and differentiates it: no kernel
    runs in the backward. The gradients are the chunked form's, within
    rounding of the exact gradient at K4's values (the tests hold them to
    ``jax.grad`` of the JAX package's ``wkv6_chunked`` at rtol 1e-4,
    atol 1e-5 in f32). Where no gradient is wanted (decode, under
    ``no_grad``) it calls the forward directly, without the autograd
    node.
    """
    ins = (r.contiguous(), k.contiguous(), v.contiguous(),
           logw.contiguous(), u.contiguous(),
           None if state0 is None else state0.contiguous())
    if torch.is_grad_enabled() and any(x is not None and x.requires_grad
                                       for x in ins):
        t = r.shape[1]
        if t % min(CHUNK, t):
            raise ValueError(f"the WKV gradient recomputes the chunked form, "
                             f"which needs T a multiple of {CHUNK}; got "
                             f"T={t}")
        return _Wkv6Scan.apply(*ins)
    return wkv6_scan_fwd(*ins)


def wkv6_stripe(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, state0: torch.Tensor,
                lo: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4's stripe entry (``kernels.wkv6_scan.wkv6_stripe_fwd``): the WKV
    of the rank's heads on rows ``[lo, lo + dk_loc)`` of each state, for a
    decode step whose state has dk over ``data``. Returns the f32
    partials of the stripe's segments, the f32 ``beta`` and the new state
    rows; a serving op with no gradient, as ``ternary_matmul``."""
    return wkv6_stripe_fwd(*(x.contiguous() for x in (r, k, v, logw, u,
                                                      state0)), lo)
