"""Leaky-integrate-and-fire neuron dynamics with surrogate gradients.

The port of ``repro.core.lif``: a discrete-time LIF with multiplicative
leak and reset-to-zero, as SNE implements it,

    V[t] = alpha * V[t-1] * (1 - S[t-1]) + I[t]
    S[t] = Heaviside(V[t] - v_th)

with the STBP rectangular surrogate derivative
``dS/dV ~= 1/a * 1{|V - v_th| < a/2}``.

Each operation of the update is rounded on its own (no fused multiply-add),
which is what makes these functions, the kernel in
``repro_torch.kernels.lif_scan`` and the JAX reference agree bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

__all__ = [
    "LIFParams",
    "spike_surrogate",
    "lif_step",
    "lif_scan_reference",
]


@dataclasses.dataclass(frozen=True)
class LIFParams:
    """LIF neuron constants (hardware-calibrated in SNE's case)."""

    alpha: float = 0.875     # membrane leak per step (SNE uses 1 - 2^-k leaks)
    v_th: float = 0.5        # firing threshold
    surrogate_width: float = 2.0  # 'a' in the STBP rectangular surrogate


class _SpikeSurrogate(torch.autograd.Function):
    """Heaviside forward, rectangular STBP surrogate backward."""

    @staticmethod
    def forward(ctx, v, v_th: float, width: float):
        ctx.save_for_backward(v)
        ctx.v_th, ctx.width = v_th, width
        return (v >= v_th).to(v.dtype)

    @staticmethod
    def backward(ctx, g):
        (v,) = ctx.saved_tensors
        inside = ((v - ctx.v_th).abs() < (ctx.width / 2.0)).to(v.dtype)
        return g * inside / ctx.width, None, None


def spike_surrogate(v: torch.Tensor, v_th: float,
                    width: float = 1.0) -> torch.Tensor:
    """Heaviside spike with rectangular surrogate gradient (STBP)."""
    return _SpikeSurrogate.apply(v, float(v_th), float(width))


def lif_step(
    v: torch.Tensor,
    s_prev: torch.Tensor,
    current: torch.Tensor,
    p: LIFParams,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One LIF timestep. Returns (new membrane f32, new spikes).

    The membrane is carried in f32 whatever the input dtype.
    """
    v_new = (p.alpha * v.float() * (1.0 - s_prev.float())
             + current.float())
    s_new = spike_surrogate(v_new, p.v_th,
                            p.surrogate_width).to(current.dtype)
    return v_new, s_new


def lif_scan_reference(
    currents: torch.Tensor,
    p: LIFParams,
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan LIF dynamics over time (plain, differentiable).

    Args:
      currents: input currents, shape (T, ...) -- leading axis is time.
      p: neuron constants.
      v0: optional initial membrane, shape ``currents.shape[1:]``.

    Returns:
      (spikes, v_final): spikes has the shape and dtype of ``currents``;
      v_final is the final (pre-reset) membrane in the input dtype.

    Stateful-streaming contract: the initial spike state is the one implied
    by the membrane, ``s0 = (v0 >= v_th)``, so chaining windows through
    ``v0=v_final`` reproduces the uninterrupted scan bit for bit.
    """
    shape = currents.shape[1:]
    if v0 is None:
        v = torch.zeros(shape, dtype=torch.float32, device=currents.device)
        s = torch.zeros(shape, dtype=currents.dtype, device=currents.device)
    else:
        v = v0.float()
        s = spike_surrogate(v, p.v_th, p.surrogate_width).to(currents.dtype)
    spikes = []
    for i_t in currents:
        v, s = lif_step(v, s, i_t, p)
        spikes.append(s)
    return torch.stack(spikes), v.to(currents.dtype)
