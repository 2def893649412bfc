"""Plain-PyTorch oracles for the kernels (port of ``repro.kernels.ref``).

``lif_scan_ref`` (K1's oracle), ``ternary_matmul_ref`` (K3's) and
``wkv6_ref`` (K4's, one head).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.lif import LIFParams
from repro_torch.core.ternary import unpack2bit

__all__ = ["lif_scan_ref", "ternary_matmul_ref", "wkv6_ref"]


def lif_scan_ref(
    currents: torch.Tensor,
    p: LIFParams,
    v0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LIF dynamics over (T, ...) currents. Returns (spikes, v_final).

    The SNE hardware recurrence (reset-to-zero):
        V[t] = alpha * V[t-1] * (V[t-1] < v_th) + I[t]
        S[t] = V[t] >= v_th

    The membrane is carried in f32 whatever the input dtype; spikes and
    v_final come back in the input dtype.
    """
    dt = currents.dtype
    v = (torch.zeros(currents.shape[1:], dtype=torch.float32,
                     device=currents.device)
         if v0 is None else v0.float())
    alpha = torch.full((), p.alpha, dtype=torch.float32, device=v.device)
    v_th = torch.full((), p.v_th, dtype=torch.float32, device=v.device)
    spikes = []
    for i_t in currents:
        v = alpha * v * (v < v_th).float() + i_t.float()
        spikes.append((v >= v_th).to(dt))
    return torch.stack(spikes), v.to(dt)


def ternary_matmul_ref(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
) -> torch.Tensor:
    """Packed-ternary matmul oracle: unpack, an f32 product, then scale.

    ``x`` (M, K) f32/bf16; ``w_packed`` (K // 4, N) uint8, packed along K
    (see :func:`repro_torch.core.ternary.pack2bit`); ``scale`` (N,).
    Returns (M, N) in ``x``'s dtype. The product is a library matmul, so
    its summation order is the library's: K3 and its plain version fix the
    order instead (ascending k within each 512-k segment, the segments in
    ascending order) and agree with this within rounding.
    """
    w_q = unpack2bit(w_packed.t()).t()          # (K, N) int8 in {-1, 0, 1}
    acc = torch.matmul(x.float(), w_q.float())
    return (acc * scale.reshape(1, -1).float()).to(x.dtype)


def wkv6_ref(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV-6 (Finch) WKV recurrence oracle, one head.

        S_t = diag(w_t) S_{t-1} + k_t v_t^T
        o_t = r_t (S_{t-1} + diag(u) k_t v_t^T)        (bonus-u form)

    ``r, k, w`` (T, Dk); ``v`` (T, Dv); ``u`` (Dk,); ``w`` is the per-step
    decay in (0, 1), already exponentiated. ``state0`` optional (Dk, Dv).
    Returns ``(o (T, Dv) in r's dtype, state_final f32)``; the products
    are library matmuls, so their order is the library's. K4 and its
    plain version fix the order instead (r.S in ``IS``-wide i-segments
    added in ascending order, then the bonus as ((r*u).k) v) and agree
    with this within rounding.
    """
    dk, dv = k.shape[1], v.shape[1]
    f32 = torch.float32
    s = (torch.zeros((dk, dv), dtype=f32, device=r.device)
         if state0 is None else state0.float())
    uf = u.float()
    outs = []
    for r_t, k_t, v_t, w_t in zip(r, k, v, w):
        kv = torch.outer(k_t, v_t).float()
        outs.append(r_t.float() @ (s + uf[:, None] * kv))
        s = w_t.float()[:, None] * s + kv
    o = (torch.stack(outs) if outs
         else torch.zeros((0, dv), dtype=f32, device=r.device))
    return o.to(r.dtype), s
