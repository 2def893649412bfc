"""Plain-PyTorch oracles for the kernels (port of ``repro.kernels.ref``).

Only ``lif_scan_ref`` is ported in this slice; ``ternary_matmul_ref`` and
``wkv6_ref`` arrive with their kernels.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.lif import LIFParams

__all__ = ["lif_scan_ref"]


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
