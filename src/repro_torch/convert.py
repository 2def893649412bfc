"""Carry parameters across from the JAX package.

The JAX package's ``init_snn`` makes conv kernels in HWIO layout and fc
weights as (K, N) with fc1's rows in NHWC flatten order. The port runs its
convs with OIHW kernels and flattens NHWC too (``core/snn.py``), so only
the conv kernels change layout.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["snn_params_from_numpy"]


def snn_params_from_numpy(tree: Mapping[str, Mapping[str, Any]],
                          device=None) -> Dict[str, Dict[str, torch.Tensor]]:
    """SNN parameters as numpy arrays (``{"conv1": {"w": HWIO}, ...,
    "fc1": {"w": (K, N)}, ...}``, e.g. JAX ``init_snn`` output passed
    through ``np.asarray``) -> the port's float32 tensors: conv kernels
    OIHW, fc weights unchanged."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for name in ("conv1", "conv2", "fc1", "fc2"):
        w = np.array(tree[name]["w"], dtype=np.float32)   # own, writable
        if name.startswith("conv"):
            if w.ndim != 4:
                raise ValueError(f"{name} kernel must be HWIO, got shape "
                                 f"{w.shape}")
            w = w.transpose(3, 2, 0, 1)              # HWIO -> OIHW
        elif w.ndim != 2:
            raise ValueError(f"{name} weight must be (K, N), got {w.shape}")
        out[name] = {"w": torch.from_numpy(np.ascontiguousarray(w)).to(
            device)}
    return out
