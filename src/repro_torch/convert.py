"""Carry parameters across from the JAX package.

The JAX package's ``init_snn``/``init_tcn`` make conv kernels in HWIO
layout and fc weights as (K, N) with fc1's rows in NHWC flatten order. The
port runs its convs with OIHW kernels and flattens NHWC too
(``core/snn.py``, ``core/tcn.py``), so only the conv tensors change layout.
The LM parameter trees (``repro.models``) keep their layouts in the port
(projection weights (K, N) in both), so they carry across bit for bit.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["snn_params_from_numpy", "tcn_params_from_numpy",
           "lm_params_from_numpy"]


def snn_params_from_numpy(tree: Mapping[str, Mapping[str, Any]]
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """SNN parameters as numpy arrays (``{"conv1": {"w": HWIO}, ...,
    "fc1": {"w": (K, N)}, ...}``, e.g. JAX ``init_snn`` output passed
    through ``np.asarray``) -> the port's float32 tensors: conv kernels
    OIHW, fc weights unchanged. The tensors stay on the CPU: the engine
    that takes them places them on its device."""
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
        out[name] = {"w": _tensor(w, np.float32)}
    return out


def _tensor(a, dtype) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.array(a, dtype=dtype)))


def _oihw(name: str, a: np.ndarray) -> np.ndarray:
    if a.ndim != 4:
        raise ValueError(f"{name} kernel must be HWIO, got shape {a.shape}")
    return a.transpose(3, 2, 0, 1)


def tcn_params_from_numpy(tree: Mapping[str, Mapping[str, Any]]
                          ) -> Dict[str, Dict[str, torch.Tensor]]:
    """TCN parameters as numpy arrays -> the port's CPU tensors.

    Takes either float params (``init_tcn`` output: ``{"conv1": {"w":
    HWIO}, ..., "fc1": {"w": (K, N)}, "fc2": {"w": (K, N)}}``), for the
    port's ``pack_tcn``, or ``pack_tcn`` output (conv ``{"q", "scale"}``,
    fc1 ``{"packed", "scale"}``, fc2 ``{"w"}``), for ``prepacked=True``.
    Conv tensors go from HWIO to OIHW and a per-channel conv scale from
    (1, 1, 1, N) to (N, 1, 1, 1); fc1's packed bytes pass through
    unchanged.
    """
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    packed = "q" in tree["conv1"]
    for name in ("conv1", "conv2"):
        layer = tree[name]
        if packed:
            scale = np.asarray(layer["scale"], np.float32)
            out[name] = {
                "q": _tensor(_oihw(name, np.asarray(layer["q"])), np.int8),
                "scale": _tensor(scale.reshape(-1, 1, 1, 1), np.float32)}
        else:
            out[name] = {"w": _tensor(_oihw(name, np.asarray(layer["w"])),
                                      np.float32)}
    if packed:
        out["fc1"] = {"packed": _tensor(tree["fc1"]["packed"], np.uint8),
                      "scale": _tensor(np.asarray(tree["fc1"]["scale"])
                                       .reshape(-1), np.float32)}
    else:
        out["fc1"] = {"w": _tensor(tree["fc1"]["w"], np.float32)}
    out["fc2"] = {"w": _tensor(tree["fc2"]["w"], np.float32)}
    return out


def _lm_leaf(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16, which torch.from_numpy refuses: carry the
        # bits across through a uint16 view.
        bits = np.ascontiguousarray(a).view(np.uint16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True, order="C"))


def lm_params_from_numpy(tree: Any) -> Any:
    """An LM parameter tree of numpy arrays (e.g. JAX ``Model.init``
    output through ``np.asarray``) -> the same nesting of CPU tensors,
    bit for bit, layouts unchanged.

    bfloat16 arrays (``ml_dtypes.bfloat16``, what ``np.asarray`` gives for
    a JAX bf16 array) become ``torch.bfloat16``; ternary-packed
    ``{"packed", "scale"}`` leaves come across as they are.
    """
    if isinstance(tree, Mapping):
        return {k: lm_params_from_numpy(v) for k, v in tree.items()}
    return _lm_leaf(tree)
