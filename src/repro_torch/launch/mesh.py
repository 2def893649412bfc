"""Production meshes (port of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 devices. Multi-pod: (pod=2,
data=16, model=16) = 512; the ``pod`` axis only carries data parallelism,
FSDP and TP stay inside a pod. Both are built over meta devices: the dry
run reads their axis sizes only, and one H100 holds neither.

Mesh construction itself is :func:`repro_torch.distributed.make_mesh`;
``make_mesh_for`` and ``make_mesh`` remain as aliases of its explicit
``(shape, axes)`` form.
"""
from __future__ import annotations

import math

import torch

from repro_torch.distributed.mesh import Mesh, make_mesh

__all__ = ["make_production_mesh", "make_mesh_for", "make_mesh"]


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes,
                     devices=[torch.device("meta")] * math.prod(shape))


def make_mesh_for(shape, axes) -> Mesh:
    """Alias of :func:`repro_torch.distributed.make_mesh` over the visible
    CUDA devices."""
    return make_mesh(shape, axes)
