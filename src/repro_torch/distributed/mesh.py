"""The one mesh constructor of the port (port of
``repro.distributed.mesh``).

A :class:`Mesh` is a value: axis names, their sizes, and the devices laid
out over them. It places nothing itself: the sharding rules
(:mod:`repro_torch.distributed.sharding`) read its ``axis_names`` and
``devices.shape``, the dry run (``launch.dryrun``) divides each tensor's
bytes by the axis sizes of its spec, and ``sharding.place`` puts each
block on its position's device. A device may appear at several positions
(``devices=[torch.device("cuda", 0)] * 4``): a logical mesh, whose
positions still hold one block each (the serving engines run one shard
a position there).

``make_mesh()`` takes every visible CUDA device on one ``("data",)``
axis, the axis the serving engines' slot dimension goes over (see
:func:`repro_torch.distributed.sharding.slot_pspec`). Meta devices,
``devices=[torch.device("meta")] * n``, stand in for the JAX package's
forced host devices: the production meshes of ``launch.mesh`` are 256
and 512 of them.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "slot_axis"]

# The meshes entered as context managers on this thread, innermost last
# (read by annotate.current_mesh).
_ACTIVE = threading.local()


def _active_meshes() -> List["Mesh"]:
    if not hasattr(_ACTIVE, "stack"):
        _ACTIVE.stack = []
    return _ACTIVE.stack


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``axis_names`` over ``axis_sizes``, with ``device_list`` laid out
    over them in row-major order. ``devices`` is that list as an array of
    the mesh's shape, as the JAX mesh exposes it; ``shape`` maps each axis
    to its size. ``with mesh:`` makes it :func:`~repro_torch.distributed.
    annotate.current_mesh` on this thread."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    device_list: Tuple[torch.device, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"mesh shape {self.axis_sizes} and axes "
                             f"{self.axis_names} disagree")
        if len(self.device_list) != math.prod(self.axis_sizes):
            raise ValueError(f"{len(self.device_list)} devices for a mesh "
                             f"of shape {self.axis_sizes}")

    @functools.cached_property
    def devices(self) -> np.ndarray:
        out = np.empty(len(self.device_list), dtype=object)
        out[:] = self.device_list
        return out.reshape(self.axis_sizes)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return len(self.device_list)

    def __enter__(self) -> "Mesh":
        _active_meshes().append(self)
        return self

    def __exit__(self, *exc) -> None:
        _active_meshes().pop()


def make_mesh(shape: Union[None, int, Sequence[int]] = None,
              axes: Optional[Sequence[str]] = None, *,
              devices: Optional[Sequence[torch.device]] = None) -> Mesh:
    """Build a device mesh; the unified entry point.

    Forms (all over the first ``prod(shape)`` of ``devices``, default
    every visible CUDA device):

      * ``make_mesh()`` -- every device on one ``("data",)`` axis: the
        sharded-serving default (slot axis == data axis).
      * ``make_mesh(4)`` / ``make_mesh((4,))`` -- the first 4 devices on
        ``("data",)``.
      * ``make_mesh((2, 16, 16), ("pod", "data", "model"),
        devices=[torch.device("meta")] * 512)`` -- the explicit
        launch-stack form (``launch.mesh.make_mesh_for`` is an alias of
        exactly this).

    ``axes`` defaults to ``("data",)`` for 1-D shapes and is required
    otherwise. Raises ``RuntimeError`` when there are fewer devices than
    the shape needs.
    """
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if shape is None:
        shape = (len(devices),)
    elif isinstance(shape, int):
        shape = (shape,)
    else:
        shape = tuple(int(s) for s in shape)
    if axes is None:
        if len(shape) != 1:
            raise ValueError(
                f"axes required for a {len(shape)}-D mesh shape {shape}; "
                f"only 1-D shapes default to ('data',)")
        axes = ("data",)
    axes = tuple(axes)
    if len(axes) != len(shape):
        raise ValueError(f"mesh shape {shape} and axes {axes} disagree")
    n = math.prod(shape)
    if n < 1 or len(devices) < n:
        raise RuntimeError(
            f"need {max(n, 1)} devices, have {len(devices)}; pass "
            f"devices=[torch.device('meta')] * {max(n, 1)} for a mesh "
            f"that only its shape matters for")
    return Mesh(axes, shape, tuple(devices[:n]))


def slot_axis(mesh: Mesh) -> str:
    """The mesh axis the serving engines shard their slot dimension
    over: ``"data"`` when the mesh has one (the launch-stack convention
    -- batch over data), else the mesh's first axis."""
    names: Tuple[str, ...] = tuple(mesh.axis_names)
    return "data" if "data" in names else names[0]
