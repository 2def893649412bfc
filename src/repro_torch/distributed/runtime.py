"""The multi-process runtime: one process per rank, a ``torch.
distributed`` process group, and a process mesh over the ranks.

The JAX package trains over a mesh as one program that GSPMD partitions.
The port runs one process per mesh position instead, each holding its own
block of every tensor (``sharding.local_block``) and exchanging the rest
through the collectives of :mod:`repro_torch.distributed.collectives`.

:func:`init` joins a process group from an explicit address, port, world
size and rank (no environment variable is read) and returns a
:class:`ProcessMesh`: a :class:`~repro_torch.distributed.mesh.Mesh`
whose positions are the ranks in row-major order, plus this rank's
position and one sub-group per axis. The backend is explicit:

  * ``"nccl"``: one rank per card;
  * ``"gloo"``: the CPU, and several ranks sharing one card (NCCL refuses
    two ranks on one device). On the H100's torch (2.11) gloo runs
    ``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
    ``all_reduce`` (sum and max) on CUDA tensors, bf16 included, staging
    them through the host.

Nothing switches backends on failure, and the group has a ``timeout``, so
a rank that dies fails the others' next collective instead of hanging
them. :func:`spawn` starts ``world_size`` processes on this host with the
``spawn`` start method (CUDA forbids ``fork`` once the parent has
touched the card); a child that raises makes it raise, and so the
launching process exits non-zero.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import socket
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import Mesh

__all__ = ["ProcessMesh", "init", "process_mesh", "spawn", "free_port",
           "destroy", "BACKENDS", "MESH_AXES"]

BACKENDS = ("nccl", "gloo")
# The axes of a training mesh by its number of dims, as the JAX package
# names them: "pod" is pure data parallelism (gradients summed over it),
# "data" FSDP and batch rows, "model" tensor parallelism.
MESH_AXES = {1: ("data",), 2: ("data", "model"),
             3: ("pod", "data", "model")}
DEFAULT_TIMEOUT_S = 300.0


@dataclasses.dataclass(frozen=True, eq=False)
class ProcessMesh(Mesh):
    """A :class:`Mesh` over processes: position ``p`` of ``device_list``
    is rank ``p`` (row-major over ``axis_sizes``), on that rank's device.
    ``rank`` is this process's position, ``coords`` its index on each
    axis, ``groups`` the sub-group of each axis that holds it (the ranks
    that differ from it on that axis only), ``backend`` the process
    group's. ``with pmesh:`` makes it the active mesh, under which
    ``annotate.unshard_fsdp`` and the TP layers issue collectives."""
    rank: int = 0
    coords: Tuple[Tuple[str, int], ...] = ()
    groups: Tuple[Tuple[str, Any], ...] = ()
    backend: str = "gloo"

    @property
    def device(self) -> torch.device:
        return self.device_list[self.rank]

    def coord(self, axis: str) -> int:
        return dict(self.coords)[axis]

    def group(self, axis: str):
        return dict(self.groups)[axis]

    def axis_size(self, axis: str) -> int:
        return self.shape.get(axis, 1)


def free_port() -> int:
    """A TCP port on localhost free at the time of the call."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init(address: str, port: int, world_size: int, rank: int, *,
         backend: str, device, shape: Optional[Sequence[int]] = None,
         timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """Join the process group at ``tcp://address:port`` as ``rank`` of
    ``world_size`` and return the process mesh of ``shape`` (default
    ``(world_size, 1)``) over ``MESH_AXES`` of its number of dims
    (``("pod", "data", "model")`` for a 3-part shape; any other number
    raises ``ValueError``). ``device`` is this rank's (``cuda:i`` or
    ``cpu``); with NCCL it becomes the current CUDA device."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r}: one of {BACKENDS}")
    shape = tuple(shape or (world_size, 1))
    if len(shape) not in MESH_AXES:
        raise ValueError(f"a mesh of shape {shape}: training meshes are "
                         f"{tuple(MESH_AXES.values())}")
    device = torch.device(device)
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError("nccl needs a CUDA device per rank")
        torch.cuda.set_device(device)
    kw = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(
        backend, init_method=f"tcp://{address}:{port}",
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return process_mesh(shape, MESH_AXES[len(shape)], device,
                        timeout_s=timeout_s)


def process_mesh(shape: Sequence[int], axes: Sequence[str], device, *,
                 timeout_s: float = DEFAULT_TIMEOUT_S) -> ProcessMesh:
    """A process mesh of ``shape`` over ``axes`` on the joined group
    (every rank calls it, with the same shape, in the same order: each
    axis's sub-groups are made with ``new_group`` on every rank, with the
    same ``timeout``)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh {shape} over {axes} for a world of {world}")
    devices: list = [None] * world
    dist.all_gather_object(devices, str(torch.device(device)))
    grid = np.arange(world).reshape(shape)
    coords = dict(zip(axes, np.unravel_index(rank, shape)))
    groups = {}
    for i, axis in enumerate(axes):
        # Every line of ranks along axis i, in one fixed order on every
        # rank; keep the line through this rank.
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line],
                               timeout=datetime.timedelta(seconds=timeout_s))
            if rank in line:
                groups[axis] = g
    return ProcessMesh(
        axes, shape, tuple(torch.device(d) for d in devices), rank=rank,
        coords=tuple((a, int(c)) for a, c in coords.items()),
        groups=tuple(groups.items()),
        backend=dist.get_backend())


def destroy() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def _entry(rank: int, fn: Callable, world_size: int, args: tuple) -> None:
    try:
        fn(rank, world_size, *args)
    finally:
        destroy()


def spawn(fn: Callable, world_size: int, args: tuple = ()) -> None:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` fresh
    processes (``torch.multiprocessing``, ``spawn`` start method; ``fn``
    must be importable by name) and wait for all of them. A child that
    raises or dies ends the others and raises here
    (``torch.multiprocessing.ProcessRaisedException`` /
    ``ProcessExitedException``). Each child leaves its process group on
    the way out."""
    import torch.multiprocessing as mp
    mp.start_processes(_entry, args=(fn, world_size, tuple(args)),
                       nprocs=world_size, join=True, start_method="spawn")
