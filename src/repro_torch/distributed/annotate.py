"""In-model sharding annotations (port of ``repro.distributed.annotate``).

In the JAX package ``constrain`` and ``unshard_fsdp`` hand GSPMD a
sharding constraint when a mesh is active, and are identities off a mesh.
The port has no SPMD partitioner to hand a constraint to: its multi-GPU
runtime (ROADMAP item 7) places every shard explicitly, from the specs of
``distributed.sharding``. So here both are identities on every path, and
the models do not call them.

``execution_mode``/``get_execution_mode`` are the JAX package's as they
are: a thread-local ``"train"`` or ``"serve"`` that a step sets and a
layer may read. ``current_mesh()`` is the :class:`~repro_torch.
distributed.mesh.Mesh` entered last on this thread (``with mesh:``), or
None.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence, Tuple, Union

from repro_torch.distributed.mesh import Mesh, _active_meshes

__all__ = ["constrain", "current_mesh", "unshard_fsdp",
           "execution_mode", "get_execution_mode"]

AxisLike = Union[None, str, Tuple[str, ...]]


def current_mesh() -> Optional[Mesh]:
    """The active (context) mesh, or None."""
    stack = _active_meshes()
    return stack[-1] if stack else None


def constrain(x, spec: Sequence[AxisLike]):
    """``x`` unchanged. The JAX package constrains ``x`` to ``spec`` for
    GSPMD under a mesh; the port has no SPMD partitioner, and its
    multi-GPU runtime (ROADMAP item 7) places shards explicitly."""
    del spec
    return x


_MODE = threading.local()


def get_execution_mode() -> str:
    return getattr(_MODE, "mode", "train")


@contextlib.contextmanager
def execution_mode(mode: str):
    """'train' (default): weights are gathered at use (FSDP gather-at-use,
    right for high-arithmetic-intensity steps). 'serve': weights stay
    sharded and the small decode activations carry the collectives. Read
    by ``unshard_fsdp`` in the JAX package; the port keeps the mode for
    its multi-GPU runtime."""
    prev = get_execution_mode()
    _MODE.mode = mode
    try:
        yield
    finally:
        _MODE.mode = prev


def unshard_fsdp(w, *candidates: Sequence[AxisLike]):
    """``w`` unchanged. The JAX package re-constrains a weight so that
    only its TP ('model') dims stay sharded, forcing GSPMD to all-gather
    the FSDP shards at use; the port has no SPMD partitioner, and its
    multi-GPU runtime (ROADMAP item 7) gathers shards explicitly."""
    del candidates
    return w
