"""Collectives over one axis of the active process mesh, as autograd
functions (the explicit counterpart of what GSPMD inserts in the JAX
package).

Each takes a tensor and a mesh axis of the active
:class:`~repro_torch.distributed.runtime.ProcessMesh` (``with pmesh:``)
and is the identity when no process mesh is active or the axis has one
rank. Their gradients follow the two conventions of the sharded step:

  * ``all_gather`` (backward: ``reduce_scatter``) and ``reduce_scatter``
    (backward: ``all_gather``): for FSDP, whose gathered weight gets a
    partial gradient on each data rank (its rows of the batch);
  * ``all_reduce`` (backward: identity) and ``copy_to`` (identity
    forward, ``all_reduce`` backward: Megatron's *f*): for tensor
    parallelism, where an activation replicated over ``model`` has its
    whole gradient on every rank and a partitioned one a part of it;
  * ``gather_from`` (backward: this rank's block) and ``split_to``
    (this rank's block; backward: ``all_gather``): a tensor moving
    between a partitioned use and a replicated one (Megatron's *g* and
    its inverse).

``all_reduce_max`` and ``all_reduce_`` reduce without a gradient (the
softmax's max, gradients after the backward, metrics). The sharded
decode step (serve mode, no autograd) moves rows of activations with
``gather_dim``, ``scatter_dim`` (rows of partial products summed back to
their rank) and ``all_to_all`` (rows traded for columns).

Every collective issued adds one to ``launches[(op, axis)]`` (op one of
``"all_gather"``, ``"reduce_scatter"``, ``"all_reduce"``, ``"all_to_all"``)
and its bytes to ``bytes_moved[(op, axis)]``, the bytes of the full
tensor it produces (all_gather, all_reduce, all_to_all) or consumes
(reduce_scatter), as the kernels' launch counters do: tests and
``chip_smoke.py`` assert the counts.
Both backends take the same calls (``runtime``).
"""
from __future__ import annotations

import collections
import warnings
from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.mesh import _active_meshes
from repro_torch.distributed.runtime import ProcessMesh

__all__ = ["all_gather", "reduce_scatter", "all_reduce", "copy_to",
           "gather_from", "split_to", "all_reduce_max", "all_reduce_",
           "gather_dim", "scatter_dim", "all_to_all", "block_range",
           "axis_size", "axis_index", "active",
           "batch_axes", "launches", "bytes_moved", "reset_counts"]

launches: collections.Counter = collections.Counter()
bytes_moved: collections.Counter = collections.Counter()


def reset_counts() -> None:
    launches.clear()
    bytes_moved.clear()


def active():
    """The innermost active process mesh, or None (a plain ``Mesh``
    entered with ``with mesh:`` issues no collective)."""
    stack = _active_meshes()
    return stack[-1] if stack and isinstance(stack[-1], ProcessMesh) \
        else None


def axis_size(axis: str) -> int:
    pm = active()
    return 1 if pm is None else pm.axis_size(axis)


def batch_axes() -> Tuple[str, ...]:
    """The axes of the active process mesh that carry batch rows:
    ``("pod", "data")`` where the mesh has both (``sharding.batch_axes``);
    () without a process mesh."""
    pm = active()
    return () if pm is None else tuple(a for a in ("pod", "data")
                                       if a in pm.shape)


def axis_index(axis: str) -> int:
    pm = active()
    return 0 if pm is None or axis not in pm.shape else pm.coord(axis)


def _count(op: str, axis: str, t: torch.Tensor) -> None:
    launches[(op, axis)] += 1
    bytes_moved[(op, axis)] += t.numel() * t.element_size()


def _group(axis: str, pm=None):
    pm = pm or active()
    if pm is None or pm.axis_size(axis) == 1:
        return None, 1
    return pm.group(axis), pm.axis_size(axis)


def gather_dim(x: torch.Tensor, dim: int, axis: str, pm=None
               ) -> torch.Tensor:
    """The blocks of ``x`` on every rank of ``axis``, joined along ``dim``
    in rank order (no gradient). ``pm``: the process mesh (default: the
    active one)."""
    group, n = _group(axis, pm)
    if group is None:
        return x
    dim = dim % x.ndim
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():     # renamed *_single in torch 2.13
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, xt, group=group)
    _count("all_gather", axis, out)
    return out.movedim(0, dim)


def scatter_dim(x: torch.Tensor, dim: int, axis: str, pm=None
                ) -> torch.Tensor:
    """The sum of ``x`` over the ranks of ``axis``, this rank's block of
    it along ``dim`` (no gradient)."""
    group, n = _group(axis, pm)
    if group is None:
        return x
    dim = dim % x.ndim
    xt = x.movedim(dim, 0).contiguous()
    if xt.shape[0] % n:
        raise ValueError(f"dim of {xt.shape[0]} over {n} ranks")
    out = torch.empty((xt.shape[0] // n, *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.reduce_scatter_tensor(out, xt, group=group)
    _count("reduce_scatter", axis, xt)
    return out.movedim(0, dim)


def all_to_all(x: torch.Tensor, split: int, cat: int, axis: str, pm=None
               ) -> torch.Tensor:
    """Blocks traded over ``axis`` (no gradient): ``x``'s dim ``split`` is
    cut into one block a rank of the axis, block ``i`` goes to rank
    ``i``, and the blocks this rank receives are joined along ``cat`` in
    rank order. With ``split`` the rows gathered over the axis and
    ``cat`` a dim whose columns the axis splits, each rank gets its own
    rows with every column."""
    group, n = _group(axis, pm)
    if group is None:
        return x
    split, cat = split % x.ndim, cat % x.ndim
    if x.shape[split] % n:
        raise ValueError(f"dim of {x.shape[split]} over {n} ranks")
    xt = x.movedim(split, 0).contiguous()
    out = torch.empty_like(xt)
    dist.all_to_all_single(out, xt, group=group)
    _count("all_to_all", axis, out)
    # (n, rows/n, ...) in x's order, the sender's rank leading
    out = out.unflatten(0, (n, -1)).movedim(1, split + 1)
    return out.movedim(0, cat).flatten(cat, cat + 1)


def _block(x: torch.Tensor, dim: int, axis: str, pm) -> torch.Tensor:
    """This rank's block of ``x`` along ``dim`` (no collective)."""
    n = 1 if pm is None else pm.axis_size(axis)
    if n == 1:
        return x
    size = x.shape[dim] // n
    if size * n != x.shape[dim]:
        raise ValueError(f"dim of {x.shape[dim]} over {n} ranks")
    return x.narrow(dim, pm.coord(axis) * size, size)


def all_reduce_(x: torch.Tensor, axis: str, op=None, pm=None
                ) -> torch.Tensor:
    """Sum (or ``op``) ``x`` over ``axis`` in place; returns ``x``."""
    group, _ = _group(axis, pm)
    if group is None:
        return x
    dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=group)
    _count("all_reduce", axis, x)
    return x


def all_reduce_max(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axis`` (a new tensor, no
    gradient)."""
    if _group(axis)[0] is None:
        return x.detach()
    return all_reduce_(x.detach().clone(), axis, dist.ReduceOp.MAX)


# The autograd functions keep the process mesh of their forward: the
# backward may run on another thread (the engine's device threads on the
# card), where no mesh is active.

class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.pm = dim, axis, active()
        return gather_dim(x, dim, axis, ctx.pm)

    @staticmethod
    def backward(ctx, g):
        return scatter_dim(g, ctx.dim, ctx.axis, ctx.pm), None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.pm = dim, axis, active()
        return scatter_dim(x, dim, axis, ctx.pm)

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.axis, ctx.pm), None, None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.pm = axis, active()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(), ctx.axis, pm=ctx.pm), None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.pm = dim, axis, active()
        return gather_dim(x, dim, axis, ctx.pm)

    @staticmethod
    def backward(ctx, g):
        return (_block(g, ctx.dim, ctx.axis, ctx.pm).contiguous(), None,
                None)


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, axis):
        ctx.dim, ctx.axis, ctx.pm = dim, axis, active()
        return _block(x, dim, axis, ctx.pm).contiguous()

    @staticmethod
    def backward(ctx, g):
        return gather_dim(g, ctx.dim, ctx.axis, ctx.pm), None, None


def _live(axis: str) -> bool:
    return axis_size(axis) > 1


def all_gather(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The blocks of ``axis``'s ranks joined along ``dim``; the gradient
    is reduce-scattered (summed over the ranks, each keeping its
    block)."""
    return _AllGather.apply(x, dim, axis) if _live(axis) else x


def reduce_scatter(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis``, this rank's block along ``dim``; the
    gradient is all-gathered."""
    return _ReduceScatter.apply(x, dim, axis) if _live(axis) else x


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` summed over ``axis``; the gradient passes unchanged."""
    return _AllReduce.apply(x, axis) if _live(axis) else x


def copy_to(x: torch.Tensor, axis: str) -> torch.Tensor:
    """``x`` unchanged; the gradient is summed over ``axis`` (a replicated
    activation entering a partitioned computation)."""
    return _CopyTo.apply(x, axis) if _live(axis) else x


def gather_from(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """The blocks of ``axis``'s ranks joined along ``dim``, for replicated
    use: each rank's gradient is whole, so the backward keeps this rank's
    block of it."""
    return _GatherFrom.apply(x, dim, axis) if _live(axis) else x


def split_to(x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
    """This rank's block of a replicated ``x`` along ``dim``, for
    partitioned use; the backward gathers the blocks' gradients, so the
    replicated tensor's gradient is whole on every rank."""
    return _SplitTo.apply(x, dim, axis) if _live(axis) else x


def block_range(size: int, axis: str) -> Tuple[int, int]:
    """The [lo, hi) of this rank's block of a dim of ``size`` over
    ``axis``."""
    n = axis_size(axis)
    step = size // n
    lo = axis_index(axis) * step
    return lo, lo + step

