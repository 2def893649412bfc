"""In-model sharding annotations (port of ``repro.distributed.annotate``).

In the JAX package ``constrain`` and ``unshard_fsdp`` hand GSPMD a
sharding constraint when a mesh is active, and are identities off a
mesh. The port runs one process per mesh position
(``distributed.runtime``), each holding its block of every parameter
(``sharding.local_block``), so here the annotations act on blocks:

  * ``unshard_fsdp(w, *candidates)`` -- under an active process mesh in
    ``"train"`` mode -- all-gathers the dims that the parameter's spec
    puts on ``data`` (FSDP gather at use; the gradient is
    reduce-scattered) and leaves ``w`` in the layout of the first
    candidate that divides (the JAX package's rule), moving a ``model``
    dim where the candidate wants another one. Off a process mesh it is
    the identity, as in the JAX package. ``gather_whole(w)`` gathers
    every sharded dim, for a use in which each rank reads its own part
    of the whole weight.
  * ``"serve"`` mode under a process mesh (the sharded decode step,
    ``launch.steps.make_serve_step``): weights stay in the blocks the
    ranks store, as the JAX package leaves them 2-D sharded at use, and
    only activations cross ranks. A layer with a serve rule reads a
    block's stored spec through :func:`serve_layout`; ``unshard_fsdp``,
    ``gather_whole`` and :func:`fsdp_layout` raise ``NotImplementedError``
    there, so a layer without one never computes on a block as if it
    were the whole weight. :func:`tp_size` is the ``model`` axis's size
    in both modes. A serve step states which batch axes split its rows
    (:func:`serve_rows`, from the tokens' spec): a global batch that an
    axis does not divide is whole on every rank of that axis, and
    :func:`rows_split` tells the layers which.
  * ``constrain`` stays the identity: the layers' explicit TP ops
    (``layers.dense``, ``attention_apply``, the vocab-parallel embedding
    and loss) already lay each activation out as the JAX package's
    constraints ask GSPMD to.

A parameter block knows its spec through :func:`tag`
(``sharding.local_block`` tags every block; slicing a stacked layer,
``layers.layer_params``, and the trainer's autograd leaves carry the
tag on).

``execution_mode``/``get_execution_mode`` are the JAX package's as they
are: a thread-local ``"train"`` or ``"serve"`` that a step sets and a
layer may read. ``current_mesh()`` is the :class:`~repro_torch.
distributed.mesh.Mesh` entered last on this thread (``with mesh:``), or
None.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple, Union

import torch

from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import Mesh, _active_meshes

__all__ = ["constrain", "current_mesh", "unshard_fsdp", "gather_at_use",
           "gather_whole", "fsdp_layout", "tag", "spec_of", "tp_size",
           "recompute_context", "execution_mode", "get_execution_mode",
           "serving", "serve_layout", "serve_rows", "rows_split"]

AxisLike = Union[None, str, Tuple[str, ...]]
_SPEC_ATTR = "_repro_spec"


def current_mesh() -> Optional[Mesh]:
    """The active (context) mesh, or None."""
    stack = _active_meshes()
    return stack[-1] if stack else None


def constrain(x, spec: Sequence[AxisLike]):
    """``x`` unchanged. The JAX package constrains ``x`` to ``spec`` for
    GSPMD under a mesh; in the port each rank already holds ``x`` in that
    layout, put there by the explicit tensor-parallel ops of the layers
    (column- and row-parallel ``dense``, heads-parallel attention and
    WKV, the vocab-parallel embedding, logits and loss)."""
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
    by ``unshard_fsdp`` and :func:`serving`."""
    prev = get_execution_mode()
    _MODE.mode = mode
    try:
        yield
    finally:
        _MODE.mode = prev


@contextlib.contextmanager
def _restored(meshes, mode):
    stack = _active_meshes()
    depth = len(stack)
    stack.extend(meshes)
    prev = get_execution_mode()
    _MODE.mode = mode
    try:
        yield
    finally:
        del stack[depth:]
        _MODE.mode = prev


def recompute_context():
    """``context_fn`` of ``torch.utils.checkpoint`` (``layers.remat``):
    the recompute runs in the backward, on the autograd engine's thread on
    the card, where the meshes entered and the execution mode of this
    thread are not set; it runs under the ones active now."""
    return (contextlib.nullcontext(),
            _restored(list(_active_meshes()), get_execution_mode()))


def tag(t: torch.Tensor, spec) -> torch.Tensor:
    """Record on the block ``t`` the spec of the parameter it is a block
    of (one entry a dim); returns ``t``."""
    setattr(t, _SPEC_ATTR, tuple(spec) + (None,) * (t.ndim - len(spec)))
    return t


def spec_of(t: torch.Tensor):
    """The spec :func:`tag` recorded on ``t``, or None."""
    return getattr(t, _SPEC_ATTR, None)


def tp_size() -> int:
    """The size of the active process mesh's ``model`` axis (1 without
    one)."""
    return C.axis_size("model")


def serving() -> bool:
    """Whether a process mesh is active in ``"serve"`` mode: the layers
    then read each weight as the block this rank stores."""
    return C.active() is not None and get_execution_mode() == "serve"


@contextlib.contextmanager
def serve_rows(entry):
    """Inside ``with``: the serve step's rows are split over the batch
    axes of ``entry`` (the batch dim's entry of the tokens' spec,
    ``sharding.decode_pspecs``: None, an axis name or a tuple of them)
    and whole on every rank of the others."""
    prev = getattr(_MODE, "rows", None)
    _MODE.rows = _axes(entry)
    try:
        yield
    finally:
        _MODE.rows = prev


def rows_split(axis: str) -> bool:
    """Whether the rows of the active serve step are split over ``axis``
    (an axis of one rank splits nothing). Outside :func:`serve_rows` the
    rows are split over every batch axis of the process mesh."""
    if C.axis_size(axis) == 1:
        return False
    rows = getattr(_MODE, "rows", None)
    return axis in (C.batch_axes() if rows is None else rows)


def serve_layout(w: torch.Tensor):
    """The stored spec of the block ``w`` (one entry a dim: None, or the
    mesh axis the dim is split over) while :func:`serving`, else None. A
    dim over several axes raises ``NotImplementedError``."""
    return _stored(w) if serving() else None


def _refuse_serve(what: str) -> None:
    if serving():
        raise NotImplementedError(
            f"{what} in serve mode under a process mesh: weights stay in "
            f"the blocks each rank stores (serve_layout), and this use has "
            f"no serve-mode rule")


def _logical(w: torch.Tensor, stored) -> Tuple[int, ...]:
    return tuple(n * math.prod(C.axis_size(a) for a in _axes(e))
                 for n, e in zip(w.shape, stored))


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def fsdp_layout(w: torch.Tensor, *candidates: Sequence[AxisLike]):
    """The layout :func:`unshard_fsdp` leaves ``w`` in: the first of
    ``candidates`` (then the fully replicated one) whose axes divide the
    dims of the whole parameter, with axes the mesh lacks dropped. None
    when no process mesh is active."""
    pm = C.active()
    if pm is None:
        return None
    _refuse_serve(f"the gather at use of a {tuple(w.shape)} weight")
    stored = _stored(w)
    shape = _logical(w, stored)
    for cand in candidates + ((None,) * w.ndim,):
        cand = tuple(cand) + (None,) * (w.ndim - len(cand))
        cand = tuple(None if e is None or not set(_axes(e)) <= set(pm.shape)
                     else e for e in cand)
        if all(n % math.prod(pm.axis_size(a) for a in _axes(e)) == 0
               for n, e in zip(shape, cand)):
            return cand
    raise AssertionError("the replicated layout always divides")


def _stored(w: torch.Tensor):
    stored = spec_of(w)
    if stored is None:
        raise ValueError(
            f"a {tuple(w.shape)} weight without a spec under a process "
            f"mesh: parameters reach the model as tagged blocks "
            f"(sharding.local_block)")
    if any(len(_axes(e)) > 1 for e in stored):
        raise NotImplementedError(f"a dim over several mesh axes: {stored}")
    return stored


def gather_at_use(w: torch.Tensor, *candidates: Sequence[AxisLike]):
    """``(w in the chosen layout, the layout)``: :func:`unshard_fsdp`
    with the layout it chose (None and ``w`` itself off a process
    mesh)."""
    lay = fsdp_layout(w, *candidates)
    if lay is None:
        return w, None
    stored = _stored(w)
    # FSDP: every dim on 'data' gathered; the gradient reduce-scattered.
    for dim, e in enumerate(stored):
        if e == "data":
            w = C.all_gather(w, dim, "data")
    # TP: the 'model' dim moved where the layout wants it. A dim the
    # layout replicates is gathered for replicated use, a dim it splits
    # is cut from a replicated tensor for partitioned use.
    src = stored.index("model") if "model" in stored else None
    dst = lay.index("model") if "model" in lay else None
    if src != dst:
        if src is not None:
            w = C.gather_from(w, src, "model")
        if dst is not None:
            w = C.split_to(w, dst, "model")
    return w, lay


def gather_whole(w: torch.Tensor) -> torch.Tensor:
    """The whole parameter of the block ``w``, in ``"train"`` mode under an
    active process mesh, for a use in which each rank reads a part of it
    that its stored blocks do not line up with (zamba2's ``in_proj`` and
    conv): every dim its spec puts on a mesh axis all-gathered, whose
    backward sums the ranks' parts of the gradient and keeps this rank's
    block (``collectives.all_gather``). Off a process mesh ``w``
    unchanged; in ``"serve"`` mode under one ``NotImplementedError``."""
    if C.active() is None:
        return w
    _refuse_serve(f"the gather of a whole {tuple(w.shape)} weight")
    for dim, e in enumerate(_stored(w)):
        if e is not None:
            w = C.all_gather(w, dim, e)
    return w


def unshard_fsdp(w, *candidates: Sequence[AxisLike]):
    """FSDP gather-at-use of a parameter block, in ``"train"`` mode under
    an active process mesh: the dims its spec puts on ``data`` gathered,
    and only the ``model`` dim of the first dividing candidate sharded
    (no candidate divides: fully replicated use). Off a process mesh
    ``w`` unchanged, as in the JAX package; in ``"serve"`` mode under
    one ``NotImplementedError`` (the JAX package's no-op leaves GSPMD a
    sharded weight; here the caller would get a block)."""
    if not isinstance(w, torch.Tensor):
        return w
    return gather_at_use(w, *candidates)[0]
