"""Sharding rules: logical parameter axes -> mesh axes (FSDP + TP + EP/SP)
(port of ``repro.distributed.sharding``).

Strategy (the JAX package's):
  * ``model`` axis: tensor parallelism -- vocab, heads (or head_dim
    fallback), d_ff, experts.
  * ``data`` axis: FSDP -- the ``embed`` (d_model) dim of every matrix, and
    the optimizer moments with it. Batch is sharded over (pod, data).
  * ``pod`` axis: pure DP. Only gradient all-reduces cross pods.
  * Decode cells with global_batch < |data|: context parallelism -- the KV
    cache/state is sharded over ``data`` (sequence or state-head dim).

Every assignment is divisibility-checked with fallbacks (e.g. llama4's 40
heads % 16 != 0 -> shard head_dim instead; seamless' vocab 256206 % 16
!= 0 -> vocab unsharded). One mesh axis is used at most once per tensor.

A spec is a plain tuple with one entry per dim: ``None`` (replicated),
an axis name, or a tuple of two or more axis names -- what
``tuple(PartitionSpec(...))`` gives in JAX (:func:`spec`), so the rules
here equal the JAX package's entry for entry. The rules are pure functions of shapes and a mesh's
``axis_names``/``devices.shape``.

Binding a spec to devices: :class:`NamedSharding` is a frozen ``(mesh,
spec)`` value (``shardings``/``slot_shardings`` map spec trees to them),
whose ``devices_indices_map`` says which block of a global shape each
mesh position holds, as JAX's does. :func:`place` (``jax.device_put``)
cuts a tree of tensors into :class:`ShardedTensor` leaves, one block per
mesh position on that position's device, and :func:`gather` puts them
back together. A mesh may name one device several times (a logical mesh,
the counterpart of XLA's forced host devices): each position still holds
its own block.

Over a process mesh (``distributed.runtime``: one process a position)
each rank holds only its own block: :func:`local_block` cuts it from a
whole tree (tagged with its spec, which ``annotate.unshard_fsdp``
reads), and :func:`gather_logical` joins the blocks of all ranks back
into the whole arrays (for checkpoints).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.distributed import annotate
from repro_torch.distributed import collectives as C
from repro_torch.distributed.mesh import Mesh, slot_axis
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, tree_map, tree_num_params

__all__ = [
    "param_pspecs", "batch_pspecs", "cache_pspecs", "decode_pspecs",
    "batch_axes", "opt_pspecs", "resolve_spec", "spec",
    "slot_pspec", "slot_state_pspecs", "NamedSharding", "ShardedTensor",
    "shardings", "slot_shardings", "place", "gather", "local_block",
    "gather_logical",
]

Spec = Tuple[Any, ...]

# Preferred mesh axis per logical axis, in priority order.
_PREFS: Dict[str, Tuple[str, ...]] = {
    "vocab": ("model",),
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": (),            # fallback target only
    "mlp": ("model",),
    "experts": ("model",),
    "heads_x": ("model",),     # rwkv fused-head projections (d_model-sized)
    "conv": ("model",),
    "embed": ("data",),        # FSDP
    "embed_out": ("data",),
    "lora": (),
    "state": (),
    "norm": (),
    "layers": (),
}
# If the keyed logical axis could not take 'model', try these dims instead.
_FALLBACKS = {
    "heads": ("head_dim",),
    "kv_heads": ("head_dim",),
    "vocab": (),
    "mlp": ("embed_out",),
}


def spec(*entries) -> Spec:
    """A spec as ``tuple(PartitionSpec(*entries))`` gives it in JAX: an
    entry that is a 1-tuple of axis names becomes that name, an empty
    tuple becomes None."""
    return tuple((None if not a else a[0] if len(a) == 1 else a)
                 if isinstance(a, tuple) else a for a in entries)


def _axis_size(mesh: Mesh, name: str) -> int:
    return dict(zip(mesh.axis_names, mesh.devices.shape))[name]


def resolve_spec(shape: Sequence[int], axes: Sequence[Optional[str]],
                 mesh: Mesh) -> Spec:
    """Assign mesh axes to tensor dims honoring divisibility + uniqueness."""
    assign: list[Optional[str]] = [None] * len(shape)
    used = set()

    def try_assign(dim: int, mesh_axis: str) -> bool:
        if mesh_axis in used or mesh_axis not in mesh.axis_names:
            return False
        if shape[dim] % _axis_size(mesh, mesh_axis) != 0:
            return False
        assign[dim] = mesh_axis
        used.add(mesh_axis)
        return True

    # First pass: direct preferences.
    pending_fallback = []
    for i, name in enumerate(axes):
        if name is None:
            continue
        ok = False
        for ma in _PREFS.get(name, ()):
            if try_assign(i, ma):
                ok = True
                break
        if not ok and name in _FALLBACKS:
            pending_fallback.append(name)
    # Second pass: fallbacks (e.g. heads failed -> shard head_dim).
    for name in pending_fallback:
        for fb in _FALLBACKS[name]:
            done = False
            for i, nm in enumerate(axes):
                if nm == fb and assign[i] is None:
                    # fallback inherits the original preference list
                    for ma in _PREFS.get(name, ()):
                        if try_assign(i, ma):
                            done = True
                            break
                if done:
                    break
            if done:
                break
    return spec(*assign)


# ~2 bytes/param over 16-way TP must fit in ~12 GB usable HBM.
_SERVE_FSDP_THRESHOLD = 96_000_000_000


def param_pspecs(defs: Any, mesh: Mesh, mode: str = "train") -> Any:
    """Spec tree matching a ParamDef tree.

    mode="serve": drop the FSDP ('data') sharding so weights are resident
    per device (TP only) -- decode must not all-gather weights every
    step. Models over ``_SERVE_FSDP_THRESHOLD`` params keep the train
    (FSDP) layout in serve mode: their weights do not fit replicated.
    """
    if mode == "serve" and tree_num_params(defs) > _SERVE_FSDP_THRESHOLD:
        mode = "train"

    def one(d: ParamDef) -> Spec:
        axes = d.axes
        if mode == "serve":
            axes = tuple(None if a in ("embed", "embed_out") else a
                         for a in axes)
        return resolve_spec(d.shape, axes, mesh)

    return tree_map(one, defs)


def opt_pspecs(defs: Any, mesh: Mesh) -> Any:
    """Adam moment specs (same layout as params) -- see training.optimizer."""
    ps = param_pspecs(defs, mesh)
    return {"m": ps, "v": ps, "step": ()}


def batch_axes(mesh: Mesh) -> Tuple[str, ...]:
    """Mesh axes carrying the batch dim: (pod, data) when pods exist."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _batch_dim_spec(mesh: Mesh, global_batch: int):
    """Largest prefix of (pod, data) that divides the batch."""
    axes = []
    prod = 1
    for a in batch_axes(mesh):
        if global_batch % (prod * _axis_size(mesh, a)) == 0:
            axes.append(a)
            prod *= _axis_size(mesh, a)
    return tuple(axes) if axes else None


def batch_pspecs(cfg: ModelConfig, mesh: Mesh, global_batch: int,
                 kind: str) -> Dict[str, Spec]:
    """Input-batch specs per family and step kind."""
    b = _batch_dim_spec(mesh, global_batch)
    specs: Dict[str, Spec] = {"tokens": spec(b, None),
                              "targets": spec(b, None)}
    if cfg.family == "encdec":
        specs["frames"] = spec(b, None, None)
    if cfg.family == "vlm":
        specs["patch_embeds"] = spec(b, None, None)
    return specs


def cache_pspecs(cfg: ModelConfig, mesh: Mesh, cache: Dict[str, Any],
                 global_batch: int) -> Dict[str, Spec]:
    """Decode-cache specs. Batch-sharded when possible; context-parallel
    (sequence / state-head over 'data') when global_batch < |data|."""
    b = _batch_dim_spec(mesh, global_batch)

    def spec_for(path: str, x) -> Spec:
        shape = x.shape
        if path == "pos":
            return ()
        if cfg.family in ("dense", "moe", "vlm", "encdec"):
            # (L, B, S, KVH, hd)
            return _kv_spec(shape, b, mesh)
        if cfg.family == "rwkv6":
            if path == "state":        # (L, B, H, dk, dv)
                return _state_spec(shape, b, mesh)
            return spec(None, b, None)  # tm_x / cm_x (L, B, D)
        if cfg.family == "zamba2":
            if path in ("attn_k", "attn_v"):
                return _kv_spec(shape, b, mesh)
            if path == "ssm":           # (L, B, H, P, N)
                return _state_spec(shape, b, mesh)
            return spec(None, b, None, None)  # conv (L, B, k-1, cd)
        return ()

    return {k: spec_for(k, v) for k, v in cache.items()}


def _kv_spec(shape, b, mesh) -> Spec:
    """(L, B, S, KVH, hd) decode cache: batch over (pod,)data when
    shardable, and the sequence dim over 'model' (flash-decoding style:
    every device holds a contiguous KV stripe, attends locally, and only
    the tiny softmax stats cross the TP axis). Falls back to kv-heads
    sharding when the stripe does not divide."""
    _, bsz, s, kvh, hd = shape
    dsz = _axis_size(mesh, "data")
    msz = _axis_size(mesh, "model")
    if b is not None:
        bdim, free_data = b, False
    elif s % dsz == 0 and s >= dsz:
        bdim, free_data = None, True   # context parallelism over 'data'
    else:
        bdim, free_data = None, False
    if s % msz == 0 and s >= msz:
        sdim = ("data", "model") if free_data and s % (dsz * msz) == 0 \
            else "model"
        return spec(None, bdim, sdim, None, None)
    if free_data:
        return spec(None, None, "data",
                    "model" if kvh % msz == 0 else None, None)
    kdim = "model" if kvh % msz == 0 else None
    hdim = "model" if (kdim is None and hd % msz == 0) else None
    return spec(None, bdim, None, kdim, hdim)


def _state_spec(shape, b, mesh) -> Spec:
    """(L, B, H, x, y) recurrent state: heads over 'model'; if batch is not
    shardable, also spread x over 'data'."""
    _, bsz, h, x, y = shape
    msz = _axis_size(mesh, "model")
    dsz = _axis_size(mesh, "data")
    hdim = "model" if h % msz == 0 else None
    xdim = None
    if b is None and x % dsz == 0:
        xdim = "data"
    return spec(None, b, hdim, xdim, None)


def _quantized_pspecs(pspecs, params_abs, mesh: Mesh):
    """Mirror float specs onto the quantized tree: packed keeps the
    source's output-dim sharding (divisibility-checked), scale follows."""
    sizes = mesh.shape

    def walk(spec, abs_):
        if isinstance(abs_, dict) and "packed" in abs_:
            src = tuple(spec) + (None,) * (abs_["packed"].ndim - len(spec))
            out_axis = src[-1]
            packed = [None] * abs_["packed"].ndim
            scale = [None] * abs_["scale"].ndim
            if (out_axis is not None
                    and abs_["packed"].shape[-1] % sizes.get(out_axis, 1)
                    == 0):
                packed[-1] = out_axis
                scale[-1] = out_axis
            return {"packed": tuple(packed), "scale": tuple(scale)}
        if isinstance(abs_, dict):
            return {k: walk(spec[k], abs_[k]) for k in abs_}
        return spec

    return walk(pspecs, params_abs)


def decode_pspecs(cfg: ModelConfig, mesh: Mesh, params: Any, cache: Any,
                  global_batch: int) -> Dict[str, Any]:
    """The specs of a decode step's arguments as the JAX package's dry
    run jits its serve step (``lower_cell``): ``params`` on the train
    specs (FSDP over ``data``, TP over ``model``; a ternary tree's packed
    leaves by :func:`_quantized_pspecs`), ``cache`` on
    :func:`cache_pspecs`, ``tokens`` over :func:`_batch_dim_spec`."""
    from repro_torch.models import build_model
    pspecs = param_pspecs(build_model(cfg).defs(), mesh, mode="train")
    return {"params": _quantized_pspecs(pspecs, params, mesh),
            "cache": cache_pspecs(cfg, mesh, cache, global_batch),
            "tokens": spec(_batch_dim_spec(mesh, global_batch), None)}


# ----------------------------------------------------------------------
# Placement: specs bound to a mesh's devices.
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec bound to a mesh (JAX's ``NamedSharding``): dim ``i`` of a
    tensor is split over the mesh axes of ``spec[i]`` (None: whole on
    every device; several axes: the first is the major one), dims past
    the spec are whole."""
    mesh: Mesh
    spec: Spec

    def devices_indices_map(self, shape: Sequence[int]
                            ) -> Dict[int, Tuple[slice, ...]]:
        """The block of a ``shape`` tensor each mesh position holds, keyed
        by the position in ``mesh.device_list`` (a logical mesh names one
        device at several positions): JAX's ``devices_indices_map``, with
        positions for devices. Raises when a split dim does not divide."""
        return dict(enumerate(_indices(self, tuple(int(d) for d in shape))))


@functools.lru_cache(maxsize=None)
def _indices(sharding: NamedSharding, shape: Tuple[int, ...]
             ) -> Tuple[Tuple[slice, ...], ...]:
    mesh, spec = sharding.mesh, tuple(sharding.spec)
    if len(spec) > len(shape):
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{len(shape)} dims of {shape}")
    spec = spec + (None,) * (len(shape) - len(spec))
    sizes = mesh.shape
    coords = np.indices(mesh.axis_sizes).reshape(len(sizes), -1).T
    out = []
    for coord in coords:
        at = dict(zip(mesh.axis_names, coord.tolist()))
        idx = []
        for dim, entry in zip(shape, spec):
            if entry is None:
                idx.append(slice(None))
                continue
            axes = (entry,) if isinstance(entry, str) else tuple(entry)
            unknown = [a for a in axes if a not in sizes]
            if unknown:
                raise ValueError(f"spec {sharding.spec} names axes "
                                 f"{unknown} the mesh {mesh.axis_names} "
                                 f"lacks")
            parts, block = 1, 0
            for a in axes:
                block, parts = block * sizes[a] + at[a], parts * sizes[a]
            if dim % parts:
                raise ValueError(
                    f"dim of size {dim} does not divide over mesh axes "
                    f"{axes} ({parts} blocks); spec {sharding.spec}")
            step = dim // parts
            idx.append(slice(block * step, (block + 1) * step))
        out.append(tuple(idx))
    return tuple(out)


def shardings(mesh: Mesh, spec_tree: Any) -> Any:
    """Spec tree -> :class:`NamedSharding` tree (None stays None)."""
    return pytree.tree_map(
        lambda s: None if s is None else NamedSharding(mesh, s), spec_tree,
        is_leaf=lambda x: x is None or isinstance(x, tuple))


class ShardedTensor:
    """A global tensor held as one block per mesh position: ``blocks[p]``
    is the block ``sharding.devices_indices_map(shape)[p]`` on
    ``sharding.mesh.device_list[p]`` (the port's counterpart of a placed
    ``jax.Array``). Positions that hold the same block on the same device
    share one tensor. Never written in place: :meth:`with_row` returns a
    new value."""

    __slots__ = ("sharding", "shape", "blocks")

    def __init__(self, sharding: NamedSharding, shape: Sequence[int],
                 blocks: Sequence[torch.Tensor]):
        self.sharding = sharding
        self.shape = torch.Size(shape)
        self.blocks = tuple(blocks)
        if len(self.blocks) != sharding.mesh.size:
            raise ValueError(f"{len(self.blocks)} blocks for a mesh of "
                             f"{sharding.mesh.size} devices")

    @classmethod
    def build(cls, sharding: NamedSharding, shape: Sequence[int], make
              ) -> "ShardedTensor":
        """Each position's block from ``make(index, device)``, made once
        per distinct (index, device)."""
        made: Dict[tuple, torch.Tensor] = {}
        blocks = []
        for idx, dev in zip(_indices(sharding, tuple(shape)),
                            sharding.mesh.device_list):
            key = (tuple((s.start, s.stop) for s in idx), str(dev))
            if key not in made:
                made[key] = make(idx, dev)
            blocks.append(made[key])
        return cls(sharding, shape, blocks)

    @classmethod
    def from_rows(cls, rows: Sequence[torch.Tensor],
                  sharding: NamedSharding) -> "ShardedTensor":
        """Stack slot rows (each a tensor on any device) straight into the
        blocks of a slot-major ``sharding``: each block takes its rows to
        its device, so no global tensor is made."""
        shape = (len(rows), *rows[0].shape)
        _check_slot_major(sharding, shape)
        return cls.build(sharding, shape, lambda idx, dev: torch.stack(
            [r.to(dev) for r in rows[idx[0]]]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        """The device of position 0."""
        return self.blocks[0].device

    def _row(self, i: int) -> int:
        """``i`` as a row index of a slot-major tensor, in range."""
        _check_slot_major(self.sharding, self.shape)
        if not -self.shape[0] <= i < self.shape[0]:
            raise IndexError(f"row {i} of {self.shape[0]}")
        return i % self.shape[0]

    def __getitem__(self, i: int) -> torch.Tensor:
        """Row ``i`` (a view of the first block holding it, on that
        block's device)."""
        if not isinstance(i, int):
            raise TypeError("a ShardedTensor is indexed by one slot row")
        i = self._row(i)
        for b, idx in zip(self.blocks,
                          _indices(self.sharding, tuple(self.shape))):
            lo, hi, _ = idx[0].indices(self.shape[0])
            if lo <= i < hi:
                return b[i - lo]
        raise AssertionError("no block holds the row")

    def with_row(self, i: int, value) -> "ShardedTensor":
        """A new value equal to this one with row ``i`` set to ``value`` on
        every position that holds it; the other blocks are shared."""
        i = self._row(i)
        new: Dict[int, torch.Tensor] = {}
        blocks = []
        for b, idx in zip(self.blocks,
                          _indices(self.sharding, tuple(self.shape))):
            lo, hi, _ = idx[0].indices(self.shape[0])
            if lo <= i < hi:
                if id(b) not in new:
                    c = b.clone()
                    c[i - lo] = torch.as_tensor(value, dtype=c.dtype,
                                                device=c.device)
                    new[id(b)] = c
                b = new[id(b)]
            blocks.append(b)
        return ShardedTensor(self.sharding, self.shape, blocks)

    def gather(self, device="cpu") -> torch.Tensor:
        """The global tensor on ``device``."""
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for b, idx in zip(self.blocks,
                          _indices(self.sharding, tuple(self.shape))):
            out[idx] = b.to(device)
        return out

    def __repr__(self):
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype="
                f"{self.dtype}, spec={self.sharding.spec}, mesh="
                f"{dict(self.sharding.mesh.shape)})")


def _check_slot_major(sharding: NamedSharding, shape) -> None:
    if any(e is not None for e in tuple(sharding.spec)[1:len(shape)]):
        raise ValueError(f"rows of a {sharding.spec} tensor span blocks; "
                         f"only slot-major specs have whole rows")


def _place_leaf(a, s: Optional[NamedSharding]):
    if a is None or s is None:
        return a
    if isinstance(a, ShardedTensor):
        if a.sharding == s:
            return a
        a = a.gather(a.device)
    elif not isinstance(a, torch.Tensor):
        a = torch.from_numpy(np.asarray(a))
    return ShardedTensor.build(
        s, a.shape, lambda idx, dev: a[idx].to(dev).contiguous())


def place(tree: Any, shardings_: Any) -> Any:
    """``jax.device_put(tree, shardings)``: every tensor (or numpy array)
    leaf cut into a :class:`ShardedTensor` by its :class:`NamedSharding`
    (one sharding for every leaf, or a tree of them). A leaf already
    placed with its sharding is returned as it is (no copy); one placed
    otherwise is gathered and placed anew. A block on its source's device
    is a view of the source."""
    if isinstance(shardings_, NamedSharding):
        return pytree.tree_map(lambda a: _place_leaf(a, shardings_), tree)
    return pytree.tree_map(_place_leaf, tree, shardings_)


def gather(tree: Any, device="cpu") -> Any:
    """The inverse of :func:`place`: every :class:`ShardedTensor` leaf as
    one tensor on ``device`` (the host by default); other leaves as they
    are."""
    return pytree.tree_map(
        lambda a: a.gather(device) if isinstance(a, ShardedTensor) else a,
        tree)


def _zip_map(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree of dicts and lists, with the spec
    tree's matching entry (a spec tuple is a leaf of the spec tree)."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, s) for v, s in zip(tree, specs))
    return fn(tree, specs)


def local_block(tree: Any, spec_tree: Any, pmesh: Mesh, device=None
                ) -> Any:
    """This rank's block of every leaf of ``tree`` (whole tensors or numpy
    arrays, bfloat16 bits included; nested dicts and lists) under its
    spec in ``spec_tree``: ``NamedSharding(pmesh, spec)
    .devices_indices_map(shape)`` at ``pmesh.rank``, copied to ``device``
    (the rank's by default), contiguous and tagged with the spec
    (``annotate.tag``). A whole leaf on the same device is copied, so the
    block owns its memory."""
    from repro_torch.convert import lm_params_from_numpy
    dev = torch.device(device) if device is not None else pmesh.device

    def one(x, s):
        if not isinstance(x, torch.Tensor):
            x = lm_params_from_numpy(np.asarray(x))
        s = tuple(s)
        idx = NamedSharding(pmesh, s).devices_indices_map(
            tuple(x.shape))[pmesh.rank]
        blk = x[idx].to(dev, copy=True).contiguous()
        return annotate.tag(blk, s)
    return _zip_map(one, tree, spec_tree)


def gather_logical(tree: Any, spec_tree: Any, pmesh: Mesh,
                   device="cpu", root: Optional[int] = None) -> Any:
    """The whole arrays of a tree of blocks (each leaf this rank's block
    under its spec): every rank takes part, each leaf's blocks gathered
    over the axes of its spec, one leaf at a time, and moved to ``device``
    (the host by default). With ``root`` only that rank keeps them (the
    others get None leaves, so no rank but the root holds more than one
    whole leaf at a time)."""
    def one(x, s):
        with pmesh:
            for dim, e in enumerate(tuple(s)):
                # the minor axis of a dim over several first
                for a in reversed((e,) if isinstance(e, str) else (e or ())):
                    x = C.gather_dim(x, dim, a)
        return x.to(device) if root in (None, pmesh.rank) else None
    return _zip_map(one, tree, spec_tree)


# ----------------------------------------------------------------------
# Slot-axis rules: the serving engines' state/batch pytrees.
#
# The streaming engines keep everything per-stream slot-major: batch
# buffers and carried-state pytrees all lead with the batch-slot axis. The
# rule is therefore one line -- leading axis over the mesh's data axis,
# everything else replicated -- but it lives HERE, next to the model-param
# rules, so there is a single place that says how a tensor maps onto a
# mesh.
# ----------------------------------------------------------------------

def slot_pspec(ndim: int, mesh: Optional[Mesh] = None,
               axis: Optional[str] = None) -> Spec:
    """The slot-major spec: leading (batch-slot) dim over the data axis,
    every other dim replicated. ``axis`` overrides the axis name
    (default: :func:`~repro_torch.distributed.mesh.slot_axis` of
    ``mesh``, or ``"data"`` when neither is given)."""
    if axis is None:
        axis = slot_axis(mesh) if mesh is not None else "data"
    return spec(axis, *([None] * (ndim - 1)))


def slot_state_pspecs(state: Any, mesh: Optional[Mesh] = None,
                      axis: Optional[str] = None) -> Any:
    """Spec tree for a slot-major carried-state pytree (every leaf is
    ``(B, ...)``; see ``InferenceEngine.init_state``)."""
    def ndim(a) -> int:
        if isinstance(a, (torch.Tensor, ShardedTensor)):
            return a.ndim
        return int(np.ndim(a))
    # A None leaf is an empty subtree, as in jax.tree.map.
    return pytree.tree_map(
        lambda a: None if a is None else slot_pspec(ndim(a), mesh, axis),
        state)


def slot_shardings(mesh: Mesh, state: Any,
                   axis: Optional[str] = None) -> Any:
    """:class:`NamedSharding` tree for a slot-major state pytree on
    ``mesh``."""
    return shardings(mesh, slot_state_pspecs(state, mesh, axis))
