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
``axis_names``/``devices.shape``. Binding specs to devices
(``shardings``, ``slot_shardings``) is the multi-GPU runtime, which waits
for ROADMAP item 7.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch.distributed.mesh import Mesh, slot_axis
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, tree_map, tree_num_params

__all__ = [
    "param_pspecs", "batch_pspecs", "cache_pspecs",
    "batch_axes", "opt_pspecs", "resolve_spec", "spec",
    "slot_pspec", "slot_state_pspecs",
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
        return a.ndim if isinstance(a, torch.Tensor) else int(np.ndim(a))
    # A None leaf is an empty subtree, as in jax.tree.map.
    return pytree.tree_map(
        lambda a: None if a is None else slot_pspec(ndim(a), mesh, axis),
        state)
