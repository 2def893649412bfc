"""Per-device collective bytes of a sharded step (the role of
``repro.launch.hlo_analysis`` in the JAX package's dry run).

The JAX dry run parses the collectives out of XLA's partitioned HLO. The
port has no HLO: its sharded step issues its collectives itself, one
process a rank, and ``distributed.collectives`` tallies each by
``(op, axis)`` with the bytes of the tensor it counts. So the dry run
traces ONE rank's step on fake tensors over a fake process group of the
mesh's world (``torch.testing._internal.distributed.fake_pg``: no
communication, every collective returns a tensor of the right shape),
and :func:`collective_bytes` turns the tallies into the JAX record's
keys -- ``bytes_by_kind``, ``count_by_kind``, ``total_bytes`` -- under
HLO's kind names, with ``hlo_analysis``' ring formulas on the group size
``g`` of the op's axis:

    all-gather          result_bytes * (g-1)/g
    reduce-scatter      result_bytes * g * (g-1)/g   (input is g x result)
    all-reduce          result_bytes * 2 * (g-1)/g   (RS + AG)
    all-to-all          result_bytes * (g-1)/g

The tallies count the gathered tensor of an all-gather, the whole
input of a reduce-scatter (``g`` x its result) and the result of an
all-to-all, so every kind's volume is its tallied bytes times
``(g-1)/g``, twice for an all-reduce.

:func:`trace_step` is the step ``Trainer(shardings=...)`` runs on a rank
-- its blocks of the params and AdamW moments under ``param_pspecs``,
its rows of the batch under ``batch_pspecs``, ``loss_and_grads`` with the
specs, ``reduce_grads`` and ``adamw_update`` with the specs -- or, for a
prefill cell, the same model's forward (``Model.apply``) on those
blocks, or, for a decode cell, the serve step
(``launch.steps.make_serve_step``) on the rank's blocks of the params
(ternary ones with ``--quant ternary``), the cache and the tokens under
``sharding.decode_pspecs``. Nothing is allocated and no kernel runs: it
costs the trace's host time alone.
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Mapping, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.distributed import collectives as C
from repro_torch.distributed import runtime as R
from repro_torch.distributed import sharding as SH
from repro_torch.launch import steps as ST
from repro_torch.models import build_model

__all__ = ["KINDS", "collective_bytes", "fake_process_mesh", "trace_step",
           "trace_decode", "mesh_collectives"]

# The port's collective ops and HLO's names of them.
KINDS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
         "all_reduce": "all-reduce", "all_to_all": "all-to-all"}


def collective_bytes(launches: Mapping, tensor_bytes: Mapping,
                     axis_sizes: Mapping[str, int]) -> Dict[str, Any]:
    """The JAX record's ``collectives`` from the tallies of one step:
    ``launches`` and ``tensor_bytes`` keyed ``(op, axis)`` (as
    ``collectives.launches`` and ``collectives.bytes_moved``) or
    ``"op/axis"``; ``axis_sizes`` each axis's group size. Per-device
    on-link bytes by kind (the ring formulas above), their counts and
    total, plus ``by_op_axis``: the tallies themselves."""
    by_kind: Dict[str, float] = {}
    count_by_kind: Dict[str, int] = {}
    by_op_axis: Dict[str, Dict[str, int]] = {}
    for key in sorted(launches, key=str):
        op, axis = key.split("/") if isinstance(key, str) else key
        n, nbytes = int(launches[key]), int(tensor_bytes[key])
        by_op_axis[f"{op}/{axis}"] = {"count": n, "bytes": nbytes}
        g = int(axis_sizes[axis])
        if g <= 1 or n == 0:
            continue
        kind = KINDS[op]
        vol = nbytes * ((g - 1) / g)
        if op == "all_reduce":
            vol = 2.0 * nbytes * ((g - 1) / g)
        by_kind[kind] = by_kind.get(kind, 0.0) + vol
        count_by_kind[kind] = count_by_kind.get(kind, 0) + n
    return {"bytes_by_kind": by_kind, "count_by_kind": count_by_kind,
            "total_bytes": sum(by_kind.values()),
            "by_op_axis": by_op_axis}


@contextlib.contextmanager
def fake_process_mesh(shape, device):
    """Rank 0 of a fake process group of ``prod(shape)`` ranks, and the
    process mesh of ``shape`` over ``runtime.MESH_AXES`` on it (every
    rank's device is ``device``); the group is left on exit. Refuses to
    run inside a process that already holds a process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized; the "
                           "collectives' trace needs a fake one of its own")
    shape = tuple(int(s) for s in shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield R.process_mesh(shape, R.MESH_AXES[len(shape)], device)
    finally:
        dist.destroy_process_group()


def _fake_tree(tree: Any, device) -> Any:
    """Fake tensors (inside an active FakeTensorMode) of a meta tree."""
    if isinstance(tree, dict):
        return {k: _fake_tree(v, device) for k, v in tree.items()}
    return torch.empty(tree.shape, dtype=tree.dtype, device=device)


def _tallies() -> Dict[str, Dict[str, int]]:
    out = {"launches": {f"{op}/{axis}": n for (op, axis), n in
                        sorted(C.launches.items())},
           "tensor_bytes": {f"{op}/{axis}": n for (op, axis), n in
                            sorted(C.bytes_moved.items())}}
    C.reset_counts()
    return out


def trace_decode(cfg, shape, pm, *, quant: Optional[str] = None
                 ) -> Dict[str, Dict[str, int]]:
    """:func:`trace_step` of a decode cell: the serve step on rank
    ``pm.rank``'s blocks (``sharding.decode_pspecs``) of the params
    (``serving.quantize_for_serving``'s tree with ``quant="ternary"``),
    a cache of ``shape.seq_len`` slots and the rank's rows of
    ``shape.global_batch`` tokens. Raises the step's refusals
    (``layers.check_sharded_decode``)."""
    from repro_torch.serving.serve import quantize_for_serving
    model = build_model(cfg)
    b = shape.global_batch
    with FakeTensorMode():
        params = _fake_tree(model.abstract_params(), pm.device)
        if quant == "ternary":
            params = quantize_for_serving(params)[0]
        cache = _fake_tree(ST.abstract_cache(cfg, shape), pm.device)
        tokens = torch.zeros((b, 1), dtype=torch.int32, device=pm.device)
        specs = SH.decode_pspecs(cfg, pm, params, cache, b)
        blocks = SH.local_block(params, specs["params"], pm)
        cache_b = SH.local_block(cache, specs["cache"], pm)
        rows = SH.local_block(tokens, specs["tokens"], pm)
        del params, cache
        C.reset_counts()
        with torch.no_grad(), pm:
            ST.make_serve_step(cfg)(blocks, cache_b, rows)
    return _tallies()


def trace_step(cfg, shape, pm, *, remat: bool = True,
               quant: Optional[str] = None) -> Dict[str, Dict[str, int]]:
    """The collectives rank ``pm.rank`` issues in one step of cell
    ``shape`` (a ``configs.shapes.ShapeSpec``) over the process mesh
    ``pm``, traced on fake tensors of ``pm.device``: ``{"launches":
    {"op/axis": n}, "tensor_bytes": {"op/axis": bytes}}``. A train cell
    runs ``Trainer._step_fn`` (with ``remat``, as the dry run's train
    step); a prefill cell ``Model.apply`` under the mesh, without
    gradients; a decode cell the serve step (:func:`trace_decode`, with
    ``quant``). Raises what the step raises (``refuse_unsupported``'s
    and ``check_sharded_decode``'s ``NotImplementedError`` among
    them)."""
    from repro_torch.training import Trainer, TrainerConfig
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.trainer import state_shardings
    if shape.kind == "decode":
        return trace_decode(cfg, shape, pm, quant=quant)
    model = build_model(cfg)
    tr = Trainer(model, TrainerConfig(remat=remat), batch_fn=None,
                 shardings=state_shardings(model, pm), device=pm.device)
    with FakeTensorMode():
        whole = _fake_tree(model.abstract_params(), pm.device)
        params = SH.local_block(whole, tr.specs["params"], pm)
        del whole
        rows = tr.local_batch(_fake_tree(ST.input_specs(cfg, shape),
                                         pm.device))
        C.reset_counts()
        if shape.kind == "train":
            tr._step_fn(params, adamw_init(params),
                        torch.zeros((), device=pm.device), rows)
        else:
            with torch.no_grad(), pm:
                ST.make_prefill_step(cfg)(params, rows)
    return _tallies()


def mesh_collectives(cfg, shape, mesh, device, *, remat: bool = True,
                     quant: Optional[str] = None) -> Dict[str, Any]:
    """A cell's ``collectives`` record on ``mesh`` (a production mesh:
    its shape and axis names): :func:`collective_bytes` of
    :func:`trace_step` over a fake process mesh of the same shape, or
    ``{"error": reason}`` where the step cannot be traced (a model, mesh
    or batch the sharded trainer refuses; a decode layout the sharded
    serve step has no rule for). Any other
    failure raises, a missing fake backend included."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    try:
        with fake_process_mesh(tuple(sizes.values()), device) as pm:
            tallies = trace_step(cfg, shape, pm, remat=remat, quant=quant)
    except (NotImplementedError, ValueError) as e:
        return {"error": f"{type(e).__name__}: {e}"}
    return {**collective_bytes(tallies["launches"], tallies["tensor_bytes"],
                               sizes), "step": shape.kind,
            "remat": remat if shape.kind == "train" else None,
            "quant": quant if shape.kind == "decode" else None}
