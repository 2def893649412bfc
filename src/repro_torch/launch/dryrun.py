"""Dry run of every (arch x shape) cell on fake tensors (port of
``repro.launch.dryrun``).

For each cell of ``configs.shapes.cells_for`` this answers, without
weights or device memory:
  * does the step trace: the port's own step (``launch.steps``), run once
    under ``torch._subclasses.fake_tensor.FakeTensorMode`` on an explicit
    device (``cuda`` on the card, so every branch on ``is_cuda`` takes the
    card's path; ``cpu`` in the tests). Nothing is allocated and no
    kernel is launched: K3 and K4 return shape-only outputs and keep
    tallies of their calls and FLOPs (``kernels.ternary_matmul`` and
    ``kernels.wkv6_scan``, ``shape_only_*``);
  * how many FLOPs it takes: ``torch.utils.flop_counter.FlopCounterMode``
    over the trace (matmuls, einsums and convolutions, forward, backward
    and remat's recompute) plus K3's and K4's tallies;
  * does it fit: the bytes of params, optimizer state, cache, inputs and
    outputs, the peak of live bytes over the step
    (``torch.distributed._tools.mem_tracker.MemTracker``: the total, since
    the port's params are a dict, not module parameters) against the
    card's memory (its ``total_memory`` on the card, 80 GB stated
    elsewhere); and each device's argument bytes on the JAX package's
    production meshes (``pod16x16``, ``pod2x16x16``): every leaf's bytes
    over the product of the axis sizes in its spec
    (``distributed.sharding``);
  * what each device sends over the links in a step on those meshes
    (``collectives``, the role of the JAX package's
    ``launch/hlo_analysis.py``): one rank's sharded step -- the one
    ``Trainer(shardings=...)`` runs, with remat; a prefill cell's
    forward -- traced on fake tensors over a fake process group of the
    mesh's world, its collectives tallied by ``distributed.collectives``
    and turned into the JAX record's ``bytes_by_kind``, ``count_by_kind``
    and ``total_bytes`` (``launch.collective_analysis``); a decode cell's
    serve step on the rank's blocks, as the JAX dry run jits it (a
    ``long_500k`` cell's B=1 on context-parallel caches: the KV sequence,
    rwkv6's dk and zamba2's SSM head dim over ``data``). A cell that
    cannot be traced holds its reason under ``"error"``: a model the
    sharded trainer refuses, or a layout the serve step has no rule for.

What the JAX dry run records and this one leaves out:
  * the ``L1``/``L2`` depth variants: XLA counts a scan body once, so the
    JAX package fits an affine model to two shallow compiles; the port's
    steps loop over the layers in Python and ``FlopCounterMode`` counts
    every layer the loop runs, so the full-depth count is exact;
  * ``bytes_accessed``/``transcendentals``: no counter of the port's
    sees them.

Records are JSON, one file per cell (both meshes in it), written to
``REPRO_DRYRUN_OUT`` (default ``results/dryrun_torch/``), with the JAX
record's keys where the meaning is the same.

Usage:
  python -m repro_torch.launch.dryrun                  # every cell, the card
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --quant ternary  # ternary decode cells
  python -m repro_torch.launch.dryrun --device cpu ... # fake CPU tensors

A cell that fails to trace is recorded with ``"status": "error"`` and its
reason, and the CLI then exits 1.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import time
import traceback
from typing import Any, Dict, Optional

import torch
import torch.utils._pytree as pytree
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs.shapes import SHAPES, ShapeSpec, cells_for
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.sharding import _quantized_pspecs
from repro_torch.distributed.mesh import Mesh
from repro_torch.kernels import ternary_matmul as k3
from repro_torch.kernels import wkv6_scan as k4
from repro_torch.launch import steps as ST
from repro_torch.launch.collective_analysis import mesh_collectives
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.params import tree_map
from repro_torch.serving.serve import quantize_for_serving

__all__ = ["abstract_cell", "tree_bytes", "lower_cell", "analyze",
           "mesh_bytes", "run_cell", "main", "CARD_BYTES"]

OUT_DIR = pathlib.Path(os.environ.get("REPRO_DRYRUN_OUT",
                                      "results/dryrun_torch"))
# The memory a cell must fit when the trace is not on a card: one H100's
# 80 GB (data sheet).
CARD_BYTES = 80_000_000_000
_MESHES = {"single": ("pod16x16",), "multi": ("pod2x16x16",),
           "both": ("pod16x16", "pod2x16x16")}


def _ternary(shape: ShapeSpec, quant: Optional[str]) -> bool:
    return quant == "ternary" and shape.kind == "decode"


def abstract_cell(cfg, shape: ShapeSpec,
                  quant: Optional[str] = None) -> Dict[str, Any]:
    """Meta-tensor trees of a cell's step arguments: ``params`` (through
    ``quantize_for_serving`` for a ternary decode cell), ``opt`` (train
    cells), ``cache`` (decode cells) and ``inputs``."""
    params = build_model(cfg).abstract_params()
    if _ternary(shape, quant):
        params, _ = quantize_for_serving(params)
    trees = {"params": params, "inputs": ST.input_specs(cfg, shape)}
    if shape.kind == "train":
        trees["opt"] = ST.abstract_opt_state(cfg)
    if shape.kind == "decode":
        trees["cache"] = ST.abstract_cache(cfg, shape)
    return trees


def tree_bytes(tree: Any) -> int:
    """Bytes of every tensor leaf of a tree (dicts, lists, tuples)."""
    return sum(x.numel() * x.element_size()
               for x in pytree.tree_leaves(tree)
               if isinstance(x, torch.Tensor))


def _step(cfg, shape: ShapeSpec, trees: Dict[str, Any]):
    """The cell's step function and its arguments, as ``Trainer`` and the
    serving CLI run them (a train step with remat)."""
    if shape.kind == "train":
        return (ST.make_train_step(cfg, remat=True),
                (trees["params"], trees["opt"], trees["inputs"]))
    if shape.kind == "prefill":
        return ST.make_prefill_step(cfg), (trees["params"], trees["inputs"])
    return (ST.make_serve_step(cfg),
            (trees["params"], trees["cache"], trees["inputs"]["tokens"]))


def lower_cell(cfg, shape: ShapeSpec, device, *,
               quant: Optional[str] = None) -> Dict[str, Any]:
    """Trace one cell's step on fake tensors of ``device``. Returns the
    FLOP counts (``FlopCounterMode``'s, by op, and K3's and K4's
    tallies), the peak of live bytes, the argument trees' and the
    outputs' bytes and the trace's seconds."""
    dev = torch.device(device)
    abstract = abstract_cell(cfg, shape, quant)
    tallies = (k3.shape_only_calls, k3.shape_only_flops,
               k4.shape_only_calls, k4.shape_only_flops)
    t0 = time.perf_counter()
    with FakeTensorMode():
        trees = {name: tree_map(lambda t: torch.empty(
                     t.shape, dtype=t.dtype, device=dev), tree)
                 for name, tree in abstract.items()}
        step, args = _step(cfg, shape, trees)
        tracker = MemTracker()
        tracker.track_external(*pytree.tree_leaves(args))
        with tracker, FlopCounterMode(display=False) as counter:
            out = step(*args)
        peak = sum(snap.get("Total", 0) for snap in
                   tracker.get_tracker_snapshot("peak").values())
        out_bytes = tree_bytes(out)
    seconds = time.perf_counter() - t0
    by_op = {str(op): int(n) for op, n in
             counter.get_flop_counts().get("Global", {}).items()}
    return {
        "counted_flops": int(counter.get_total_flops()),
        "flops_by_op": by_op,
        "k3": {"calls": k3.shape_only_calls - tallies[0],
               "flops": k3.shape_only_flops - tallies[1]},
        "k4": {"calls": k4.shape_only_calls - tallies[2],
               "flops": k4.shape_only_flops - tallies[3]},
        "peak_bytes": int(peak),
        "bytes": {name: tree_bytes(tree) for name, tree in abstract.items()},
        "output_bytes": out_bytes,
        "trace_s": seconds,
        "abstract": abstract,
    }


def _capacity(dev: torch.device):
    if dev.type == "cuda":
        return (torch.cuda.get_device_properties(dev).total_memory,
                torch.cuda.get_device_name(dev))
    return CARD_BYTES, "stated: one H100's 80 GB"


def analyze(lowered: Dict[str, Any], device) -> Dict[str, Any]:
    """The record's ``full`` section from :func:`lower_cell`'s result."""
    dev = torch.device(device)
    nbytes = lowered["bytes"]
    capacity, source = _capacity(dev)
    args = sum(nbytes.values())
    return {
        "flops": (lowered["counted_flops"] + lowered["k3"]["flops"]
                  + lowered["k4"]["flops"]),
        "counted_flops": lowered["counted_flops"],
        "flops_by_op": lowered["flops_by_op"],
        "k3": lowered["k3"], "k4": lowered["k4"],
        "memory": {
            "param_bytes": nbytes["params"],
            "opt_bytes": nbytes.get("opt", 0),
            "cache_bytes": nbytes.get("cache", 0),
            "input_bytes": nbytes["inputs"],
            "argument_bytes": args,
            "output_bytes": lowered["output_bytes"],
            "peak_bytes": lowered["peak_bytes"],
            "capacity_bytes": capacity,
            "capacity_of": source,
        },
        "fits": lowered["peak_bytes"] <= capacity,
    }


def _per_device(tree, specs, sizes: Dict[str, int]) -> int:
    """Bytes a device holds of ``tree`` laid out by ``specs``: each leaf's
    bytes over the product of the axis sizes its spec names."""
    if isinstance(tree, dict):
        return sum(_per_device(tree[k], specs[k], sizes) for k in tree)
    shards = 1
    for entry in specs:
        for axis in (entry if isinstance(entry, tuple) else (entry,)):
            if axis is not None:
                shards *= sizes[axis]
    return tree.numel() * tree.element_size() // shards


def mesh_bytes(cfg, shape: ShapeSpec, abstract: Dict[str, Any], mesh: Mesh,
               quant: Optional[str] = None) -> Dict[str, Any]:
    """Each device's argument bytes of a cell on ``mesh``, by kind, with
    the JAX dry run's specs: params in the train (FSDP) layout for every
    step kind (``_quantized_pspecs`` for ternary leaves), AdamW state as
    the params, the batch over (pod, data), the cache by
    ``cache_pspecs``."""
    defs = build_model(cfg).defs()
    pspecs = SH.param_pspecs(defs, mesh, mode="train")
    if _ternary(shape, quant):
        pspecs = _quantized_pspecs(pspecs, abstract["params"], mesh)
    specs = {"params": pspecs}
    if shape.kind == "decode":
        specs["inputs"] = {"tokens": SH.spec(SH._batch_dim_spec(
            mesh, shape.global_batch), None)}
        specs["cache"] = SH.cache_pspecs(cfg, mesh, abstract["cache"],
                                         shape.global_batch)
    else:
        bspecs = SH.batch_pspecs(cfg, mesh, shape.global_batch, shape.kind)
        specs["inputs"] = {k: bspecs.get(k, ()) for k in abstract["inputs"]}
    if shape.kind == "train":
        specs["opt"] = SH.opt_pspecs(defs, mesh)
    by_kind = {name: _per_device(abstract[name], specs[name], mesh.shape)
               for name in abstract}
    return {"num_devices": mesh.size,
            "argument_bytes": sum(by_kind.values()), "by_kind": by_kind}


def _out_path(arch: str, shape_name: str, quant: Optional[str]):
    suffix = f"__{quant}" if quant else ""
    return OUT_DIR / f"{arch}__{shape_name}{suffix}.json"


def run_cell(arch: str, shape_name: str, *, meshes=_MESHES["both"],
             force: bool = False, quant: Optional[str] = None,
             device=None) -> dict:
    """Trace one cell and write its record (or return the record already
    written, unless ``force``)."""
    out_path = _out_path(arch, shape_name, quant)
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    dev = resolve_device(device)
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "param_count": cfg.param_count(),
        "active_param_count": cfg.active_param_count(),
        "quant": quant if _ternary(shape, quant) else None,
        "device": str(dev),
        "status": "running",
    }
    t0 = time.time()
    try:
        lowered = lower_cell(cfg, shape, dev, quant=quant)
        rec["full"] = analyze(lowered, dev)
        rec["trace_s"] = round(lowered["trace_s"], 1)
        rec["meshes"] = {}
        for name in meshes:
            mesh = make_production_mesh(multi_pod=name == "pod2x16x16")
            rec["meshes"][name] = {
                **mesh_bytes(cfg, shape, lowered["abstract"], mesh, quant),
                "collectives": mesh_collectives(
                    cfg, shape, mesh, dev,
                    quant=quant if _ternary(shape, quant) else None)}
        rec["status"] = "ok"
    except Exception as e:   # a cell's failure is its record's result
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["total_s"] = round(time.time() - t0, 1)
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS + [None])
    ap.add_argument("--shape", default=None,
                    choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="both", choices=list(_MESHES),
                    help="the production meshes whose per-device bytes "
                         "the records hold")
    ap.add_argument("--no-depth-variants", action="store_true",
                    help="accepted for the JAX CLI's form: the port "
                         "counts every layer and has no depth variants")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--quant", default=None, choices=["ternary", None])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCHS
    n_ok = n_err = 0
    for arch in archs:
        cells = cells_for(get_config(arch))
        if args.shape:
            cells = [SHAPES[args.shape]]
        if args.quant:
            cells = [c for c in cells if c.kind == "decode"]
        for cell in cells:
            rec = run_cell(arch, cell.name, meshes=_MESHES[args.mesh],
                           force=args.force, quant=args.quant,
                           device=args.device)
            ok = rec["status"] == "ok"
            n_ok += ok
            n_err += not ok
            print(f"[{time.strftime('%H:%M:%S')}] {arch} x {cell.name}"
                  f"{' x ' + args.quant if args.quant else ''}:"
                  f" {rec['status']} ({rec.get('total_s', 0)}s)"
                  + ("" if ok else f"  {rec.get('error', '')[:200]}"),
                  flush=True)
    print(f"dry-run done: {n_ok} ok, {n_err} errors")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
