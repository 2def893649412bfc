"""Rank functions and set-up shared by the sharded-training tests
(``test_torch_dist_train.py``, ``test_torch_dist_checkpoint.py``,
``test_torch_cuda_dist_train.py``).

``runtime.spawn`` starts each rank in a fresh process that imports this
module by name, so it imports nothing of JAX. Every rank and the parent
draw the same SMOKE params from a seeded CPU generator (rwkv6's ``u``,
``mu``, ``mu_k`` and ``mu_r`` and zamba2's ``a_log``, ``dt_bias``,
``d_skip``, ``conv_b`` and ``norm_s`` from a numpy seed, since they init
to constants) and the same batches from numpy seeds, with random pads in
every row (so the data ranks' token counts differ), and per family the
VLM's patch embeddings or the enc-dec's encoder frames. A rank function writes
its results under a directory the test gives it (rank 0 the whole
arrays, ``sharding.gather_logical``).
"""
from __future__ import annotations

import json
import math
import os
import pickle

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import annotate as A
from repro_torch.distributed import collectives as C
from repro_torch.distributed import runtime as R
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.models import build_model
from repro_torch.models import zamba2 as ZB
from repro_torch.models.params import tree_map
from repro_torch.training import (AdamWConfig, Trainer, TrainerConfig,
                                  adamw_init)
from repro_torch.training.trainer import (SimulatedFailure, reduce_grads,
                                          state_shardings)

ARCHS = ("llama3.2-1b", "rwkv6-7b", "deepseek-moe-16b",
         "llama4-scout-17b-a16e", "qwen2-vl-2b", "zamba2-1.2b",
         "seamless-m4t-medium")
MOE_ARCHS = tuple(a for a in ARCHS if get_config(a, smoke=True).family
                  == "moe")
# One arch of each of the vlm, zamba2 and encdec families.
FAMILY_ARCHS = ("qwen2-vl-2b", "zamba2-1.2b", "seamless-m4t-medium")
MAMBA_ARCH = "zamba2-1.2b"
# (data, model) meshes, then (pod, data, model): runtime.MESH_AXES by the
# number of dims.
MESHES = ((2, 2), (4, 1), (1, 4), (2, 2, 1), (2, 1, 2))
BATCH, SEQ, STEPS, LR = 4, 16, 3, 1e-3
PATCHES = 4          # the VLM's patch rows (a 2 x 2 grid) at the head
# Global batches that do not divide every batch axis, and the 1-D
# ("data",) mesh, as (mesh, batch), for BATCH_ARCHS: 3 rows over (2, 2)
# are copied over 'data'; 2 rows over (2, 2, 1) are split over 'pod'
# alone and copied over 'data'.
BATCH_MESHES = (((2, 2), 3), ((2, 2, 1), 2), ((4,), 4))
BATCH_ARCHS = ("llama3.2-1b", "deepseek-moe-16b")


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def case_name(arch: str, shape, batch: int = BATCH) -> str:
    """The file stem of a sharded run's results."""
    return f"{arch}_{mesh_name(shape)}" + (
        "" if batch == BATCH else f"_b{batch}")


def sizes(shape):
    """{axis: size} of a mesh shape over ``runtime.MESH_AXES``."""
    return dict(zip(R.MESH_AXES[len(shape)], shape))


def row_blocks(shape, batch: int = BATCH) -> int:
    """The blocks a global batch of ``batch`` rows is cut into over a
    mesh of ``shape`` (``batch_pspecs``: the prefix of (pod, data) that
    divides it)."""
    n = 1
    for a in ("pod", "data"):
        if batch % (n * sizes(shape).get(a, 1)) == 0:
            n *= sizes(shape).get(a, 1)
    return n


def params(arch: str, seed: int = 0, device="cpu"):
    """The SMOKE params of ``arch`` (f32) as CPU tensors."""
    model = build_model(get_config(arch, smoke=True))
    p = model.init(torch.Generator().manual_seed(seed), device="cpu")
    if model.cfg.family == "rwkv6":
        rng = np.random.default_rng(seed)
        tm, cm = p["layers"]["tm"], p["layers"]["cm"]
        tm["u"] = torch.from_numpy(
            (rng.normal(size=tm["u"].shape) * 0.5).astype(np.float32))
        for tree, key in ((tm, "mu"), (cm, "mu_k"), (cm, "mu_r")):
            tree[key] = torch.from_numpy(
                rng.uniform(0.0, 1.0, tree[key].shape).astype(np.float32))
    if model.cfg.family == "zamba2":
        rng = np.random.default_rng(seed + 1)
        lay = p["layers"]
        for key, lo, hi in (("a_log", -1.0, 1.0), ("dt_bias", -1.0, 0.5),
                            ("d_skip", 0.5, 1.5), ("conv_b", -0.2, 0.2),
                            ("norm_s", 0.5, 1.5)):
            lay[key] = torch.from_numpy(
                rng.uniform(lo, hi, lay[key].shape).astype(np.float32))
    return tree_map(lambda x: x.to(device), p)


def start_state(arch: str, seed: int = 0, device="cpu"):
    p = params(arch, seed, device)
    return {"params": p, "opt": adamw_init(p),
            "err": torch.zeros((), device=device)}


def np_batch(vocab: int, step: int, batch: int = BATCH, seq: int = SEQ):
    """Tokens and targets of ``step`` (numpy int64), ~30% pads."""
    rng = np.random.default_rng(1000 + step)
    tokens = rng.integers(0, vocab, (batch, seq))
    targets = np.where(rng.random((batch, seq)) < 0.3, -1, tokens)
    return tokens, targets


def np_inputs(arch: str, step: int, batch: int = BATCH):
    """The whole batch of ``step`` (numpy): ``np_batch``'s tokens and
    targets, and the VLM's ``patch_embeds`` (B, PATCHES, D) or the
    enc-dec's ``frames`` (B, SEQ, frontend_dim), f32 from a numpy
    seed."""
    cfg = get_config(arch, smoke=True)
    t, g = np_batch(cfg.vocab_size, step, batch)
    out = {"tokens": t, "targets": g}
    rng = np.random.default_rng(3000 + step)
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.normal(
            size=(batch, PATCHES, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.normal(
            size=(batch, SEQ, cfg.frontend_dim or cfg.d_model)).astype(
                np.float32)
    return out


def batch_fn(arch: str, device="cpu", batch: int = BATCH):
    def fn(step):
        return {k: torch.from_numpy(v).to(device)
                for k, v in np_inputs(arch, step, batch).items()}
    return fn


def trainer_config(ckpt_dir="unused", ckpt_every=0, steps=STEPS,
                   compression=None):
    return TrainerConfig(
        total_steps=steps, ckpt_every=ckpt_every, ckpt_dir=str(ckpt_dir),
        keep_last=10, log_every=1000, grad_compression_ratio=compression,
        opt=AdamWConfig(lr=LR, warmup_steps=1, total_steps=steps))


def trainer(arch, pmesh=None, device="cpu", batch=BATCH,
            **cfg_kw) -> Trainer:
    model = build_model(get_config(arch, smoke=True))
    sh = None if pmesh is None else state_shardings(
        model, pmesh, cfg_kw.get("compression") is not None)
    return Trainer(model, trainer_config(**cfg_kw),
                   batch_fn(arch, device, batch), shardings=sh,
                   device=device)


def flat(tree, prefix=""):
    """{"/"-joined path: numpy array} of a tree of tensors."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree.detach().cpu().float().numpy()
    return out


def keep_first_step(tr: Trainer) -> dict:
    """Make ``tr`` keep the params and AdamW state its first step makes
    (in the returned dict, as "params" and "opt"), and every step's
    gradient norm before clipping ("grad_norms": the gradients' scale,
    which clipping and AdamW's moments do not show)."""
    first, step_fn = {"grad_norms": []}, tr._step_fn

    def keep(*args):
        out = step_fn(*args)
        if "params" not in first:
            first.update(params=out[0], opt=out[1])
        first["grad_norms"].append(float(out[3]["grad_norm"]))
        return out
    tr._step_fn = keep
    return first


def one_device(arch: str, device="cpu", batch: int = BATCH):
    """The port's one-device Trainer over ``STEPS`` steps: losses, and the
    params and first moments after the first step and after the last
    (flat numpy)."""
    tr = trainer(arch, device=device, batch=batch)
    first = keep_first_step(tr)
    res = tr.run(start_state=start_state(arch, device=device))
    st = res["state"]
    return dict(losses=[h["loss"] for h in res["history"]],
                grad_norms=first["grad_norms"],
                params=flat(st["params"]), m=flat(st["opt"]["m"]),
                params1=flat(first["params"]), m1=flat(first["opt"]["m"]))


class Recorder:
    """Records, on this rank, each ``ops.wkv6_scan`` call's r shape, each
    zamba2 SSD scan's (``mamba2_chunked``) x shape, and each
    ``unshard_fsdp`` layout (block spec, chosen layout, block shape)."""

    def __init__(self):
        self.wkv, self.ssd, self.layouts = [], [], set()
        self._wkv, self._gather = ops.wkv6_scan, A.gather_at_use
        self._ssd = ZB.mamba2_chunked

    def __enter__(self):
        def wkv(r, *a, **k):
            self.wkv.append(list(r.shape))
            return self._wkv(r, *a, **k)

        def ssd(x, *a, **k):
            self.ssd.append(list(x.shape))
            return self._ssd(x, *a, **k)

        def gather(w, *cands):
            out, lay = self._gather(w, *cands)
            if lay is not None:
                self.layouts.add((tuple(w.shape), A.spec_of(w), lay))
            return out, lay
        ops.wkv6_scan, A.gather_at_use = wkv, gather
        ZB.mamba2_chunked = ssd
        return self

    def __exit__(self, *exc):
        ops.wkv6_scan, A.gather_at_use = self._wkv, self._gather
        ZB.mamba2_chunked = self._ssd


def train_rank(rank, world, port, out_dir, device="cpu", backend="gloo",
               meshes=MESHES, archs=ARCHS, batch_meshes=BATCH_MESHES):
    """Every (arch, mesh) of ``ARCHS`` x ``meshes`` over the same ranks,
    then ``BATCH_ARCHS`` over each (mesh, global batch) of
    ``batch_meshes`` of this world's size: ``STEPS`` steps of the sharded
    Trainer from ``start_state``, on the CPU or on ``cuda:(rank %
    cards)``. Rank 0 writes per case the losses, the collective tallies,
    the whole params and moments after the first step and the last; every
    rank writes its WKV and SSD call shapes."""
    torch.set_num_threads(1)
    if device != "cpu":
        device = f"cuda:{rank % torch.cuda.device_count()}"
    pm = R.init("localhost", port, world, rank, backend=backend,
                device=device, shape=meshes[0])
    made = {tuple(meshes[0]): pm}

    def mesh_of(shape):
        if shape not in made:
            made[shape] = R.process_mesh(shape, R.MESH_AXES[len(shape)],
                                         device)
        return made[shape]
    for shape in meshes:
        mesh = mesh_of(shape)
        for arch in archs:
            if arch in MOE_ARCHS:
                moe_rank_call(arch, mesh, out_dir, device)
            if arch == MAMBA_ARCH:
                mamba_rank_call(mesh, out_dir, device)
        for arch in archs:
            train_case(arch, mesh, out_dir, device)
    for shape, batch in batch_meshes:
        if math.prod(shape) == world:
            for arch in BATCH_ARCHS:
                train_case(arch, mesh_of(shape), out_dir, device, batch)


def train_case(arch, mesh, out_dir, device, batch=BATCH):
    """One run of ``train_rank``: ``STEPS`` steps of ``arch`` over
    ``mesh`` on global batches of ``batch`` rows; writes its results."""
    rank = mesh.rank
    tr = trainer(arch, mesh, device, batch)
    first = keep_first_step(tr)
    C.reset_counts()
    with Recorder() as rec:
        res = tr.run(start_state=start_state(arch, device=device))
    counts = {f"{op}/{axis}": n for (op, axis), n in
              sorted(C.launches.items())}
    whole = SH.gather_logical(res["state"], tr.specs, mesh, root=0)
    whole1 = SH.gather_logical(
        {"params": first["params"], "m": first["opt"]["m"]},
        {"params": tr.specs["params"], "m": tr.specs["params"]},
        mesh, root=0)
    case = case_name(arch, mesh.axis_sizes, batch)
    with open(os.path.join(out_dir, f"wkv_{case}_{rank}.json"), "w") as f:
        json.dump({"wkv": rec.wkv, "ssd": rec.ssd}, f)
    if rank == 0:
        with open(os.path.join(out_dir, f"{case}.pkl"), "wb") as f:
            pickle.dump(dict(
                losses=[h["loss"] for h in res["history"]],
                grad_norms=first["grad_norms"],
                counts=counts, layouts=sorted(rec.layouts, key=str),
                params=flat(whole["params"]),
                m=flat(whole["opt"]["m"]),
                params1=flat(whole1["params"]),
                m1=flat(whole1["m"])), f)


def _nest(flat_tree):
    """A tree of dicts from {"/"-joined path: leaf}."""
    out = {}
    for path, leaf in flat_tree.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _paths(tree, prefix=""):
    """{"/"-joined path: leaf} of a tree of dicts."""
    out = {}
    for k, v in tree.items():
        out.update(_paths(v, f"{prefix}{k}/") if isinstance(v, dict)
                   else {prefix + k: v})
    return out


def moe_inputs(arch: str):
    """Layer 0's MoE params of ``arch`` (SMOKE, f32, CPU) by path, an
    input x (B, S, D) and an output cotangent, from numpy seeds."""
    cfg = get_config(arch, smoke=True)
    p = _layer0(arch, "moe/")
    rng = np.random.default_rng(77)
    x = torch.from_numpy(rng.normal(
        size=(BATCH, SEQ, cfg.d_model)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    return cfg, p, x, ct


def moe_call(cfg, p, x, ct, specs=None):
    """``layers.moe_apply`` on the params ``p`` by path (this rank's
    blocks, tagged with ``specs``, under the active process mesh; whole
    tensors without) and ``x``: the output, aux, the gradients of
    ``sum(out * ct) + aux`` with respect to ``p`` (by path) and ``x``,
    and every ``moe_route`` result."""
    from repro_torch.models import layers as L
    routes, real = [], L.moe_route

    def record(*a, **k):
        r = real(*a, **k)
        routes.append({k: r[k].detach() for k in ("gate_idx", "keep",
                                                   "probs")})
        return r
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    lp = {k: v if specs is None else A.tag(v, specs[k])
          for k, v in leaves.items()}
    xin = x.detach().clone().requires_grad_()
    L.moe_route = record
    try:
        out, aux = L.moe_apply(_nest(lp), xin, cfg)
    finally:
        L.moe_route = real
    names = sorted(leaves)
    grads = torch.autograd.grad((out * ct).sum() + aux,
                                [leaves[n] for n in names] + [xin])
    return dict(out=out.detach(), aux=aux.detach(),
                grads=_summed(dict(zip(names, grads[:-1])), specs),
                x_grad=grads[-1], routes=routes)


def _summed(grads, specs):
    """Gradient blocks summed over the batch axes as the trainer sums them
    (``reduce_grads``), under a process mesh."""
    return grads if specs is None else reduce_grads(grads, specs)


def rows_of(mesh, batch: int = BATCH) -> slice:
    """This rank's rows of a global batch of ``batch`` rows
    (``batch_pspecs``)."""
    spec = SH.batch_pspecs(get_config(ARCHS[0], smoke=True), mesh, batch,
                           "train")["tokens"]
    return SH.NamedSharding(mesh, spec).devices_indices_map(
        (batch, 1))[mesh.rank][0]


def moe_rank_call(arch, mesh, out_dir, device="cpu"):
    """Sharded ``moe_apply`` of layer 0 of SMOKE ``arch`` on this rank:
    its rows of ``x`` (its block over ``pod`` and ``data``), its blocks
    of the params;
    every rank writes its output rows, routing and x gradient, rank 0 the
    whole parameter gradients (``gather_logical``)."""
    cfg, p, x, ct = moe_inputs(arch)
    specs = {k: tuple(v)[1:] for k, v in _paths(SH.param_pspecs(
        build_model(cfg).defs(), mesh)["layers"]["moe"]).items()}
    blocks = SH.local_block(p, specs, mesh, device)
    rows = rows_of(mesh)
    with mesh:
        res = moe_call(cfg, blocks, x[rows].to(device), ct[rows].to(device),
                       specs)
    whole = SH.gather_logical(res["grads"], specs, mesh, root=0)
    case = f"{arch}_{mesh_name(mesh.axis_sizes)}"
    with open(os.path.join(out_dir, f"moe_{case}_{mesh.rank}.pkl"),
              "wb") as f:
        pickle.dump(dict(
            rows=(rows.start, rows.stop), coords=dict(mesh.coords),
            out=res["out"].cpu().numpy(), aux=float(res["aux"]),
            x_grad=res["x_grad"].cpu().numpy(),
            routes=[{k: v.cpu().numpy() for k, v in r.items()}
                    for r in res["routes"]],
            grads=({k: v.cpu().numpy() for k, v in whole.items()}
                   if mesh.rank == 0 else None)), f)


def _layer0(arch: str, tree: str, drop=()):
    """Layer 0 of the stacked subtree ``tree`` of ``arch``'s SMOKE params
    by path, without the leaves in ``drop``."""
    p = _paths(tree_map(lambda t: t[0], params(arch)["layers"]))
    return {k[len(tree):]: v for k, v in p.items()
            if k.startswith(tree) and k[len(tree):] not in drop}


def mamba_inputs():
    """Layer 0's Mamba-2 params of SMOKE zamba2 (f32, CPU; all but the
    pre-norm ``ln``, which the caller applies) by path, an input x
    (B, S, D) and an output cotangent, from numpy seeds."""
    cfg = get_config(MAMBA_ARCH, smoke=True)
    p = _layer0(MAMBA_ARCH, "", drop=("ln",))
    rng = np.random.default_rng(78)
    x = torch.from_numpy(rng.normal(
        size=(BATCH, SEQ, cfg.d_model)).astype(np.float32))
    ct = torch.from_numpy(rng.normal(size=x.shape).astype(np.float32))
    return cfg, p, x, ct


def mamba_call(cfg, p, x, ct, specs=None):
    """``zamba2._mamba_forward`` on the params ``p`` by path (this rank's
    blocks, tagged with ``specs``, under the active process mesh; whole
    tensors without) and ``x``: the output, the SSM state it leaves, the
    gradients of ``sum(out * ct)`` with respect to ``p`` (by path; summed
    over the batch axes as the trainer sums them) and ``x``, and the x
    shape of every SSD scan."""
    seen, real = [], ZB.mamba2_chunked

    def record(xs, *a, **k):
        seen.append(list(xs.shape))
        return real(xs, *a, **k)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    lp = {k: v if specs is None else A.tag(v, specs[k])
          for k, v in leaves.items()}
    xin = x.detach().clone().requires_grad_()
    ZB.mamba2_chunked = record
    try:
        out, (_, state) = ZB._mamba_forward(_nest(lp), xin, cfg)
    finally:
        ZB.mamba2_chunked = real
    names = sorted(leaves)
    got = torch.autograd.grad((out * ct).sum(),
                              [leaves[n] for n in names] + [xin])
    return dict(out=out.detach(), state=state.detach(),
                grads=_summed(dict(zip(names, got[:-1])), specs),
                x_grad=got[-1], ssd=seen)


def mamba_rank_call(mesh, out_dir, device="cpu"):
    """Sharded ``_mamba_forward`` of layer 0 of SMOKE zamba2 on this rank:
    its rows of ``x`` (its block over ``pod`` and ``data``), its blocks
    of the params;
    every rank writes its output rows, its heads' SSM state, its x
    gradient and its SSD shapes, rank 0 the whole parameter gradients
    (``gather_logical``)."""
    cfg, p, x, ct = mamba_inputs()
    specs = {k: tuple(v)[1:] for k, v in _paths(SH.param_pspecs(
        build_model(cfg).defs(), mesh)["layers"]).items() if k in p}
    blocks = SH.local_block(p, specs, mesh, device)
    rows = rows_of(mesh)
    with mesh:
        res = mamba_call(cfg, blocks, x[rows].to(device),
                         ct[rows].to(device), specs)
    whole = SH.gather_logical(res["grads"], specs, mesh, root=0)
    case = f"{MAMBA_ARCH}_{mesh_name(mesh.axis_sizes)}"
    with open(os.path.join(out_dir, f"mamba_{case}_{mesh.rank}.pkl"),
              "wb") as f:
        pickle.dump(dict(
            rows=(rows.start, rows.stop), coords=dict(mesh.coords),
            heads=_heads(cfg, mesh),
            out=res["out"].cpu().numpy(), state=res["state"].cpu().numpy(),
            x_grad=res["x_grad"].cpu().numpy(), ssd=res["ssd"],
            grads=({k: v.cpu().numpy() for k, v in whole.items()}
                   if mesh.rank == 0 else None)), f)


def _heads(cfg, mesh):
    """The [lo, hi) of this rank's block of the SSD heads over 'model'."""
    step = cfg.ssm_heads // mesh.axis_size("model")
    return (mesh.coord("model") * step, (mesh.coord("model") + 1) * step)


def compare(got_p, got_m, want_p, want_m, lr):
    """chip_smoke's ``_lt_compare`` measures on flat numpy trees: the
    first moments' worst difference as a share of each leaf's largest,
    and the params' differences over ``lr`` where the moment is well
    above its own error (confident) and over their bound 2 lr (1 + wd
    |p|) everywhere."""
    out = dict(m_rel=0.0, param_confident=0.0, param_bounded=0.0)
    for k in want_p:
        pa, pc, ma, mc = got_p[k], want_p[k], got_m[k], want_m[k]
        top = float(np.abs(mc).max())
        if top > 0:
            out["m_rel"] = max(out["m_rel"],
                               float(np.abs(ma - mc).max()) / top)
        sure = (np.abs(mc) >= 1e-3 * top) & (np.abs(mc) > 0.1 * 1e-6)
        d = np.abs(pa - pc)
        if sure.any():
            out["param_confident"] = max(out["param_confident"],
                                         float(d[sure].max()) / lr)
        out["param_bounded"] = max(out["param_bounded"], float(
            (d / (2 * lr * (1 + 0.1 * np.abs(pc)))).max()))
    return out


# ----------------------------------------------------------------------
# test_torch_dist_checkpoint.py
# ----------------------------------------------------------------------

COMP_RATIO = 0.05
COMP_SPECS = {"a": ("data", "model"), "b": {"w": ("model",)}}


def grad_tree(step: int):
    """Gradient-like leaves with ties at the threshold (many equal
    magnitudes, both signs, and a zero row)."""
    rng = np.random.default_rng(step)
    g = {"a": rng.normal(size=(40, 24)).astype(np.float32),
         "b": {"w": rng.normal(size=(336,)).astype(np.float32)}}
    g["b"]["w"][:60] = np.where(np.arange(60) % 2, 0.5, -0.5)
    g["a"][0, :] = 0.0
    g["a"][5:9, :6] = np.float32(1.25)
    return g


# The MoE leaves' layouts on a (2, 2) mesh: experts on 'model', the
# embed dims on 'data' (param_pspecs of deepseek-moe-16b, one layer).
MOE_COMP_SPECS = {"router": ("data", "model"),
                  "we_up": ("model", "data", None),
                  "we_down": ("model", None, "data")}


def moe_grad_tree(step: int):
    """MoE-shaped gradient leaves (8 experts) with ties at the threshold
    and a zero expert."""
    rng = np.random.default_rng(50 + step)
    g = {"router": rng.normal(size=(16, 8)).astype(np.float32),
         "we_up": rng.normal(size=(8, 16, 24)).astype(np.float32),
         "we_down": rng.normal(size=(8, 24, 16)).astype(np.float32)}
    g["we_up"][3] = 0.0
    g["we_up"][5, :4, :6] = np.float32(-1.5)
    g["we_down"][:, 0, :] = np.where(np.arange(16) % 2, 1.5, -1.5)
    g["router"][2:4, :] = np.float32(1.5)
    return g


def crash_at(step_to_fail: int, error=SimulatedFailure):
    """A failure hook that raises ``error`` once, at ``step_to_fail``."""
    done = []

    def hook(step):
        if step == step_to_fail and not done:
            done.append(step)
            raise error("simulated node failure")
    return hook


def fail_rank(rank, world, port, out_dir, failing):
    """SMOKE llama3.2-1b over (2, 2) through ``run_with_restarts`` with
    checkpoints every step, where the ranks in ``failing`` raise a plain
    ``RuntimeError`` (not a ``SimulatedFailure``) before step 1."""
    torch.set_num_threads(1)
    pm = R.init("localhost", port, world, rank, backend="gloo",
                device="cpu", shape=(2, 2), timeout_s=60.0)
    tr = trainer("llama3.2-1b", pm, ckpt_dir=out_dir, ckpt_every=1)
    hook = crash_at(1, RuntimeError) if rank in failing else None
    tr.run_with_restarts(torch.Generator().manual_seed(7), failure_hook=hook)


def _collective_checks(pm):
    """Each autograd collective over 'data' on (2, 2) against its
    definition on whole tensors: forward values and the gradient of a
    rank-dependent cotangent, summed over the ranks where the op's
    convention sums (bit for bit: small integers)."""
    def rank_x(shape, rank_dep=True):
        base = torch.arange(np.prod(shape), dtype=torch.float32)
        return (base.reshape(shape) + (100.0 * pm.rank if rank_dep else 0))

    d, i = pm.axis_size("data"), pm.coord("data")
    peers = [r for r in range(pm.size)
             if dict(zip(pm.axis_names, np.unravel_index(r, pm.axis_sizes)))
             ["model"] == pm.coord("model")]
    out = {}
    with pm:
        # all_gather: blocks joined; gradient summed over ranks, own block
        x = rank_x((2, 3)).requires_grad_()
        y = C.all_gather(x, 0, "data")
        g = rank_x((2 * d, 3))
        (gx,) = torch.autograd.grad(y, x, g)
        want_y = torch.cat([rank_x((2, 3)) - 100.0 * pm.rank + 100.0 * r
                            for r in peers])
        want_g = sum(rank_x((2 * d, 3)) - 100.0 * pm.rank + 100.0 * r
                     for r in peers)[2 * i:2 * i + 2]
        out["all_gather"] = bool(torch.equal(y, want_y)
                                 and torch.equal(gx, want_g))
        # reduce_scatter: sum, own block; gradient all-gathered
        x = rank_x((2 * d, 3)).requires_grad_()
        y = C.reduce_scatter(x, 0, "data")
        g = rank_x((2, 3))
        (gx,) = torch.autograd.grad(y, x, g)
        summed = sum(rank_x((2 * d, 3)) - 100.0 * pm.rank + 100.0 * r
                     for r in peers)
        want_g = torch.cat([rank_x((2, 3)) - 100.0 * pm.rank + 100.0 * r
                            for r in peers])
        out["reduce_scatter"] = bool(torch.equal(y, summed[2 * i:2 * i + 2])
                                     and torch.equal(gx, want_g))
        flags = torch.tensor([float(v) for v in out.values()])
        for a in pm.axis_names:
            C.all_reduce_(flags, a, torch.distributed.ReduceOp.MIN)
    return {k: bool(v == 1.0) for k, v in zip(out, flags.tolist())}


def _grads(tr, pm, state, batch, remat, thread):
    """The gradients of ``tr.model.loss`` on this rank's blocks: the
    forward under ``pm`` on this thread, the backward here or on another
    thread (where the autograd engine runs it on the card, with no mesh
    active)."""
    import threading
    flat = []

    def live(p, s):
        flat.append(p.detach().requires_grad_())
        return A.tag(flat[-1], s)
    with pm:
        loss, _ = tr.model.loss(tree_map_specs(live, state["params"],
                                               tr.specs["params"]),
                                tr.local_batch(batch), remat=remat)
    out = {}

    def backward():
        out["g"] = torch.autograd.grad(loss, flat, allow_unused=True)
    if thread:
        t = threading.Thread(target=backward)
        t.start()
        t.join()
    else:
        backward()
    return out["g"]


def tree_map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v, specs[k]) for k, v in tree.items()}
    return fn(tree, specs)


def _pod_part(tree, specs, mesh):
    """A rank's part of a whole gradient tree as a step leaves it before
    ``reduce_grads``: each pod's rows give it 1/|pod| of the gradient, and
    a leaf replicated over ``data`` is split evenly over the data ranks
    (powers of two: the sums give back the whole tree exactly)."""
    return tree_map_specs(
        lambda g, s: g / (mesh.axis_size("pod") * (
            1 if "data" in s else mesh.axis_size("data"))), tree, specs)


def _compress_steps(tree_fn, specs, mesh, pod=False):
    """Three steps of ``compress_grads`` with error feedback on this
    rank's blocks of ``tree_fn``'s whole gradients over ``mesh`` (with
    ``pod``: each rank's ``_pod_part`` of them, summed by
    ``reduce_grads`` first, as the trainer sums them); rank 0 gets the
    whole sent gradients, residuals and norms."""
    from repro_torch.training import compress_grads, compression_init
    out = []
    with mesh:
        whole = [tree_map(torch.from_numpy, tree_fn(s)) for s in range(3)]
        err = SH.local_block(compression_init(whole[0]), specs, mesh)
        for g in whole:
            if pod:
                g = reduce_grads(SH.local_block(_pod_part(g, specs, mesh),
                                                specs, mesh), specs)
            else:
                g = SH.local_block(g, specs, mesh)
            sent, err, m = compress_grads(g, err, ratio=COMP_RATIO,
                                          specs=specs)
            out.append(SH.gather_logical({"sent": sent, "err": err},
                                         {"sent": specs, "err": specs},
                                         mesh, root=0))
            out[-1]["norm"] = float(m["compressed_grad_norm"])
    return out


def _everywhere(pm, ok: bool) -> bool:
    """Whether ``ok`` holds on every rank of ``pm``."""
    flag = torch.tensor([float(ok)])
    with pm:
        for a in pm.axis_names:
            C.all_reduce_(flag, a, torch.distributed.ReduceOp.MIN)
    return bool(flag.item() == 1.0)


# The pod meshes of ckpt_rank, and a restore's (name, mesh, source dir).
POD_MESHES = ((2, 2, 1), (2, 1, 2))
RESTORES = (("pod_from_one", (2, 2, 1), "save1"),
            ("pod_from_2x2", (2, 2, 1), "save4_float32"),
            ("2x2_from_pod", (2, 2), "save_pod"))


def ckpt_rank(rank, world, port, out_dir):
    """On a (2, 2) mesh: three steps of ``compress_grads`` on sharded
    leaves, and on the pod meshes on the gradients ``reduce_grads`` sums
    over them; the sharded Trainer's checkpoint of ``start_state`` (f32
    and bf16 params) and (2, 2, 1)'s; each of them, and one device's,
    restored onto another mesh; per arch, a 3-step run with checkpoints
    every step and the same run crashed before step 2 and restarted; then
    a (1, 4) mesh and a (2, 2, 1) mesh relaunched from the (2, 2) run's
    step-2 checkpoint. Rank 0 writes what the test compares."""
    import shutil
    from repro_torch.training.optimizer import tree_leaves
    torch.set_num_threads(1)
    pm = R.init("localhost", port, world, rank, backend="gloo",
                device="cpu", shape=(2, 2))
    pods = {shape: R.process_mesh(shape, R.MESH_AXES[3], "cpu")
            for shape in POD_MESHES}
    res = {"collectives": _collective_checks(pm)}
    for key, tree_fn, specs in (("comp", grad_tree, COMP_SPECS),
                                ("moe_comp", moe_grad_tree, MOE_COMP_SPECS)):
        for s, row in enumerate(_compress_steps(tree_fn, specs, pm)):
            res[f"{key}{s}"] = row
    for key, tree_fn, specs, shape in (
            ("pod_comp", grad_tree, COMP_SPECS, (2, 2, 1)),
            ("pod_moe_comp", moe_grad_tree, MOE_COMP_SPECS, (2, 1, 2))):
        for s, row in enumerate(_compress_steps(tree_fn, specs, pods[shape],
                                                pod=True)):
            res[f"{key}{s}"] = row
    for arch in ARCHS:
        tr = trainer(arch, pm)
        st = SH.local_block(start_state(arch), tr.specs, pm)
        batch = batch_fn(arch)(0)
        want = _grads(tr, pm, st, batch, remat=False, thread=False)
        same = all(
            all(a is b or torch.equal(a, b) for a, b in zip(want, _grads(
                tr, pm, st, batch, remat=remat, thread=True)))
            for remat in (False, True))
        flag = torch.tensor([float(same)])
        with pm:
            for a in pm.axis_names:
                C.all_reduce_(flag, a, torch.distributed.ReduceOp.MIN)
        res[f"thread_backward_{arch}"] = bool(flag.item() == 1.0)
    for dtype in ("float32", "bfloat16"):
        st = start_state("llama3.2-1b")
        st["params"] = tree_map(lambda x: x.to(getattr(torch, dtype)),
                                st["params"])
        tr = trainer("llama3.2-1b", pm, ckpt_dir=os.path.join(
            out_dir, f"save4_{dtype}"))
        tr.save(5, SH.local_block(st, tr.specs, pm))
    for arch in MOE_ARCHS + FAMILY_ARCHS:
        tr = trainer(arch, pm, ckpt_dir=os.path.join(out_dir,
                                                     f"save4_{arch}"))
        tr.save(5, SH.local_block(start_state(arch), tr.specs, pm))
    # llama3.2-1b's start state written by (2, 2, 1) and by one device,
    # then each restore of RESTORES against the rank's blocks
    st = start_state("llama3.2-1b")
    if rank == 0:
        trainer("llama3.2-1b", ckpt_dir=os.path.join(out_dir, "save1")
                ).save(5, st)
    torch.distributed.barrier()
    mesh = pods[(2, 2, 1)]
    tr = trainer("llama3.2-1b", mesh, ckpt_dir=os.path.join(out_dir,
                                                            "save_pod"))
    tr.save(5, SH.local_block(st, tr.specs, mesh))
    for name, shape, src in RESTORES:
        mesh = pods.get(shape, pm)
        tr = trainer("llama3.2-1b", mesh, ckpt_dir=os.path.join(out_dir,
                                                                src))
        step, got, _ = tr.restore(tr.init_state())
        want = SH.local_block(st, tr.specs, mesh)
        res[f"restore_{name}"] = _everywhere(pm, step == 5 and all(
            a.dtype == b.dtype and torch.equal(a, b) for a, b in
            zip(tree_leaves(got), tree_leaves(want))))

    def final(out, tr, mesh):
        whole = SH.gather_logical(out["state"], tr.specs, mesh, root=0)
        return dict(losses=[h["loss"] for h in out["history"]],
                    params=flat(whole["params"]) if rank == 0 else None,
                    m=flat(whole["opt"]["m"]) if rank == 0 else None)

    for arch in ARCHS:
        gen = torch.Generator().manual_seed(7)
        res[arch] = {}
        for name, hook in (("plain", None), ("crash", crash_at(2))):
            tr = trainer(arch, pm, ckpt_dir=os.path.join(
                out_dir, f"{arch}_{name}"), ckpt_every=1)
            res[arch][name] = final(
                tr.run_with_restarts(gen, failure_hook=hook), tr, pm)
        # relaunch on another mesh from the plain run's step 2
        elastic = os.path.join(out_dir, f"{arch}_elastic")
        if rank == 0:
            shutil.copytree(os.path.join(out_dir, f"{arch}_plain",
                                         "step_00000002"),
                            os.path.join(elastic, "step_00000002"))
            shutil.copytree(elastic, elastic + "_pod")
        torch.distributed.barrier()
        pm14 = R.process_mesh((1, 4), pm.axis_names, "cpu")
        tr = trainer(arch, pm14, ckpt_dir=elastic, ckpt_every=1)
        res[arch]["elastic"] = final(
            tr.run_with_restarts(gen, failure_hook=crash_at(0)), tr, pm14)
        mesh = pods[(2, 2, 1)]
        tr = trainer(arch, mesh, ckpt_dir=elastic + "_pod", ckpt_every=1)
        res[arch]["elastic_pod"] = final(
            tr.run_with_restarts(gen, failure_hook=crash_at(0)), tr, mesh)
    if rank == 0:
        with open(os.path.join(out_dir, "ckpt.pkl"), "wb") as f:
            pickle.dump(res, f)
