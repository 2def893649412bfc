"""Rank functions and set-up of the sharded decode tests
(``test_torch_dist_decode.py``).

``runtime.spawn`` starts each rank in a fresh process that imports this
module by name, so it imports nothing of JAX. The parent draws every
case's params from a seeded CPU generator (rwkv6's ``u``, ``mu``,
``mu_k`` and ``mu_r`` from a numpy seed, since they init to constants),
prefills a cache by stepping the one-device port over a prompt from a
numpy seed, and writes both, with the first tokens, to an npz file that
the ranks and the JAX package's reference read. A rank cuts its blocks
out of the whole trees (``sharding.decode_pspecs``), runs ``STEPS``
steps of ``launch.steps.make_serve_step`` and writes its results.
"""
from __future__ import annotations

import dataclasses
import os
import pickle

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.distributed import collectives as C
from repro_torch.distributed import runtime as R
from repro_torch.distributed import sharding as SH
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.serving import quantize_for_serving

ARCHS = ("llama3.2-1b", "h2o-danube-1.8b", "rwkv6-7b")
QUANTS = (None, "ternary")
# (data, model) meshes, then (pod, data, model): runtime.MESH_AXES by the
# number of dims.
MESHES = ((2, 2), (4, 1), (1, 4), (2, 2, 1))
BATCH, PROMPT, STEPS, CACHE = 8, 6, 4, 16
# Ternary serving packs dims >= 256 only: the SMOKE configs widened so
# that the MLP (and rwkv6's projections) pack; rwkv6's d_ff keeps its
# 3.5 x d_model.
WIDE = {"dense": dict(d_model=256, d_ff=512, head_dim=64),
         "rwkv6": dict(d_model=256, d_ff=896)}
# The case whose step is run again with wq gathered over 'data' first
# (an FSDP gather: a parameter crossing ranks).
PLANT = ("llama3.2-1b", None, (2, 2))


def config(arch: str, quant=None):
    """The SMOKE config of ``arch`` (f32; h2o-danube's ring of 8 slots,
    so that the steps wrap it), widened for ternary cases."""
    cfg = get_config(arch, smoke=True)
    if quant == "ternary":
        cfg = dataclasses.replace(cfg, name=cfg.name + "-q",
                                  **WIDE[cfg.family])
    return cfg


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def case_name(arch, quant, shape) -> str:
    return f"{arch}_{quant or 'float'}_{mesh_name(shape)}"


def params(cfg, seed: int = 0):
    """Params of ``cfg`` as CPU tensors (f32), rwkv6's constant-init
    leaves drawn from a numpy seed."""
    model = build_model(cfg)
    p = model.init(torch.Generator().manual_seed(seed), device="cpu")
    if cfg.family == "rwkv6":
        rng = np.random.default_rng(seed)
        tm, cm = p["layers"]["tm"], p["layers"]["cm"]
        tm["u"] = torch.from_numpy(
            (rng.normal(size=tm["u"].shape) * 0.5).astype(np.float32))
        for tree, key in ((tm, "mu"), (cm, "mu_k"), (cm, "mu_r")):
            tree[key] = torch.from_numpy(
                rng.uniform(0.0, 1.0, tree[key].shape).astype(np.float32))
    return p


def flat(tree, prefix=""):
    """{"/"-joined path: numpy array} of a tree of tensors."""
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(flat(tree[k], f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree.detach().cpu().numpy()
    return out


def nest(flat_tree):
    """A tree of dicts from {"/"-joined path: leaf}."""
    out = {}
    for path, leaf in flat_tree.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


class Logits:
    """Records the logits each serve step takes its argmax of
    (``layers.greedy_tokens``) inside ``with``."""

    def __init__(self):
        self.got, self._real = [], L.greedy_tokens

    def __enter__(self):
        def record(logits, vocab):
            self.got.append(logits.detach().clone())
            return self._real(logits, vocab)
        L.greedy_tokens = record
        return self

    def __exit__(self, *exc):
        L.greedy_tokens = self._real


def run_steps(cfg, params_, cache, tokens, steps: int = STEPS):
    """``steps`` greedy serve steps: each step's logits, next tokens and
    the last cache."""
    step = make_serve_step(cfg)
    toks = []
    with Logits() as rec:
        for _ in range(steps):
            tokens, cache = step(params_, cache, tokens)
            toks.append(tokens)
    return rec.got, toks, cache


def prefill(cfg, params_, seed: int = 0):
    """A cache of ``CACHE`` slots (h2o-danube's ring of its window) after
    ``PROMPT`` one-device decode steps over a prompt from a numpy seed,
    and the first tokens to serve (the last logits' argmax)."""
    model = build_model(cfg)
    prompt = torch.from_numpy(np.random.default_rng(500 + seed).integers(
        0, cfg.vocab_size, (BATCH, PROMPT)).astype(np.int32))
    cache = model.init_cache(BATCH, CACHE, device="cpu")
    for i in range(PROMPT):
        logits, cache = model.decode(params_, cache, prompt[:, i:i + 1])
    return cache, torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def case_file(out_dir, arch, quant) -> str:
    return os.path.join(out_dir, f"{arch}_{quant or 'float'}.npz")


def write_case(out_dir, arch, quant):
    """The case's float params (``p/``), prefilled cache (``c/``) and first
    tokens, for the ranks and the JAX reference."""
    cfg = config(arch, quant)
    p = params(cfg)
    q = quantize_for_serving(p)[0] if quant == "ternary" else p
    cache, tokens = prefill(cfg, q)
    np.savez(case_file(out_dir, arch, quant),
             tokens=tokens.numpy(),
             **{"p/" + k: v for k, v in flat(p).items()},
             **{"c/" + k: v for k, v in flat(cache).items()})


def read_case(out_dir, arch, quant):
    """(serving params, cache, first tokens) of a case file."""
    z = np.load(case_file(out_dir, arch, quant))
    p = nest({k[2:]: torch.from_numpy(z[k]) for k in z.files
              if k.startswith("p/")})
    cache = nest({k[2:]: torch.from_numpy(z[k]) for k in z.files
                  if k.startswith("c/")})
    if quant == "ternary":
        p = quantize_for_serving(p)[0]
    return p, cache, torch.from_numpy(z["tokens"])


class Watch:
    """On this rank, inside ``with``: the largest tensor a collective
    moved (bytes, op and axis), and each K3 call's input, output and
    blocks of the packed weight (``ops.ternary_matmul``) and each K4
    call's r shape (``ops.wkv6_scan``)."""

    def __init__(self):
        self.largest, self.k3, self.k4 = (0, None), [], []

    def __enter__(self):
        self._count, self._k3, self._k4 = C._count, ops.ternary_matmul, \
            ops.wkv6_scan

        def count(op, axis, t):
            n = t.numel() * t.element_size()
            if n > self.largest[0]:
                self.largest = (n, f"{op}/{axis}")
            return self._count(op, axis, t)

        def k3(x, packed, scale):
            out = self._k3(x, packed, scale)
            self.k3.append((x, packed, scale, out))
            return out

        def k4(r, *a, **k):
            self.k4.append(list(r.shape))
            return self._k4(r, *a, **k)
        C._count, ops.ternary_matmul, ops.wkv6_scan = count, k3, k4
        return self

    def __exit__(self, *exc):
        C._count, ops.ternary_matmul, ops.wkv6_scan = self._count, \
            self._k3, self._k4


def _k3_bits(whole, specs, calls, mesh):
    """Every K3 call on this rank against the one-device K3 of the same
    rows on the whole packed weight it holds a block of (its columns over
    the packed leaf's spec): the matching columns bit for bit. Returns
    (calls, calls equal)."""
    leaves = list(zip(_packed(whole), _packed(specs)))
    equal = 0
    for x, pk, sc, out in calls:
        n = pk.shape[-1]
        for leaf, spec in leaves:
            ax = spec["packed"][-1]
            lo = (mesh.coord(ax) if ax in mesh.shape else 0) * n
            hit = [w for w in range(leaf["packed"].shape[0]) if torch.equal(
                leaf["packed"][w][:, lo:lo + n], pk)]
            if hit:
                ref = ops.ternary_matmul(x, leaf["packed"][hit[0]],
                                         leaf["scale"][hit[0]])
                equal += bool(torch.equal(ref[..., lo:lo + n], out))
                break
    return len(calls), equal


def _packed(tree):
    """The packed weights' dicts of a tree (or of its spec tree), in
    sorted-key order."""
    if isinstance(tree, dict) and "packed" in tree:
        return [tree]
    if isinstance(tree, dict):
        return [d for k in sorted(tree) for d in _packed(tree[k])]
    return []


def decode_case(arch, quant, mesh, out_dir, plant=False):
    """``STEPS`` sharded serve steps of a case on this rank from its
    blocks: rank 0 writes the whole logits, tokens and last cache
    (``gather_logical``); every rank writes the first step's collective
    tallies and bytes, the largest tensor a collective moved, its K3
    calls against the one-device K3 and its K4 call shapes."""
    cfg = config(arch, quant)
    whole, cache, tokens = read_case(out_dir, arch, quant)
    specs = SH.decode_pspecs(cfg, mesh, whole, cache, BATCH)
    blocks = SH.local_block(whole, specs["params"], mesh)
    cache_b = SH.local_block(cache, specs["cache"], mesh)
    tok_b = SH.local_block(tokens, specs["tokens"], mesh)
    step = make_serve_step(cfg)
    counts, logits, toks = [], [], []
    with mesh, Watch() as watch, Logits() as rec:
        for i in range(STEPS):
            C.reset_counts()
            tok_b, cache_b = step(blocks, cache_b, tok_b)
            counts.append(({f"{op}/{axis}": n for (op, axis), n in
                            sorted(C.launches.items())},
                           {f"{op}/{axis}": n for (op, axis), n in
                            sorted(C.bytes_moved.items())}))
            toks.append(tok_b)
    largest = watch.largest
    planted = None
    if plant:
        real = L.serve_einsum

        def fsdp_gather(eq, x, w, **kw):
            if eq == "bsd,dhk->bshk":
                C.gather_dim(w, 0, "data")     # a parameter moved
            return real(eq, x, w, **kw)
        first_cache = SH.local_block(cache, specs["cache"], mesh)
        with mesh, Watch() as again:
            L.serve_einsum = fsdp_gather
            try:
                step(blocks, first_cache, SH.local_block(
                    tokens, specs["tokens"], mesh))
            finally:
                L.serve_einsum = real
        planted = again.largest
    k3 = _k3_bits(whole, specs["params"], watch.k3, mesh)
    v = cfg.vocab_size
    lspec = (specs["tokens"][0], None,
             "model" if rec.got[0].shape[-1] < v else None)
    got = SH.gather_logical(
        {"logits": torch.stack(rec.got, 0), "tokens": torch.stack(toks, 0),
         "cache": cache_b},
        {"logits": (None,) + lspec, "tokens": (None,) + tuple(
            specs["tokens"]), "cache": specs["cache"]}, mesh, root=0)
    row = dict(counts=counts, largest=largest, planted=planted, k3=k3,
               k4=watch.k4, coords=dict(mesh.coords))
    if mesh.rank == 0:
        row.update(logits=got["logits"].numpy(), tokens=got["tokens"].numpy(),
                   cache={k: t.numpy() for k, t in got["cache"].items()})
    name = case_name(arch, quant, mesh.axis_sizes)
    with open(os.path.join(out_dir, f"{name}_{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(row, f)


def decode_rank(rank, world, port, out_dir, meshes=MESHES, archs=ARCHS,
                quants=QUANTS):
    """Every case of ``archs`` x ``quants`` x ``meshes`` over the same
    ranks (gloo on the CPU, one torch thread a rank)."""
    torch.set_num_threads(1)
    pm = R.init("localhost", port, world, rank, backend="gloo",
                device="cpu", shape=meshes[0])
    made = {tuple(meshes[0]): pm}
    for shape in meshes:
        if shape not in made:
            made[shape] = R.process_mesh(shape, R.MESH_AXES[len(shape)],
                                         "cpu")
        for arch in archs:
            for quant in quants:
                decode_case(arch, quant, made[shape], out_dir,
                            plant=(arch, quant, shape) == PLANT)


def one_device(out_dir, arch, quant):
    """The one-device port's ``STEPS`` serve steps of a case: logits,
    tokens and the last cache (numpy)."""
    cfg = config(arch, quant)
    p, cache, tokens = read_case(out_dir, arch, quant)
    logits, toks, cache = run_steps(cfg, p, cache, tokens)
    return dict(logits=torch.stack(logits).numpy(),
                tokens=torch.stack(toks).numpy(),
                cache={k: t.numpy() for k, t in cache.items()})


def rank_file(out_dir, arch, quant, shape, rank):
    return os.path.join(out_dir,
                        f"{case_name(arch, quant, shape)}_{rank}.pkl")

