"""Rank functions and set-up of the sharded decode tests
(``test_torch_dist_decode.py``).

``runtime.spawn`` starts each rank in a fresh process that imports this
module by name, so it imports nothing of JAX. A case is ``(arch, quant,
mesh shape, variant)``: the variant ``""`` is B=8 over a 16-slot cache;
``VARIANTS`` lists the others (B=1 and B=2, which the batch axes do not
divide: context-parallel caches; odd cache lengths, which ``model`` does
not divide: KV heads or head_dim over ``model``). The parent draws every
case's params from a seeded CPU generator (rwkv6's ``u``, ``mu``,
``mu_k`` and ``mu_r`` and zamba2's ``a_log``, ``dt_bias``, ``d_skip``,
``conv_b`` and ``norm_s`` from a numpy seed, since they init to
constants), fills the enc-dec's cross K/V from frames of a numpy seed
(``encode``, ``prefill_cross_kv``), prefills a cache by stepping the
one-device port over a prompt from a numpy seed, and writes both, with
the first tokens, to an npz file that the ranks and the JAX package's
reference read. A rank cuts its blocks out of the whole trees
(``sharding.decode_pspecs``), runs ``STEPS`` steps of
``launch.steps.make_serve_step`` and writes its results.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import build_model
from repro_torch.models import encdec as ED
from repro_torch.models import layers as L
from repro_torch.serving import quantize_for_serving

ARCHS = ("llama3.2-1b", "h2o-danube-1.8b", "rwkv6-7b", "qwen2-vl-2b",
         "deepseek-moe-16b", "llama4-scout-17b-a16e", "zamba2-1.2b",
         "seamless-m4t-medium")
QUANTS = (None, "ternary")
# (data, model) meshes, then (pod, data, model): runtime.MESH_AXES by the
# number of dims. The dense archs and rwkv6 run on all four, the others
# on the (data, model) three, deepseek-moe-16b on the pod mesh too.
MESHES = ((2, 2), (4, 1), (1, 4), (2, 2, 1))
POD_ARCHS = ("llama3.2-1b", "h2o-danube-1.8b", "rwkv6-7b",
             "deepseek-moe-16b")
CASES = [(a, q, m, "") for m in MESHES for a in ARCHS for q in QUANTS
         if len(m) == 2 or a in POD_ARCHS]
BATCH, PROMPT, STEPS, CACHE = 8, 6, 4, 16
# A variant's batch, cache slots and the enc-dec's encoder frames, and a
# KV cache spec that replaces cache_pspecs' (``kv``). "b1": B=1 (whole
# rows on every rank; the KV sequence, rwkv6's dk and zamba2's P over
# 'data'; 18 frames, which 4 does not divide); "b2": B=2 over (2, 2, 1)
# (rows over 'pod', whole over 'data'); "odd": 15 slots (KV heads over
# 'model' at (2, 2), llama3.2-1b's head_dim at (1, 4)); "dh": B=1 with
# the KV sequence over 'data' and the KV heads over 'model', the layout
# cache_pspecs gives where 'data' divides the sequence and 'model' does
# not (a data axis of another size than model's: no 4-rank mesh has one).
VARIANTS = {"": dict(batch=BATCH, cache=CACHE, frames=CACHE),
            "b1": dict(batch=1, cache=CACHE, frames=18),
            "b2": dict(batch=2, cache=CACHE, frames=CACHE),
            "odd": dict(batch=BATCH, cache=15, frames=CACHE),
            "dh": dict(batch=1, cache=CACHE, frames=CACHE,
                       kv=(None, None, "data", "model", None))}
CP_ARCHS = ("llama3.2-1b", "h2o-danube-1.8b", "rwkv6-7b", "zamba2-1.2b",
            "deepseek-moe-16b", "seamless-m4t-medium")
CP_CASES = ([(a, None, m, "b1") for m in MESHES[:3] for a in CP_ARCHS]
            + [(a, "ternary", (2, 2), "b1") for a in CP_ARCHS]
            + [("rwkv6-7b", "ternary", (4, 1), "b1")]
            + [(a, None, (2, 2, 1), "b2") for a in CP_ARCHS]
            + [("llama3.2-1b", None, m, "odd") for m in ((2, 2), (1, 4))]
            + [("llama3.2-1b", None, (2, 2), "dh")])
ALL_CASES = CASES + CP_CASES
# Each case file: (arch, quant, variant).
FILES = sorted({(a, q, v) for a, q, _, v in ALL_CASES},
               key=lambda f: (f[0], f[1] or "", f[2]))
# Ternary serving packs dims >= 256 only: the SMOKE configs widened so
# that the MLP (and rwkv6's projections, the MoE's shared experts,
# zamba2's in_proj and out_proj) pack; rwkv6's d_ff keeps its 3.5 x
# d_model.
WIDE = {"dense": dict(d_model=256, d_ff=512, head_dim=64),
        "rwkv6": dict(d_model=256, d_ff=896),
        "vlm": dict(d_model=256, d_ff=512),
        "moe": dict(d_model=256, d_ff=256, expert_d_ff=256),
        "zamba2": dict(d_model=256, d_ff=512),
        "encdec": dict(d_model=256, d_ff=512)}
# zamba2's shared block on a ring of 8 slots (the cache clamped to its
# long_context_window), so that the steps wrap it, as h2o-danube's.
RING = {"zamba2-1.2b": dict(long_context_window=8)}
# The case whose step is run again with wq gathered over 'data' first
# (an FSDP gather: a parameter crossing ranks).
PLANT = ("llama3.2-1b", None, (2, 2), "")
# The case whose step is run again with each rank routing its own rows
# (the MoE groups formed rank by rank).
ROUTE_PLANT = ("deepseek-moe-16b", None, (2, 2), "")
# The case whose step is run again with rwkv6's state gathered over
# 'data' before K4 (a state block crossing ranks).
STATE_PLANT = ("rwkv6-7b", None, (2, 2), "b1")
# The cases whose step is run again with the rows taken as split over
# every batch axis, whole as they are (the rule before the rows' layout
# was read from the tokens' spec): copies of a row gathered over 'data'.
COPIES_PLANT = (("deepseek-moe-16b", None, (2, 2), "b1"),
                ("llama3.2-1b", None, (2, 2), "b1"))
# A fault a family: rank 0's block of the leaf (of layer 0) zeroed, one
# step run again.
FAULTS = {("qwen2-vl-2b", None, (2, 2), ""): "embed",
          ("deepseek-moe-16b", None, (2, 2), ""): "layers/moe/we_down",
          ("zamba2-1.2b", None, (2, 2), ""): "layers/out_proj",
          ("seamless-m4t-medium", None, (2, 2), ""):
              "decoder/cross_attn/wo"}


def overrides(arch: str, quant=None) -> dict:
    """The fields ``config`` replaces in ``arch``'s SMOKE config."""
    out = dict(RING.get(arch, {}))
    if quant == "ternary":
        cfg = get_config(arch, smoke=True)
        out.update(WIDE[cfg.family], name=cfg.name + "-q")
    return out


def config(arch: str, quant=None):
    """The SMOKE config of ``arch`` (f32; h2o-danube's ring of 8 slots and
    zamba2's, so that the steps wrap them), widened for ternary cases."""
    return dataclasses.replace(get_config(arch, smoke=True),
                               **overrides(arch, quant))


def mesh_name(shape) -> str:
    return "x".join(map(str, shape))


def case_name(arch, quant, shape, variant="") -> str:
    return f"{arch}_{quant or 'float'}_{mesh_name(shape)}" + (
        f"_{variant}" if variant else "")


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
    if cfg.family == "zamba2":
        rng = np.random.default_rng(seed + 1)
        lay = p["layers"]
        for key, lo, hi in (("a_log", -1.0, 1.0), ("dt_bias", -1.0, 0.5),
                            ("d_skip", 0.5, 1.5), ("conv_b", -0.2, 0.2),
                            ("norm_s", 0.5, 1.5)):
            lay[key] = torch.from_numpy(
                rng.uniform(lo, hi, lay[key].shape).astype(np.float32))
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


def prefill(cfg, params_, float_params, seed: int = 0, variant: str = ""):
    """A cache of the variant's slots (h2o-danube's and zamba2's rings of
    their windows) after ``PROMPT`` one-device decode steps over a prompt
    of the variant's batch from a numpy seed, and the first tokens to
    serve (the last logits' argmax). The enc-dec's cross K/V: the
    variant's frames from a numpy seed through ``encode``
    (``float_params``: it takes a float ``frontend_proj``) and
    ``prefill_cross_kv``."""
    model = build_model(cfg)
    var = VARIANTS[variant]
    b = var["batch"]
    prompt = torch.from_numpy(np.random.default_rng(500 + seed).integers(
        0, cfg.vocab_size, (b, PROMPT)).astype(np.int32))
    cache = model.init_cache(b, var["cache"], device="cpu")
    if cfg.family == "encdec":
        frames = torch.from_numpy(np.random.default_rng(600 + seed).normal(
            size=(b, var["frames"], cfg.frontend_dim)).astype(np.float32))
        cache["ck"], cache["cv"] = ED.prefill_cross_kv(
            params_, ED.encode(float_params, frames, cfg), cfg)
    for i in range(PROMPT):
        logits, cache = model.decode(params_, cache, prompt[:, i:i + 1])
    return cache, torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)


def case_file(out_dir, arch, quant, variant="") -> str:
    return os.path.join(out_dir, f"{arch}_{quant or 'float'}"
                        + (f"_{variant}" if variant else "") + ".npz")


def write_case(out_dir, arch, quant, variant=""):
    """The case's float params (``p/``), prefilled cache (``c/``) and first
    tokens, for the ranks and the JAX reference."""
    cfg = config(arch, quant)
    p = params(cfg)
    q = quantize_for_serving(p)[0] if quant == "ternary" else p
    cache, tokens = prefill(cfg, q, p, variant=variant)
    np.savez(case_file(out_dir, arch, quant, variant),
             tokens=tokens.numpy(),
             **{"p/" + k: v for k, v in flat(p).items()},
             **{"c/" + k: v for k, v in flat(cache).items()})


def read_case(out_dir, arch, quant, variant=""):
    """(serving params, cache, first tokens) of a case file."""
    z = np.load(case_file(out_dir, arch, quant, variant))
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
    blocks of the packed weight (``ops.ternary_matmul``), each K4 call's r
    shape (``ops.wkv6_scan``) and each call of K4's stripe entry's r and
    state shapes and first row (``ops.wkv6_stripe``)."""

    def __init__(self):
        self.largest, self.k3, self.k4, self.stripe = (0, None), [], [], []

    def __enter__(self):
        self._count, self._k3, self._k4 = C._count, ops.ternary_matmul, \
            ops.wkv6_scan
        self._stripe = ops.wkv6_stripe

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

        def stripe(r, k, v, logw, u, state0, lo):
            self.stripe.append((list(r.shape), list(state0.shape), lo))
            return self._stripe(r, k, v, logw, u, state0, lo)
        C._count, ops.ternary_matmul, ops.wkv6_scan = count, k3, k4
        ops.wkv6_stripe = stripe
        return self

    def __exit__(self, *exc):
        C._count, ops.ternary_matmul, ops.wkv6_scan = self._count, \
            self._k3, self._k4
        ops.wkv6_stripe = self._stripe


def _k3_bits(whole, specs, calls, mesh):
    """Every K3 call on this rank against the one-device K3 of the same
    rows on the whole packed weight it holds a block of (its columns over
    the packed leaf's spec): the matching columns bit for bit. Returns
    (calls, calls equal)."""
    leaves = [({k: v if v.ndim == 3 - (k == "scale") else v[None]
                for k, v in leaf.items()}, spec)
              for leaf, spec in zip(_packed(whole), _packed(specs))]
    equal = 0
    for x, pk, sc, out in calls:
        n = pk.shape[-1]
        for leaf, spec in leaves:       # layers stacked; a shared one alone
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


def _route_alone(real):
    """``layers.moe_route_logits`` as a rank that routed its own rows
    alone would: the logits of the global groups cut into the rows of
    each rank of the batch axes, each routed as a group of its own with
    its own capacity, the results laid back in the global groups."""
    def route(logits, cfg, cap):
        parts = C.axis_size("data") * C.axis_size("pod")
        ng, g, e = logits.shape
        r = real(logits.reshape(ng * parts, g // parts, e), cfg,
                 L.moe_groups(g // parts, 1, cfg)[2])
        return {k: v.reshape(ng, g, *v.shape[2:]) for k, v in r.items()}
    return route


def _zeroed(blocks, leaf, rank):
    """``blocks`` with this rank's block of ``leaf`` (its layer 0 where
    stacked; a packed leaf's scale) zeroed on rank ``rank`` only."""
    out = dict(blocks)
    node, path = out, leaf.split("/")
    for k in path[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    w = node[path[-1]]
    if rank == 0:
        if isinstance(w, dict):
            src = w["scale"]
            w = dict(w, scale=A.tag(src.clone(), A.spec_of(src)))
            t = w["scale"]
        else:
            w = t = A.tag(w.clone(), A.spec_of(w))
        (t[0] if leaf.startswith(("layers", "decoder")) else t).zero_()
        node[path[-1]] = w
    return out


def specs_for(cfg, mesh, whole, cache, variant=""):
    """``sharding.decode_pspecs`` of a case, the variant's KV spec in
    place of ``cache_pspecs``' where it names one."""
    specs = SH.decode_pspecs(cfg, mesh, whole, cache,
                             VARIANTS[variant]["batch"])
    kv = VARIANTS[variant].get("kv")
    if kv is not None:
        specs["cache"].update(k=kv, v=kv)
    return specs


def _copies(real):
    """``annotate.rows_split`` as the rule was before the rows' layout was
    read from the tokens' spec: rows split over every batch axis."""
    def split(axis):
        return C.axis_size(axis) > 1 and axis in C.batch_axes()
    return split


def decode_case(arch, quant, mesh, out_dir, variant=""):
    """``STEPS`` sharded serve steps of a case on this rank from its
    blocks: rank 0 writes the whole logits, tokens and last cache
    (``gather_logical``); every rank writes the first step's collective
    tallies and bytes, the largest tensor a collective moved, its K3
    calls against the one-device K3, its K4 and K4 stripe calls' shapes
    and zamba2's conv state blocks after each step. The planted cases run
    one step again from the first cache: ``PLANT`` with ``wq`` gathered
    over 'data' and ``STATE_PLANT`` with the state gathered over 'data'
    (the largest tensor moved), ``ROUTE_PLANT`` with each rank routing its
    own rows and ``FAULTS`` with a zeroed block (the first step's whole
    logits, on rank 0), ``COPIES_PLANT`` with whole rows taken as split
    (copies gathered: the largest tensor moved, and every rank's logits
    of its row)."""
    case = (arch, quant, tuple(mesh.axis_sizes), variant)
    cfg = config(arch, quant)
    whole, cache, tokens = read_case(out_dir, arch, quant, variant)
    specs = specs_for(cfg, mesh, whole, cache, variant)
    blocks = SH.local_block(whole, specs["params"], mesh)
    cache_b = SH.local_block(cache, specs["cache"], mesh)
    tok_b = SH.local_block(tokens, specs["tokens"], mesh)
    step = make_serve_step(cfg)
    counts, logits, toks, conv = [], [], [], []
    with mesh, Watch() as watch, Logits() as rec:
        for i in range(STEPS):
            C.reset_counts()
            tok_b, cache_b = step(blocks, cache_b, tok_b)
            counts.append(({f"{op}/{axis}": n for (op, axis), n in
                            sorted(C.launches.items())},
                           {f"{op}/{axis}": n for (op, axis), n in
                            sorted(C.bytes_moved.items())}))
            toks.append(tok_b)
            if "conv" in cache_b:
                conv.append(cache_b["conv"].numpy().copy())
    largest = watch.largest
    v = cfg.vocab_size
    lspec = (specs["tokens"][0], None,
             "model" if rec.got[0].shape[-1] < v else None)

    def again(params_, root=0):
        """One step from the first cache: (the largest tensor moved, the
        step's logits gathered whole on rank ``root``; with ``root`` None,
        each rank's rows with every column on that rank)."""
        with mesh, Watch() as w, Logits() as r:
            step(params_, SH.local_block(cache, specs["cache"], mesh),
                 SH.local_block(tokens, specs["tokens"], mesh))
        return w.largest, SH.gather_logical(r.got[0], lspec, mesh,
                                            root=root)

    def patched(module, name, fn, params_=blocks, root=0):
        real = getattr(module, name)
        setattr(module, name, fn(real))
        try:
            return again(params_, root)
        finally:
            setattr(module, name, real)
    planted, planted_logits = None, {}
    if case == PLANT:
        def fsdp_gather(real):
            def run(eq, x, w, **kw):
                if eq == "bsd,dhk->bshk":
                    C.gather_dim(w, 0, "data")     # a parameter moved
                return real(eq, x, w, **kw)
            return run
        planted = patched(L, "serve_einsum", fsdp_gather)[0]
    if case == STATE_PLANT:
        def state_gather(real):
            def run(r, k, v_, logw, u, state0, lo):
                C.gather_dim(state0, 2, "data")    # a state block moved
                return real(r, k, v_, logw, u, state0, lo)
            return run
        planted = patched(ops, "wkv6_stripe", state_gather)[0]
    if case == ROUTE_PLANT:
        planted_logits["route"] = patched(L, "moe_route_logits",
                                          _route_alone)[1]
    copies = None
    if case in COPIES_PLANT:     # every rank's row: the copies differ
        planted, copies = patched(A, "rows_split", _copies, root=None)
        copies = copies.numpy()
    if case in FAULTS:
        planted_logits["fault"] = again(_zeroed(blocks, FAULTS[case],
                                                mesh.rank))[1]
    k3 = _k3_bits(whole, specs["params"], watch.k3, mesh)
    got = SH.gather_logical(
        {"logits": torch.stack(rec.got, 0), "tokens": torch.stack(toks, 0),
         "cache": cache_b},
        {"logits": (None,) + lspec, "tokens": (None,) + tuple(
            specs["tokens"]), "cache": specs["cache"]}, mesh, root=0)
    row = dict(counts=counts, largest=largest, planted=planted, k3=k3,
               k4=watch.k4, stripe=watch.stripe, conv=conv, copies=copies,
               coords=dict(mesh.coords))
    if mesh.rank == 0:
        row.update(logits=got["logits"].numpy(), tokens=got["tokens"].numpy(),
                   cache={k: t.numpy() for k, t in got["cache"].items()})
        row.update({k: t.numpy() for k, t in planted_logits.items()})
    name = case_name(arch, quant, mesh.axis_sizes, variant)
    with open(os.path.join(out_dir, f"{name}_{mesh.rank}.pkl"), "wb") as f:
        pickle.dump(row, f)


def decode_rank(rank, world, port, out_dir, cases=None):
    """Every case of ``cases`` (default ``ALL_CASES``) over the same ranks
    (gloo on the CPU, one torch thread a rank), mesh by mesh."""
    torch.set_num_threads(1)
    cases = ALL_CASES if cases is None else cases
    first = tuple(cases[0][2])
    pm = R.init("localhost", port, world, rank, backend="gloo",
                device="cpu", shape=first)
    made = {first: pm}
    for arch, quant, shape, variant in cases:
        shape = tuple(shape)
        if shape not in made:
            made[shape] = R.process_mesh(shape, R.MESH_AXES[len(shape)],
                                         "cpu")
        decode_case(arch, quant, made[shape], out_dir, variant)


def one_device(out_dir, arch, quant, variant=""):
    """The one-device port's ``STEPS`` serve steps of a case: logits,
    tokens and the last cache (numpy)."""
    cfg = config(arch, quant)
    p, cache, tokens = read_case(out_dir, arch, quant, variant)
    logits, toks, cache = run_steps(cfg, p, cache, tokens)
    return dict(logits=torch.stack(logits).numpy(),
                tokens=torch.stack(toks).numpy(),
                cache={k: t.numpy() for k, t in cache.items()})


def rank_file(out_dir, arch, quant, shape, variant, rank):
    return os.path.join(out_dir, f"{case_name(arch, quant, shape, variant)}"
                                 f"_{rank}.pkl")
