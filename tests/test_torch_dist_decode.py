"""Sharded LM decode in the port: ``launch.steps.make_serve_step`` in
serve mode over a process mesh of 4 ``gloo`` ranks on the CPU --
``("data", "model")`` meshes (2, 2), (4, 1) and (1, 4) and the
``("pod", "data", "model")`` mesh (2, 2, 1) -- for SMOKE llama3.2-1b,
h2o-danube-1.8b (its ring of 8 slots wraps in the steps) and rwkv6-7b in
f32, float and ternary (the configs widened to d_model 256 so that
serving packs), B=8, ``STEPS`` greedy steps from a cache prefilled on
one device (``torch_dist_decode_workers``). Each rank holds its blocks:
the params under the train specs (``_quantized_pspecs`` for a ternary
tree), the cache under ``cache_pspecs``, its rows of the tokens. Against:

  (a) the port's one-device serve step: greedy tokens equal, logits and
      the last cache within 1e-5 (seen 4.4e-6 at most);
  (b) the JAX package's jitted sharded serve step on the same mesh of 4
      forced host devices, with the dry run's shardings (``lower_cell``),
      the same params, cache and tokens, in subprocesses: tokens equal,
      logits and cache within 1e-5;
  (c) every K3 output on a rank bit for bit with the matching columns of
      the one-device K3 on the same rows and the whole packed weight;
      K4 on each rank's heads and rows;
  (d) the collectives a rank issues a step, counted from the specs
      (``decode_pspecs``) by the rule of ``layers.serve_einsum``; none
      moves more bytes than the step's largest activation
      (B x max(d_model, d_ff, V / |model|) x 4), which a gather of
      ``wq`` over ``data`` (an FSDP gather, planted) breaks;
  (e) the refusals: a decode over a process mesh of the moe, vlm,
      zamba2 and encdec families, a cache spec with ``data`` on a
      sequence or state dim (context parallelism), a step outside serve
      mode, a cache without specs.

One spawn of 4 ranks runs every case, beside the JAX subprocesses.
"""
import collections
import json
import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_dist_decode_workers as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distributed import runtime as R  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed.mesh import Mesh  # noqa: E402
from repro_torch.launch import collective_analysis as CA  # noqa: E402
from repro_torch.launch.steps import abstract_cache  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import as_dtype  # noqa: E402
from repro_torch.serving import quantize_for_serving  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-5
CASES = [(a, q, m) for m in W.MESHES for a in W.ARCHS for q in W.QUANTS]
JAX_PROCS = 3

_JAX_RUN = r"""
import dataclasses, json, sys
import numpy as np
import jax, jax.numpy as jnp
jax.devices()               # the 4 forced host devices, before the dry run
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_config
from repro.distributed import make_mesh
from repro.distributed import sharding as SH
from repro.distributed.annotate import execution_mode
from repro.launch.steps import make_serve_step
from repro.models import build_model
from repro.serving.serve import quantize_for_serving
import repro.launch.dryrun as DR

d, steps, batch, wide = (sys.argv[1], int(sys.argv[2]), int(sys.argv[3]),
                         json.loads(sys.argv[4]))
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def nest(z, pre):
    out = {}
    for k in z.files:
        if k.startswith(pre):
            node, parts = out, k[len(pre):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(z[k])
    return out


for job in sys.argv[5:]:
    arch, quant, shape = job.split(":")
    shape = tuple(int(x) for x in shape.split("x"))
    cfg = get_config(arch, smoke=True)
    if quant == "ternary":
        cfg = dataclasses.replace(cfg, name=cfg.name + "-q",
                                  **wide[cfg.family])
    z = np.load(f"{d}/{arch}_{quant}.npz")
    params, cache = nest(z, "p/"), nest(z, "c/")
    tokens = jnp.asarray(z["tokens"])
    if quant == "ternary":
        params = quantize_for_serving(params)[0]
    mesh = make_mesh(shape, AXES[len(shape)])
    model = build_model(cfg)
    # lower_cell's shardings
    pspecs = SH.param_pspecs(model.defs(), mesh, mode="train")
    if quant == "ternary":
        pspecs = DR._quantized_pspecs(pspecs, params, mesh)
    param_sh = SH.shardings(mesh, pspecs)
    cspecs = SH.cache_pspecs(cfg, mesh, cache, batch)
    cache_sh = {k: NamedSharding(mesh, s) for k, s in cspecs.items()}
    b = SH._batch_dim_spec(mesh, batch)
    tok_sh = NamedSharding(mesh, P(b, None))
    serve = make_serve_step(cfg)

    def both(p, c, t):
        with execution_mode("serve"):
            logits, _ = model.decode(p, c, t)
        return (logits,) + serve(p, c, t)
    step = jax.jit(both, in_shardings=(param_sh, cache_sh, tok_sh),
                   out_shardings=(NamedSharding(mesh, P(b, None, None)),
                                  tok_sh, cache_sh))
    with mesh:
        p = jax.device_put(params, param_sh)
        c = jax.device_put(cache, cache_sh)
        t = jax.device_put(tokens, tok_sh)
        logits, toks = [], []
        for _ in range(steps):
            lg, t, c = step(p, c, t)
            logits.append(np.asarray(lg, np.float32))
            toks.append(np.asarray(t))
    np.savez(f"{d}/jax_{job.replace(':', '_')}.npz",
             logits=np.stack(logits), tokens=np.stack(toks),
             **{"c/" + k: np.asarray(v) for k, v in c.items()})
print("DONE")
"""


def _job(case):
    arch, quant, shape = case
    return f"{arch}:{quant or 'float'}:{W.mesh_name(shape)}"


def _jax_reference(d):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = [_job(c) for c in CASES]
    wide = json.dumps(W.WIDE)
    return [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_RUN), str(d),
         str(W.STEPS), str(W.BATCH), wide, *jobs[i::JAX_PROCS]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(JAX_PROCS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_decode")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for arch in W.ARCHS:
            for quant in W.QUANTS:
                W.write_case(str(d), arch, quant)
        procs = _jax_reference(d)
        try:
            R.spawn(W.decode_rank, 4, (R.free_port(), str(d)))
            one = {(a, q): W.one_device(str(d), a, q)
                   for a in W.ARCHS for q in W.QUANTS}
            for proc in procs:
                out, err = proc.communicate(timeout=600)
                assert proc.returncode == 0, err[-3000:]
        finally:
            for proc in procs:
                proc.kill()
    finally:
        torch.set_num_threads(threads)
    ranks, jax = {}, {}
    for case in CASES:
        rows = []
        for r in range(4):
            with open(W.rank_file(str(d), *case, r), "rb") as f:
                rows.append(pickle.load(f))
        ranks[case] = rows
        z = np.load(d / f"jax_{_job(case).replace(':', '_')}.npz")
        jax[case] = dict(logits=z["logits"], tokens=z["tokens"],
                         cache={k[2:]: z[k] for k in z.files
                                if k.startswith("c/")})
    return dict(one=one, ranks=ranks, jax=jax)


def _id(case):
    arch, quant, shape = case
    return f"{arch}-{quant or 'float'}-{W.mesh_name(shape)}"


def _near(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _against(got, want):
    assert np.array_equal(got["tokens"].reshape(want["tokens"].shape),
                          want["tokens"])
    assert _near(got["logits"].reshape(want["logits"].shape),
                 want["logits"]) <= TOL
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k in want["cache"]:
        assert _near(got["cache"][k], want["cache"][k]) <= TOL, k


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sharded_serve_step_matches_one_device(runs, case):
    _against(runs["ranks"][case][0], runs["one"][case[:2]])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sharded_serve_step_matches_the_jax_sharded_step(runs, case):
    got = runs["ranks"][case][0]
    want = runs["jax"][case]
    assert np.array_equal(got["tokens"].reshape(want["tokens"].shape),
                          want["tokens"])
    assert _near(got["logits"].reshape(want["logits"].shape),
                 want["logits"]) <= TOL
    for k in got["cache"]:
        assert _near(got["cache"][k], want["cache"][k]) <= TOL, k


@pytest.mark.parametrize("case", [c for c in CASES if c[1]], ids=_id)
def test_k3_outputs_on_every_rank_bit_for_bit(runs, case):
    cfg = W.config(case[0], case[1])
    per_step = 8 if cfg.family == "rwkv6" else 3
    for row in runs["ranks"][case]:
        calls, equal = row["k3"]
        assert calls == per_step * cfg.num_layers * W.STEPS
        assert equal == calls


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "rwkv6-7b"],
                         ids=_id)
def test_k4_runs_on_each_ranks_heads_and_rows(runs, case):
    cfg = W.config(case[0], case[1])
    sizes = dict(zip(R.MESH_AXES[len(case[2])], case[2]))
    rows = W.BATCH // (sizes.get("pod", 1) * sizes.get("data", 1))
    heads = cfg.rwkv_heads // sizes["model"]
    for row in runs["ranks"][case]:
        assert row["k4"] == [[rows, 1, heads, cfg.rwkv_head_dim]] * (
            cfg.num_layers * W.STEPS)


def _product(n, nbytes, eq, x, w, spec, sizes, elem, out_elem):
    """The collectives of ``serve_einsum(eq, x, w)`` by its rule, from the
    shapes: ``x`` as the rank holds it, ``w`` the whole weight's shape,
    ``spec`` its stored spec; returns the output's shape on the rank."""
    xs, rest = eq.split(",")
    ws, out = rest.split("->")
    axis = dict(zip(ws, spec))
    size = lambda a: sizes.get(a, 1) if a else 1

    def add(op, ax, shape, e):
        n[f"{op}/{ax}"] += 1
        nbytes[f"{op}/{ax}"] += int(np.prod(shape)) * e
    x = list(x)
    rows = "data" in spec and size("data") > 1
    if rows:                           # every row needs each data block
        x[0] *= size("data")
        add("all_gather", "data", x, elem)
    for d, c in enumerate(xs[1:], 1):
        if c not in axis:
            continue
        whole, a = w[ws.index(c)], axis[c]
        if x[d] != whole:              # x split over 'model'
            if a == "model":
                continue
            x[d] = whole
            add("all_gather", "model", x, elem)
        x[d] = whole // size(a)
    dims = dict(zip(xs, x))
    dims.update({c: w[ws.index(c)] // size(axis[c]) for c in ws
                 if c not in xs})
    y = [dims[c] for c in out]
    summed = {axis[c] for c in ws if c in xs and c not in out} - {None}
    r = out.index(xs[0])
    if "data" in summed and size("data") > 1:
        add("reduce_scatter", "data", y, out_elem)
        y[r] //= size("data")
    if "model" in summed and size("model") > 1:
        add("all_reduce", "model", y, out_elem)
    if rows and "data" not in summed:
        add("all_to_all", "data", y, out_elem)
        col = next(c for c in out if axis.get(c) == "data")
        y[r] //= size("data")
        y[out.index(col)] *= size("data")
    return y


def expected_counts(arch, quant, shape, batch=W.BATCH):
    """(launches, bytes) of one sharded decode step on a rank, from the
    specs: each product by the serve rule (``_product``), the attention's
    q/k/v gathered to whole heads over 'model', the flash-decoding max
    and sum over 'model', the embedding (token ids over 'data', the
    lookups summed over 'model', rows traded for columns over 'data')
    and the vocab-parallel argmax (a max and a min over 'model')."""
    cfg = W.config(arch, quant)
    axes = R.MESH_AXES[len(shape)]
    mesh = Mesh(axes, tuple(shape), (torch.device("cpu"),) * int(
        np.prod(shape)))
    sizes = dict(zip(axes, shape))
    dsz = sizes.get("data", 1)
    params = build_model(cfg).abstract_params()
    if quant:
        params = quantize_for_serving(params)[0]
    cache = abstract_cache(cfg, ShapeSpec("d", "decode", W.CACHE, batch))
    specs = SH.decode_pspecs(cfg, mesh, params, cache, batch)["params"]
    e = torch.empty((), dtype=as_dtype(cfg.dtype)).element_size()
    n, nbytes = collections.Counter(), collections.Counter()
    br = batch // (sizes.get("pod", 1) * dsz)

    def live(op, ax, numel, el):
        if sizes.get(ax, 1) > 1:
            n[f"{op}/{ax}"] += 1
            nbytes[f"{op}/{ax}"] += numel * el

    def prod(eq, x, node, spec, leaf, oe=e):
        w = node[leaf]
        if isinstance(w, dict):
            pk = w["packed"]
            return _product(n, nbytes, eq, x, (pk.shape[-2] * 4,
                                                pk.shape[-1]),
                            spec[leaf]["packed"][1:], sizes, e, oe)
        return _product(n, nbytes, eq, x, tuple(w.shape[1:]),
                        spec[leaf][1:], sizes, e, oe)
    d = cfg.d_model
    vs, ds = specs["embed"]
    rows = ds == "data" and dsz > 1
    bg, dd = (br * dsz, d // dsz) if rows else (br, d)
    if rows:
        live("all_gather", "data", bg, 4)
    if vs == "model":
        live("all_reduce", "model", bg * dd, e)
    if rows:
        live("all_to_all", "data", bg * dd, e)
    x = (br, 1, d)
    lay, sp = params["layers"], specs["layers"]
    for _ in range(cfg.num_layers):
        if cfg.family == "rwkv6":
            tm, ts, cm, cs = lay["tm"], sp["tm"], lay["cm"], sp["cm"]
            lo = prod("bsd,dkr->bskr", x, tm, ts, "lora_a")
            prod("bskr,krd->kbsd", lo, tm, ts, "lora_b")
            for k in ("wr", "wk", "wv"):
                prod("bsk,kn->bsn", x, tm, ts, k)
            g = prod("bsk,kn->bsn", x, tm, ts, "wg")
            a = prod("bsd,dr->bsr", x, tm, ts, "wa")
            prod("bsr,rd->bsd", a, tm, ts, "wb")
            prod("bsk,kn->bsn", g, tm, ts, "wo")
            h = prod("bsk,kn->bsn", x, cm, cs, "wk")
            prod("bsk,kn->bsn", h, cm, cs, "wv")
            if prod("bsk,kn->bsn", x, cm, cs, "wr")[-1] != d:
                live("all_gather", "model", br * d, e)
            continue
        at, ats = lay["attn"], sp["attn"]
        hd, heads = cfg.head_dim, cfg.num_heads
        for k, nh in (("wq", heads), ("wk", cfg.num_kv_heads),
                      ("wv", cfg.num_kv_heads)):
            y = prod("bsd,dhk->bshk", x, at, ats, k)
            if (y[2], y[3]) != (nh, hd):
                live("all_gather", "model", br * nh * hd, e)
        live("all_reduce", "model", br * heads, 4)
        live("all_reduce", "model", br * heads * (hd + 1), 4)
        prod("bshk,hkd->bsd", (br, 1, heads, hd), at, ats, "wo")
        ml, mls = lay["mlp"], sp["mlp"]
        h = prod("bsk,kn->bsn", x, ml, mls, "w_gate")
        prod("bsk,kn->bsn", x, ml, mls, "w_up")
        prod("bsk,kn->bsn", h, ml, mls, "w_down")
    if "lm_head" in params:
        y = _product(n, nbytes, "bsd,dv->bsv", x,
                     tuple(params["lm_head"].shape), specs["lm_head"],
                     sizes, e, 4)
    else:
        y = _product(n, nbytes, "bsd,vd->bsv", x,
                     tuple(params["embed"].shape), specs["embed"], sizes,
                     e, 4)
    if y[-1] != cfg.vocab_size:
        live("all_reduce", "model", br, 4)
        live("all_reduce", "model", br, 8)
    return dict(sorted(n.items())), dict(sorted(nbytes.items()))


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_collective_tallies_equal_the_count_from_the_specs(runs, case):
    want = expected_counts(*case)
    for row in runs["ranks"][case]:
        assert all(step == want for step in row["counts"]), row["coords"]


def _largest_activation(case):
    cfg = W.config(case[0], case[1])
    sizes = dict(zip(R.MESH_AXES[len(case[2])], case[2]))
    return W.BATCH * max(cfg.d_model, cfg.d_ff,
                         cfg.vocab_size // sizes["model"]) * 4


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_no_collective_moves_a_parameter(runs, case):
    bound = _largest_activation(case)
    for row in runs["ranks"][case]:
        assert row["largest"][0] <= bound, row["largest"]


def test_a_planted_fsdp_gather_of_wq_is_caught(runs):
    case = W.PLANT
    bound = _largest_activation(case)
    rows = runs["ranks"][case]
    assert all(r["largest"][0] <= bound for r in rows)
    assert all(r["planted"][0] > bound for r in rows), [
        r["planted"] for r in rows]
    assert all(r["planted"][1] == "all_gather/data" for r in rows)


# ----------------------------------------------------------------------
# (e) refusals, on one rank of a fake process group
# ----------------------------------------------------------------------

_REFUSED = [("deepseek-moe-16b", "11c"), ("qwen2-vl-2b", "11b"),
            ("zamba2-1.2b", "11d"), ("seamless-m4t-medium", "11e")]


def _serve_on_fake_mesh(cfg, shape, batch, cache_len=16, serve=True,
                        tag_cache=True):
    """A serve step of ``cfg`` on rank 0's blocks over a fake process mesh
    of ``shape``, on fake tensors (nothing runs but the step's Python)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.distributed import annotate as A
    from repro_torch.launch.steps import make_serve_step
    model = build_model(cfg)
    with CA.fake_process_mesh(shape, "cpu") as pm, FakeTensorMode():
        params = CA._fake_tree(model.abstract_params(), "cpu")
        cache = CA._fake_tree(abstract_cache(cfg, ShapeSpec(
            "d", "decode", cache_len, batch)), "cpu")
        tokens = torch.zeros((batch, 1), dtype=torch.int32)
        specs = SH.decode_pspecs(cfg, pm, params, cache, batch)
        blocks = SH.local_block(params, specs["params"], pm)
        cache_b = (SH.local_block(cache, specs["cache"], pm) if tag_cache
                   else cache)
        rows = SH.local_block(tokens, specs["tokens"], pm)
        with pm:
            if serve:
                return make_serve_step(cfg)(blocks, cache_b, rows)
            with A.execution_mode("train"):
                return model.decode(blocks, cache_b, rows)


@pytest.mark.parametrize("arch,item", _REFUSED, ids=[a for a, _ in _REFUSED])
def test_decode_of_other_families_over_a_mesh_is_refused(arch, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP item {item}"):
        _serve_on_fake_mesh(get_config(arch, smoke=True), (2, 2), 8)


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b"])
def test_context_parallel_caches_are_refused(arch):
    """B=1 over (2, 2): the batch does not divide ``data``, so
    ``cache_pspecs`` puts ``data`` on the sequence (KV) or the state's
    dk dim (rwkv6)."""
    with pytest.raises(NotImplementedError,
                       match="context parallelism.*ROADMAP item 11f"):
        _serve_on_fake_mesh(get_config(arch, smoke=True), (2, 2), 1)


def test_decode_outside_serve_mode_and_untagged_caches_are_refused():
    cfg = get_config("llama3.2-1b", smoke=True)
    with pytest.raises(NotImplementedError, match="runs in serve mode"):
        _serve_on_fake_mesh(cfg, (2, 2), 8, serve=False)
    with pytest.raises(ValueError, match="without a spec"):
        _serve_on_fake_mesh(cfg, (2, 2), 8, tag_cache=False)


def test_serve_mode_refuses_a_gather_at_use():
    """In serve mode under a process mesh ``unshard_fsdp`` and
    ``fsdp_layout`` raise (a layer without a serve rule would compute on
    a block as if it were whole); off a mesh they are the identity."""
    from repro_torch.distributed import annotate as A
    w = torch.ones((4, 4))
    with A.execution_mode("serve"):
        assert A.unshard_fsdp(w, (None, "model")) is w
        assert A.serve_layout(w) is None
    with CA.fake_process_mesh((2, 2), "cpu") as pm, pm, \
            A.execution_mode("serve"):
        A.tag(w, ("data", "model"))
        assert A.serve_layout(w) == ("data", "model")
        assert A.tp_size() == 2
        with pytest.raises(NotImplementedError, match="serve mode"):
            A.unshard_fsdp(w, (None, "model"))
