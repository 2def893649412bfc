"""Sharded LM decode in the port: ``launch.steps.make_serve_step`` in
serve mode over a process mesh of 4 ``gloo`` ranks on the CPU --
``("data", "model")`` meshes (2, 2), (4, 1) and (1, 4) and the
``("pod", "data", "model")`` mesh (2, 2, 1) -- for SMOKE llama3.2-1b,
h2o-danube-1.8b (its ring of 8 slots wraps in the steps), rwkv6-7b and
deepseek-moe-16b on all four, qwen2-vl-2b (M-RoPE, a tied head),
llama4-scout-17b-a16e (top-1 MoE), zamba2-1.2b (the SSD on each rank's
heads, its shared block's ring of 8 slots wrapping) and
seamless-m4t-medium (cross-attention over a stripe of 16 encoder
frames) on the first three, in f32, float and ternary (the configs
widened to d_model 256 so that serving packs), B=8, ``STEPS`` greedy
steps from a cache prefilled on one device
(``torch_dist_decode_workers``). Each rank holds its blocks: the params
under the train specs (``_quantized_pspecs`` for a ternary tree), the
cache under ``cache_pspecs``, its rows of the tokens. Against:

  (a) the port's one-device serve step: greedy tokens equal, logits and
      the last cache within 1e-5;
  (b) the JAX package's jitted sharded serve step on the same mesh of 4
      forced host devices, with the dry run's shardings (``lower_cell``),
      the same params, cache and tokens, in subprocesses: tokens equal,
      logits and cache within 1e-5;
  (c) every K3 output on a rank bit for bit with the matching columns of
      the one-device K3 on the same rows and the whole packed weight;
      K4 on each rank's heads and rows;
  (d) the collectives a rank issues a step, counted from the specs
      (``decode_pspecs``) by each serve rule (``layers.serve_einsum``,
      ``_moe_serve``, zamba2's ``_mamba_decode_serve``, the attentions'
      flash-decoding); none moves more bytes than the step's largest
      activation, which a gather of ``wq`` over ``data`` (an FSDP
      gather, planted) breaks;
  (e) planted faults: each rank routing its own rows of the MoE (the
      global batch's group cut in two: other capacities and drops), and
      a zeroed block of one rank a family (qwen2-vl's embedding and tied
      head, deepseek's ``we_down``, zamba2's ``out_proj``, seamless'
      cross-attention ``wo``) move the logits; every ``model`` rank
      writes the same zamba2 conv state bit for bit;
  (f) the refusals: a cache spec without a serve rule, a step outside
      serve mode, a cache or tokens without specs.

One spawn of 4 ranks runs every case, beside the JAX subprocesses.
"""
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
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import decode_collectives as DC  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import ShapeSpec  # noqa: E402
from repro_torch.distributed import runtime as R  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.distributed.mesh import Mesh  # noqa: E402
from repro_torch.launch import collective_analysis as CA  # noqa: E402
from repro_torch.launch.steps import abstract_cache  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.params import as_dtype  # noqa: E402
from repro_torch.serving import quantize_for_serving  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
TOL = 1e-5
CASES = W.ALL_CASES
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

d, steps, variants, over = (sys.argv[1], int(sys.argv[2]),
                            json.loads(sys.argv[3]), json.loads(sys.argv[4]))
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
    arch, quant, shape, variant = job.split(":")
    shape = tuple(int(x) for x in shape.split("x"))
    batch, kv = variants[variant]["batch"], variants[variant].get("kv")
    cfg = dataclasses.replace(get_config(arch, smoke=True), **{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in over[f"{arch}:{quant}"].items()})
    z = np.load(f"{d}/{arch}_{quant}" + (f"_{variant}" if variant else "")
                + ".npz")
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
    if kv is not None:
        cspecs.update(k=P(*kv), v=P(*kv))
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
    arch, quant, shape, variant = case
    return f"{arch}:{quant or 'float'}:{W.mesh_name(shape)}:{variant}"


def _jax_reference(d):
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = [_job(c) for c in CASES]
    over = json.dumps({f"{a}:{q or 'float'}": W.overrides(a, q)
                       for a in W.ARCHS for q in W.QUANTS})
    return [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_RUN), str(d),
         str(W.STEPS), json.dumps(W.VARIANTS), over, *jobs[i::JAX_PROCS]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(JAX_PROCS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_decode")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for f in W.FILES:
            W.write_case(str(d), *f)
        procs = _jax_reference(d)
        try:
            R.spawn(W.decode_rank, 4, (R.free_port(), str(d)))
            one = {f: W.one_device(str(d), *f) for f in W.FILES}
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
    arch, quant, shape, variant = case
    return f"{arch}-{quant or 'float'}-{W.mesh_name(shape)}" + (
        f"-{variant}" if variant else "")


def _key(case):
    """The case file (and one-device run) of a case."""
    return case[0], case[1], case[3]


def _near(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    return float(np.abs(got - want).max())


def _cache_tol(name, want):
    """``TOL``, except for zamba2's f32 SSM state (``"ssm"``), a running
    sum whose entries reach ~18 at these seeds: ``TOL`` of its largest
    entry (the same relative precision; the sum over 'data' of
    ``in_proj``'s partial products rounds otherwise than one product)."""
    return TOL * max(1.0, float(np.abs(want).max())) if name == "ssm" \
        else TOL


def _against(got, want):
    assert np.array_equal(got["tokens"].reshape(want["tokens"].shape),
                          want["tokens"])
    assert _near(got["logits"].reshape(want["logits"].shape),
                 want["logits"]) <= TOL
    assert sorted(got["cache"]) == sorted(want["cache"])
    for k in want["cache"]:
        assert _near(got["cache"][k], want["cache"][k]) <= _cache_tol(
            k, want["cache"][k]), k


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sharded_serve_step_matches_one_device(runs, case):
    _against(runs["ranks"][case][0], runs["one"][_key(case)])


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_sharded_serve_step_matches_the_jax_sharded_step(runs, case):
    got = runs["ranks"][case][0]
    want = runs["jax"][case]
    assert np.array_equal(got["tokens"].reshape(want["tokens"].shape),
                          want["tokens"])
    assert _near(got["logits"].reshape(want["logits"].shape),
                 want["logits"]) <= TOL
    for k in got["cache"]:
        assert _near(got["cache"][k], want["cache"][k]) <= _cache_tol(
            k, want["cache"][k]), k


@pytest.mark.parametrize("case", [c for c in CASES if c[1]], ids=_id)
def test_k3_outputs_on_every_rank_bit_for_bit(runs, case):
    cfg = W.config(case[0], case[1])
    for row in runs["ranks"][case]:
        calls, equal = row["k3"]
        assert calls == k3_per_step(cfg) * W.STEPS
        assert equal == calls


def k3_per_step(cfg) -> int:
    """K3 calls of a ternary decode step: 3 products a layer (the MLP or
    the MoE's shared experts; 8 for rwkv6), 2 an enc-dec decoder layer
    (gelu), zamba2's in_proj and out_proj a layer and its shared block's
    MLP a stage."""
    if cfg.family == "rwkv6":
        return 8 * cfg.num_layers
    if cfg.family == "encdec":
        return 2 * cfg.decoder_layers
    if cfg.family == "zamba2":
        stages = -(-cfg.num_layers // (cfg.attn_every or cfg.num_layers))
        return 2 * cfg.num_layers + 3 * stages
    return 3 * cfg.num_layers


def _sizes(case):
    return dict(zip(R.MESH_AXES[len(case[2])], case[2]))


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "rwkv6-7b"],
                         ids=_id)
def test_k4_runs_on_each_ranks_heads_and_rows(runs, case):
    """K4 on the rank's heads and rows, or, where the state's dk is split
    over 'data' (B=1 over a data axis of 2 or 4), K4's stripe entry on the
    rank's heads and its stripe of dk rows at its place."""
    cfg = W.config(case[0], case[1])
    sizes = _sizes(case)
    batch = W.VARIANTS[case[3]]["batch"]
    rows = batch // DC.row_parts(sizes, batch)
    heads = cfg.rwkv_heads // sizes["model"]
    hd = cfg.rwkv_head_dim
    split = rows == batch and sizes["data"] > 1 and case[3]
    calls = cfg.num_layers * W.STEPS
    for row in runs["ranks"][case]:
        if split:
            dk = hd // sizes["data"]
            lo = row["coords"]["data"] * dk
            assert row["k4"] == []
            assert row["stripe"] == [([rows, 1, heads, hd],
                                      [rows, heads, dk, hd], lo)] * calls
        else:
            assert row["stripe"] == []
            assert row["k4"] == [[rows, 1, heads, hd]] * calls


def expected_counts(arch, quant, shape, variant=""):
    """(launches, bytes) of one sharded decode step on a rank, from the
    specs (``tools/decode_collectives.decode_counts``, which
    ``chip_smoke.py`` holds the card's ranks against too), with the
    variant's batch, cache and cross K/V lengths and, for "dh", its KV
    spec."""
    cfg = W.config(arch, quant)
    var = W.VARIANTS[variant]
    batch = var["batch"]
    axes = R.MESH_AXES[len(shape)]
    mesh = Mesh(axes, tuple(shape), (torch.device("cpu"),) * int(
        np.prod(shape)))
    params = build_model(cfg).abstract_params()
    if quant:
        params = quantize_for_serving(params)[0]
    cache = build_model(cfg).init_cache(batch, var["cache"], device="meta")
    if cfg.family == "encdec":
        cache["ck"] = cache["cv"] = torch.empty(
            cache["k"].shape[:2] + (var["frames"],) + cache["k"].shape[3:],
            device="meta")
    allspec = SH.decode_pspecs(cfg, mesh, params, cache, batch)
    specs, cspecs = allspec["params"], allspec["cache"]
    if var.get("kv"):
        cspecs.update(k=var["kv"], v=var["kv"])
    e = torch.empty((), dtype=as_dtype(cfg.dtype)).element_size()
    groups = L.moe_groups(batch, 1, cfg) if cfg.family == "moe" else None
    return DC.decode_counts(cfg, _sizes((arch, quant, shape)), params,
                            specs, cache, cspecs, batch, e, groups)


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_collective_tallies_equal_the_count_from_the_specs(runs, case):
    want = expected_counts(*case)
    for row in runs["ranks"][case]:
        assert all(step == want for step in row["counts"]), row["coords"]


def _largest_activation(case):
    """The bytes of the step's largest activation at f32: B rows of the
    widest of d_model, d_ff, a vocab block, zamba2's in_proj output, the
    MoE's router logits and its shared experts' hidden layer, or the
    MoE's stacked gate and up products of a rank's experts (2 x E /
    |model| x capacity x expert d_ff); where rwkv6's rows are whole over
    a 'data' axis of more than one rank, also its five token-shift mixes
    (the ddlerp's (5, B, 1, d_model), which such a step gathers whole
    over 'data'; a step with its rows split there moves none of it, so a
    gather of a layer's lora block stays above its bound)."""
    cfg = W.config(case[0], case[1])
    sizes = _sizes(case)
    batch = W.VARIANTS[case[3]]["batch"]
    widths = [cfg.d_model, cfg.d_ff, cfg.vocab_size // sizes["model"]]
    if cfg.family == "rwkv6" and sizes["data"] > 1 and not DC.rows_split(
            sizes, batch):
        widths.append(5 * cfg.d_model)
    moe = 0
    if cfg.family == "zamba2":
        widths.append(2 * cfg.ssm_d_inner + 2 * cfg.ssm_state
                      + cfg.ssm_heads)
    if cfg.family == "moe":
        widths += [cfg.num_experts, cfg.num_shared_experts * cfg.expert_d_ff]
        g, _, cap = L.moe_groups(batch, 1, cfg)
        moe = (2 * (batch // g) * cfg.num_experts // sizes["model"] * cap
               * cfg.expert_d_ff)
    return max(batch * max(widths), moe) * 4


@pytest.mark.parametrize("case", CASES, ids=_id)
def test_no_collective_moves_a_parameter(runs, case):
    bound = _largest_activation(case)
    for row in runs["ranks"][case]:
        assert row["largest"][0] <= bound, row["largest"]


def _planted_is_caught(runs, case):
    bound = _largest_activation(case)
    rows = runs["ranks"][case]
    assert all(r["largest"][0] <= bound for r in rows)
    assert all(r["planted"][0] > bound for r in rows), [
        r["planted"] for r in rows]
    assert all(r["planted"][1] == "all_gather/data" for r in rows)


def test_a_planted_fsdp_gather_of_wq_is_caught(runs):
    _planted_is_caught(runs, W.PLANT)


def test_a_planted_gather_of_the_rwkv6_state_is_caught(runs):
    """rwkv6-7b at B=1 over (2, 2) with its state block gathered over
    'data' before K4 (the whole state rather than the stripe's
    partials): the largest tensor moved leaves the bound of the step's
    largest activation."""
    _planted_is_caught(runs, W.STATE_PLANT)


# Far above the sharded step's distance from one device (TOL).
CAUGHT = 1e-3


def _first_step_distance(runs, case, key):
    got = runs["ranks"][case][0][key]
    want = runs["one"][_key(case)]["logits"][0]
    return _near(got.reshape(want.shape), want)


def test_each_rank_routing_its_own_rows_is_caught(runs):
    """SMOKE deepseek-moe-16b over (2, 2): a rank holds 4 of the 8 rows
    of the global group; routed as the group, its capacity is 3 slots an
    expert and the step matches one device; routed alone (4 tokens, 2
    slots, the cumsum over its own rows) the logits move."""
    case = W.ROUTE_PLANT
    cfg = W.config(*case[:2])
    assert L.moe_groups(W.BATCH, 1, cfg)[2] == 3
    assert L.moe_groups(W.BATCH // 2, 1, cfg)[2] == 2
    assert _near(runs["ranks"][case][0]["logits"][0],
                 runs["one"][_key(case)]["logits"][0]) <= TOL
    assert _first_step_distance(runs, case, "route") > CAUGHT


def test_copies_of_a_whole_row_change_the_moe_alone(runs):
    """B=1 over (2, 2) with the rows taken as split over 'data' (the rule
    before the step read the rows' layout from the tokens' spec): the row
    is gathered into two copies. The dense products still sum each
    row's partial products once (llama3.2-1b within ``TOL`` of one
    device on every rank), but the MoE routes
    both copies as one group of 2 tokens: capacity 1 drops the second
    copy's choices, and the ranks of data coordinate 1 get that copy's
    output (deepseek's logits move there, not on data rank 0). Without
    copies the group is the JAX package's: 1 token, capacity 1."""
    moe, dense = W.COPIES_PLANT
    cfg = W.config(*moe[:2])
    assert L.moe_groups(1, 1, cfg)[2] == 1
    assert L.moe_groups(2, 1, cfg)[2] == 1

    def distance(case):
        want = runs["one"][_key(case)]["logits"][0]
        return {r["coords"]["data"]: _near(
            r["copies"].reshape(want.shape), want)
            for r in runs["ranks"][case]}
    got = distance(moe)
    assert got[0] <= TOL and got[1] > CAUGHT, got
    assert max(distance(dense).values()) <= TOL


@pytest.mark.parametrize("case", list(W.FAULTS), ids=_id)
def test_a_planted_fault_of_each_family_is_caught(runs, case):
    """Rank 0's block of one leaf a family zeroed (``W.FAULTS``): the
    first step's logits leave one device by far more than ``TOL``."""
    assert _first_step_distance(runs, case, "fault") > CAUGHT


@pytest.mark.parametrize("case", [c for c in CASES if c[0] == "zamba2-1.2b"
                                  and (c[2][-1] > 1 or c[3] == "b1")],
                         ids=_id)
def test_every_model_rank_writes_the_same_zamba2_conv_state(runs, case):
    """The conv cache keeps the whole conv dim on every ``model`` rank
    (``cache_pspecs``), and its rows on every ``data`` rank where the
    batch does not divide 'data' (B=1): after every step the ranks that
    hold one block hold the same bits."""
    rows = runs["ranks"][case]
    whole = case[3] == "b1"
    for data in {r["coords"].get("data", 0) for r in rows}:
        mine = [r["conv"] for r in rows
                if whole or r["coords"].get("data", 0) == data]
        assert len(mine) == (4 if whole else case[2][-1])
        assert len(mine[0]) == W.STEPS
        for other in mine[1:]:
            assert all(np.array_equal(a.view(np.uint32), b.view(np.uint32))
                       for a, b in zip(mine[0], other))


# ----------------------------------------------------------------------
# (f) refusals, on one rank of a fake process group
# ----------------------------------------------------------------------


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


@pytest.mark.parametrize("arch", ["llama3.2-1b", "rwkv6-7b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_context_parallel_caches_trace(arch):
    """B=1 over (2, 2): the batch does not divide ``data``, so
    ``cache_pspecs`` puts ``data`` on the sequence (KV, the enc-dec's
    cross K/V, zamba2's shared block) or on a state dim (rwkv6's dk,
    zamba2's SSM head dim); the step traces on fake tensors and returns
    the tokens and a block of the new cache, tagged with their specs."""
    from repro_torch.distributed import annotate as A
    tok, cache = _serve_on_fake_mesh(get_config(arch, smoke=True), (2, 2),
                                     1)
    assert tuple(tok.shape) == (1, 1) and A.spec_of(tok) == (None, None)
    assert all(A.spec_of(t) is not None for k, t in cache.items()
               if k != "pos")


@pytest.mark.parametrize("leaf,spec", [
    ("k", (None, None, None, None, "data")),
    ("attn_k", (None, None, "data", "model", "model")),
    ("state", (None, None, "model", None, "data")),
    ("tm_x", (None, None, "data"))],
    ids=["kv_head_dim_on_data", "kv_two_on_model", "state_dv_on_data",
         "token_shift_on_data"])
def test_cache_specs_without_a_serve_rule_are_refused(leaf, spec):
    """A cache spec that ``cache_pspecs`` never gives has no serve rule:
    the step refuses it, naming the rule of its kind of leaf."""
    from repro_torch.distributed import annotate as A
    cfg = get_config("llama3.2-1b", smoke=True)
    t = torch.zeros((2,) * len(spec))
    A.tag(t, spec)
    with CA.fake_process_mesh((2, 2), "cpu") as pm, pm, \
            A.execution_mode("serve"):
        with pytest.raises(NotImplementedError, match="has no serve rule"):
            L.check_sharded_decode(cfg, {leaf: t})


@pytest.mark.parametrize("arch,match", [
    ("deepseek-moe-16b", "fallback layout"), ("zamba2-1.2b", "SSM heads")],
    ids=["moe", "zamba2"])
def test_layouts_without_a_serve_rule_are_refused(arch, match):
    """A model axis of 16 over SMOKE widths: deepseek's 8 experts do not
    divide it (the specs put each expert's mlp dim there), nor do
    zamba2's 8 SSM heads."""
    with pytest.raises(NotImplementedError, match=match):
        _serve_on_fake_mesh(get_config(arch, smoke=True), (1, 16), 8)


def test_decode_outside_serve_mode_and_untagged_caches_are_refused():
    cfg = get_config("llama3.2-1b", smoke=True)
    with pytest.raises(NotImplementedError, match="runs in serve mode"):
        _serve_on_fake_mesh(cfg, (2, 2), 8, serve=False)
    with pytest.raises(ValueError, match="without a spec"):
        _serve_on_fake_mesh(cfg, (2, 2), 8, tag_cache=False)


def test_untagged_tokens_are_refused_and_the_step_tags_its_tokens():
    """Under a process mesh the step reads the rows' layout from the
    tokens' spec: untagged tokens raise; the tokens it returns carry the
    spec of those it took, so steps chain."""
    from repro_torch.distributed import annotate as A
    cfg = get_config("llama3.2-1b", smoke=True)
    tok, _ = _serve_on_fake_mesh(cfg, (2, 2), 8)
    assert A.spec_of(tok) == ("data", None)
    real = SH.local_block

    def untagged(tree, specs, pm, device=None):
        out = real(tree, specs, pm, device)
        if isinstance(out, torch.Tensor) and out.dtype == torch.int32:
            out = out.clone()             # a copy carries no tag
        return out
    SH.local_block = untagged
    try:
        with pytest.raises(ValueError, match="tokens without a spec"):
            _serve_on_fake_mesh(cfg, (2, 2), 8)
    finally:
        SH.local_block = real


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
