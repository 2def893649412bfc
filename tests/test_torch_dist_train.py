"""Sharded LM training in the port: ``Trainer(shardings=...)`` over a
process mesh of 4 ``gloo`` ranks on the CPU, ``("data", "model")``
meshes (2, 2), (4, 1) and (1, 4) and ``("pod", "data", "model")`` meshes
(2, 2, 1) and (2, 1, 2), SMOKE llama3.2-1b, rwkv6-7b, deepseek-moe-16b,
llama4-scout-17b-a16e, qwen2-vl-2b (with patch embeddings), zamba2-1.2b
and seamless-m4t-medium (with encoder frames) in f32, B=4, S=16, 3
steps, from the same params and batches (``torch_dist_workers``); and
llama3.2-1b and deepseek-moe-16b on global batches that do not divide
``data`` (B=3 over (2, 2): rows copied over ``data``; B=2 over (2, 2, 1):
rows over ``pod`` alone) and over a 1-D ``("data",)`` mesh of 4,
against:

  (a) the port's one-device ``Trainer``, with chip_smoke's
      ``_lt_compare`` measures, tighter than its ``LT_*`` gates: each
      step's loss within rtol 1e-6 (``LT_LOSS_RTOL`` 1e-5; seen 3.1e-7)
      and its gradient norm within 1e-5 (``GRAD_NORM_RTOL``);
      after the first step the first moments within 1e-5 of each leaf's
      largest (``LT_GRAD_TOL`` 1e-3; seen 2.6e-6) and the params within
      1e-3 lr where the moment is well above its error (``LT_PARAM_TOL``
      1e-2 lr; seen 6e-5 lr); after the third the moments within 1e-4
      (seen 3.8e-5). Three AdamW steps amplify rounding: the one-device
      trainer from params moved by 1e-7 relative noise gives 2.6e-5 and
      0.14 lr on confident params after three steps, so only the first
      step's params are held to the lr measure; every step's params stay
      within their bound 2 lr (1 + wd |p|). The sharded step differs from
      the one-device step only in the order of its sums (the MoE aux
      loss's statistics are means of the data ranks' means);
  (b) the JAX package's ``Trainer(shardings=...)`` on the same mesh of
      4 forced host devices, the same batches, in subprocesses: losses
      within 1e-5 relative (with the MoE aux loss counted once);
  (c) the collectives each step issues, counted from the specs
      (``param_pspecs``) and the layers' TP, expert-parallel and SSD-head
      sites, the gradients' sums over ``pod``, and K4's and zamba2's SSD
      calls on every rank: layers x steps, each on the rank's
      (B/(|pod| |data|), S, H/|model|, 64 or 16) block;
  (d) sharded ``moe_apply`` of one layer on every mesh against the
      one-device call: the chosen experts and ``keep`` the same bits on
      every ``model`` rank and equal to one device's, output, aux and
      gradients within 1e-5 of their largest (or of the rounding floor
      that a nudged cotangent shows, ``MOE_*``);
  (e) sharded zamba2 ``_mamba_forward`` of one layer likewise: each
      rank's SSD on its ssm_heads/|model| heads, their state, output and
      gradients within 1e-5 of their largest.

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

import torch_dist_workers as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import make_mesh, param_pspecs  # noqa: E402
from repro_torch.distributed import runtime as R  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL, M1_TOL, M3_TOL, PARAM1_TOL = 1e-6, 1e-5, 1e-4, 1e-3
# Each step's gradient norm before clipping (seen 3.0e-6 at most, zamba2
# at (2, 1, 2)): the norms are 4-9, so clipping and AdamW take out the
# gradients' scale, and a row counted twice would show here alone.
GRAD_NORM_RTOL = 1e-5
JAX_LOSS_RTOL = 1e-5
# (arch, mesh shape, global batch)
CASES = [(a, m, W.BATCH) for m in W.MESHES for a in W.ARCHS]
BATCH_CASES = [(a, m, b) for m, b in W.BATCH_MESHES for a in W.BATCH_ARCHS]
# The cases the JAX package's sharded trainer runs too (every one but the
# (4, 1) and (1, 4) meshes).
JAX_CASES = [c for c in CASES + BATCH_CASES if c[1] not in ((4, 1), (1, 4))]
JAX_PROCS = 3
MOE_CASES = [(a, m) for m in W.MESHES for a in W.MOE_ARCHS]
# Sharded moe_apply against one device: every value within MOE_TOL of
# its largest (seen 2.6e-6 and less), or within MOE_FLOOR times the
# change that a relative nudge of MOE_NUDGE of the output cotangent makes
# on one device, where that is larger: with top_k = 1 (llama4-scout) the
# renormalized gate is v / v, whose gradient is zero but for rounding, so
# the router's gradient is that rounding's residue plus the aux loss's
# (the nudge moves it by 4.9e-5 of its largest; the sharded call differed
# by 5.2e-5 at (1, 4)). Elsewhere the nudge moves a gradient by <= 3.4e-7.
MOE_TOL, MOE_NUDGE, MOE_FLOOR = 1e-5, 1e-7, 4.0

_JAX_RUN = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from repro.configs import get_config
from repro.distributed import make_mesh
from repro.distributed.sharding import opt_pspecs, param_pspecs, shardings
from repro.models import build_model
from repro.training import AdamWConfig, Trainer, TrainerConfig
from repro.training.optimizer import adamw_init

d, steps, lr = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
AXES = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}
out = {}
for job in sys.argv[4:]:
    arch, shape, batch = job.split(":")
    shape = tuple(int(x) for x in shape.split("x"))
    z = np.load(f"{d}/{arch}_b{batch}.npz")
    params = {}
    for k in z.files:
        if k.startswith("p/"):
            node = params
            parts = k[2:].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(z[k])
    model = build_model(get_config(arch, smoke=True))
    mesh = make_mesh(shape, AXES[len(shape)])
    sh = shardings(mesh, {"params": param_pspecs(model.defs(), mesh),
                          "opt": opt_pspecs(model.defs(), mesh),
                          "err": P()})
    state = {"params": params, "opt": adamw_init(params),
             "err": jnp.zeros(())}
    batches = lambda s: {k.split("/", 1)[1]: jnp.asarray(z[k])
                         for k in z.files if k.startswith(f"b{s}/")}
    tc = TrainerConfig(total_steps=steps, ckpt_every=1000,
                       ckpt_dir=f"{d}/ckpt_{job}", log_every=1000,
                       opt=AdamWConfig(lr=lr, warmup_steps=1,
                                       total_steps=steps))
    tr = Trainer(model, tc, batches, shardings=sh)
    with mesh:
        res = tr.run(jax.random.PRNGKey(0),
                     start_state=jax.device_put(state, sh))
    out[job] = [h["loss"] for h in res["history"]]
print("LOSSES " + json.dumps(out))
"""


def _job(case):
    arch, shape, batch = case
    return f"{arch}:{W.mesh_name(shape)}:{batch}"


def _jax_reference(d):
    """Start the JAX package's sharded trainer on 4 forced host devices
    for every case of ``JAX_CASES`` (the params and batches of
    ``torch_dist_workers``, through npz), in ``JAX_PROCS`` subprocesses
    of a share of the cases each."""
    for arch, batch in sorted({(a, b) for a, _, b in JAX_CASES}):
        arrays = {"p/" + k: v for k, v in W.flat(W.params(arch)).items()}
        for s in range(W.STEPS):
            arrays.update({f"b{s}/{k}": v
                           for k, v in W.np_inputs(arch, s, batch).items()})
        np.savez(os.path.join(d, f"{arch}_b{batch}.npz"), **arrays)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    jobs = [_job(c) for c in JAX_CASES]
    return [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_JAX_RUN), str(d),
         str(W.STEPS), str(W.LR), *jobs[i::JAX_PROCS]],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for i in range(JAX_PROCS)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_train")
    procs = _jax_reference(d)
    try:
        R.spawn(W.train_rank, 4, (R.free_port(), str(d)))
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = {(arch, batch): W.one_device(arch, batch=batch)
                   for arch, batch in sorted({(a, b) for a, _, b in
                                              CASES + BATCH_CASES})}
            cfg, p, x, ct = W.mamba_inputs()
            one["mamba"] = W.mamba_call(cfg, p, x, ct)
            one["mamba_floor"] = W.mamba_call(cfg, p, x, ct * (
                1 + MOE_NUDGE * torch.from_numpy(np.random.default_rng(4)
                                                 .normal(size=ct.shape)
                                                 .astype(np.float32))))
            for arch in W.MOE_ARCHS:
                cfg, p, x, ct = W.moe_inputs(arch)
                one[("moe_apply", arch)] = W.moe_call(cfg, p, x, ct)
                one[("moe_floor", arch)] = W.moe_call(
                    cfg, p, x, ct * (1 + MOE_NUDGE * torch.from_numpy(
                        np.random.default_rng(3).normal(size=ct.shape)
                        .astype(np.float32))))["grads"]
        finally:
            torch.set_num_threads(threads)
        jax = {}
        for proc in procs:
            out, err = proc.communicate(timeout=600)
            assert proc.returncode == 0, err[-3000:]
            line = [x for x in out.splitlines()
                    if x.startswith("LOSSES ")][-1]
            jax.update(json.loads(line[len("LOSSES "):]))
    finally:
        for proc in procs:
            proc.kill()
    cases = {}
    for arch, shape, batch in CASES + BATCH_CASES:
        case = W.case_name(arch, shape, batch)
        with open(d / f"{case}.pkl", "rb") as f:
            got = cases[(arch, shape, batch)] = pickle.load(f)
        scans = [json.loads((d / f"wkv_{case}_{r}.json").read_text())
                 for r in range(4)]
        for key in ("wkv", "ssd"):
            got[key] = [x[key] for x in scans]
    moe = {}
    for arch, shape in MOE_CASES:
        case = W.case_name(arch, shape)
        moe[(arch, shape)] = []
        for r in range(4):
            with open(d / f"moe_{case}_{r}.pkl", "rb") as f:
                moe[(arch, shape)].append(pickle.load(f))
    mamba = {}
    for shape in W.MESHES:
        case = W.case_name(W.MAMBA_ARCH, shape)
        mamba[shape] = []
        for r in range(4):
            with open(d / f"mamba_{case}_{r}.pkl", "rb") as f:
                mamba[shape].append(pickle.load(f))
    return dict(one=one, jax=jax, cases=cases, moe=moe, mamba=mamba)


def _id(case):
    arch, shape, *batch = case
    return f"{arch}-{W.mesh_name(shape)}" + (
        f"-b{batch[0]}" if batch and batch[0] != W.BATCH else "")


def _mesh_id(shape):
    return W.mesh_name(shape)


@pytest.mark.parametrize("case", CASES + BATCH_CASES, ids=_id)
def test_sharded_trainer_matches_one_device(runs, case):
    got, one = runs["cases"][case], runs["one"][(case[0], case[2])]
    np.testing.assert_allclose(got["losses"], one["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["grad_norms"], one["grad_norms"],
                               rtol=GRAD_NORM_RTOL)
    assert sorted(got["params"]) == sorted(one["params"])
    first = W.compare(got["params1"], got["m1"], one["params1"], one["m1"],
                      W.LR)
    assert first["m_rel"] <= M1_TOL, first
    assert first["param_confident"] <= PARAM1_TOL, first
    assert first["param_bounded"] <= 1.0, first
    last = W.compare(got["params"], got["m"], one["params"], one["m"], W.LR)
    assert last["m_rel"] <= M3_TOL, last
    assert last["param_bounded"] <= 1.0, last


@pytest.mark.parametrize("arch", W.ARCHS)
def test_sharded_losses_match_the_jax_sharded_trainer(runs, arch):
    case = (arch, (2, 2), W.BATCH)
    np.testing.assert_allclose(runs["cases"][case]["losses"],
                               runs["jax"][_job(case)], rtol=JAX_LOSS_RTOL)


@pytest.mark.parametrize("case", [c for c in JAX_CASES if c[1] != (2, 2)
                                  or c[2] != W.BATCH], ids=_id)
def test_pod_mesh_and_batch_losses_match_the_jax_sharded_trainer(runs,
                                                                  case):
    """The pod meshes, the batches that do not divide ``data`` and the
    1-D mesh against the JAX package's sharded trainer on the same mesh
    and batches."""
    np.testing.assert_allclose(runs["cases"][case]["losses"],
                               runs["jax"][_job(case)], rtol=JAX_LOSS_RTOL)


def _specs(arch, shape):
    """{leaf path: (spec of one layer's block, logical shape of it, number
    of layers)} from ``param_pspecs`` on a meta mesh of ``shape``."""
    mesh = make_mesh(shape, R.MESH_AXES[len(shape)],
                     devices=[torch.device("meta")] * 4)
    model = build_model(get_config(arch, smoke=True))
    specs, defs = param_pspecs(model.defs(), mesh), model.defs()
    out = {}

    def walk(s, dd, path):
        if isinstance(dd, dict):
            for k in dd:
                walk(s[k], dd[k], path + (k,))
            return
        stacked = dd.axes[0] == "layers"
        out["/".join(path)] = (tuple(s)[1:] if stacked else tuple(s),
                               dd.shape[1:] if stacked else dd.shape,
                               dd.shape[0] if stacked else 1)
    walk(specs, defs, ())
    return out


def _layout(shape, cands, sizes):
    """The layout ``annotate.fsdp_layout`` picks (axes the mesh lacks
    dropped, so they divide)."""
    for cand in tuple(cands) + ((None,) * len(shape),):
        cand = tuple(cand) + (None,) * (len(shape) - len(cand))
        cand = tuple(e if e in sizes else None for e in cand)
        if all(n % (sizes[e] if e else 1) == 0 for n, e in zip(shape, cand)):
            return cand


UP, DOWN = ((None, "model"), ("model", None)), (("model", None),
                                                (None, "model"))


def _attn_uses(cfg, tp, prefix):
    heads = (None, "model", None)
    kv = heads if cfg.num_kv_heads % tp == 0 else (None, None, None)
    wo = ("model", None, None) if cfg.num_heads % tp == 0 else (None,) * 3
    return [(f"{prefix}/wq", (heads,)), (f"{prefix}/wk", (kv,)),
            (f"{prefix}/wv", (kv,)), (f"{prefix}/wo", (wo,))]


def _gated(cfg):
    """Whether the MLP has a gate projection (MoE's shared experts
    always)."""
    return cfg.activation == "swiglu" or cfg.family == "moe"


def _mlp_uses(cfg, prefix):
    gate = [(f"{prefix}/w_gate", UP)] if _gated(cfg) else []
    return gate + [(f"{prefix}/w_up", UP), (f"{prefix}/w_down", DOWN)]


def _stages(cfg):
    """zamba2's shared-block invocations: one per stage of Mamba
    layers."""
    return -(-cfg.num_layers // (cfg.attn_every or cfg.num_layers))


def _uses(cfg, tp):
    """Each gather at use of a step's forward: (leaf path, candidates),
    as the models call ``unshard_fsdp`` (once a layer for stacked
    leaves; zamba2's shared block once an invocation)."""
    head = [("embed", (("model", None),)), ("lm_head", ((None, "model"),))]
    if cfg.family == "rwkv6":
        uses = head + [(f"layers/tm/{k}", ()) for k in ("lora_a", "lora_b",
                                                        "wa", "wb")]
        uses += [(f"layers/tm/{k}", UP) for k in ("wr", "wk", "wv", "wg")]
        uses += [("layers/tm/wo", DOWN), ("layers/cm/wk", UP),
                 ("layers/cm/wv", DOWN), ("layers/cm/wr", UP)]
        if tp > 1:
            uses.append(("layers/tm/u", (("model", None),)))
        return uses
    if cfg.family == "zamba2":
        shared = (_attn_uses(cfg, tp, "shared/attn")
                  + _mlp_uses(cfg, "shared/mlp"))
        return head + [("layers/out_proj", DOWN)] + shared * _stages(cfg)
    if cfg.family == "encdec":
        return head + [("frontend_proj", ((None, None),))] + (
            _attn_uses(cfg, tp, "encoder/attn")
            + _mlp_uses(cfg, "encoder/mlp")
            + _attn_uses(cfg, tp, "decoder/self_attn")
            + _attn_uses(cfg, tp, "decoder/cross_attn")
            + _mlp_uses(cfg, "decoder/mlp"))
    uses = head[:1] + ([("embed", (("model", None),))] if cfg.tie_embeddings
                       else head[1:]) + _attn_uses(cfg, tp, "layers/attn")
    if cfg.family != "moe":
        return uses + _mlp_uses(cfg, "layers/mlp")
    experts = (("model", None, None),)
    return uses + [("layers/moe/router", ((None, "model"),)),
                   ("layers/moe/we_gate", experts),
                   ("layers/moe/we_up", experts),
                   ("layers/moe/we_down", experts)] + _mlp_uses(
                       cfg, "layers/moe/shared")


# zamba2's weights gathered whole at use (annotate.gather_whole): every
# sharded dim all-gathered, reduce-scattered back.
WHOLE = {"zamba2": ("layers/in_proj", "layers/conv_w", "layers/conv_b")}


def _attn_tp(cfg, tp, cross=False):
    """The all-reduces over 'model' of one attention: q's copy_to (shared
    by K/V under kv_tp, else K's and V's), a cross-attention's kv_x
    copy_to under kv_tp, wo's; none where the heads do not divide."""
    if cfg.num_heads % tp:
        return 0
    kv_tp = cfg.num_kv_heads % tp == 0
    return 1 + (int(cross) if kv_tp else 2) + 1


def _mlp_tp(cfg):
    """The all-reduces over 'model' of one MLP: the up projections'
    copy_to, the down's."""
    return (2 if _gated(cfg) else 1) + 1


def expected_counts(arch, shape):
    """The collectives of one step: the FSDP gathers (and their
    reduce-scatters) and ``model`` moves of every use, from the specs;
    the TP sites of the layers (``copy_to``/row-parallel all-reduces,
    zamba2's SSD heads, the vocab-parallel embedding and loss); the
    loss's and the global norm's reductions over every batch axis, the
    gradient sums of the leaves replicated over ``data`` and of every
    leaf over ``pod``. A batch that does not divide ``data`` issues the
    same collectives (its rows are copied over the axis)."""
    cfg = get_config(arch, smoke=True)
    sizes = W.sizes(shape)
    dsz, tp, psz = (sizes.get(a, 1) for a in ("data", "model", "pod"))
    specs = _specs(arch, shape)
    n = collections.Counter()
    for path, cands in _uses(cfg, tp):
        spec, logical, layers = specs[path]
        if dsz > 1 and "data" in spec:
            n["all_gather/data"] += layers
            n["reduce_scatter/data"] += layers
        src = spec.index("model") if "model" in spec else None
        lay = _layout(logical, cands, sizes)
        dst = lay.index("model") if "model" in lay else None
        if tp > 1 and src != dst:     # gather_from forward, split_to back
            n["all_gather/model"] += layers * ((src is not None)
                                               + (dst is not None))
    for path in WHOLE.get(cfg.family, ()):
        spec, _, layers = specs[path]
        for axis in filter(None, spec):
            if sizes[axis] > 1:
                n[f"all_gather/{axis}"] += layers
                n[f"reduce_scatter/{axis}"] += layers
    if dsz > 1:
        n["all_reduce/data"] += 3 + sum(
            "data" not in s for s, _, _ in specs.values())
        if cfg.family == "moe":        # the aux loss's me and ce_frac
            n["all_reduce/data"] += 2 * cfg.num_layers
    if psz > 1:
        # every leaf's gradient; the loss's total and count, the global
        # norm; the MoE aux loss's me and ce_frac
        n["all_reduce/pod"] += len(specs) + 3 + 2 * cfg.num_layers * (
            cfg.family == "moe")
    if tp > 1:
        nl = cfg.num_layers
        if cfg.family == "rwkv6":
            # r/k/v/g copy_to, wo, cm: wk copy_to, wv, wr copy_to
            n["all_reduce/model"] += 8 * nl
            # split_to of dec/w0/gn_s/gn_b back, cm.wr's gathered output
            n["all_gather/model"] += 5 * nl
        elif cfg.family == "zamba2":
            # in_proj's copy_to, norm_s's statistic (forward, and its
            # copy_to back), out_proj; norm_s's split_to back
            n["all_reduce/model"] += 4 * nl
            n["all_gather/model"] += nl
            n["all_reduce/model"] += _stages(cfg) * (_attn_tp(cfg, tp)
                                                     + _mlp_tp(cfg))
        elif cfg.family == "encdec":
            n["all_reduce/model"] += cfg.encoder_layers * (
                _attn_tp(cfg, tp) + _mlp_tp(cfg)) + cfg.decoder_layers * (
                _attn_tp(cfg, tp) + _attn_tp(cfg, tp, cross=True)
                + _mlp_tp(cfg))
        else:
            # attention; the MLP's (or the shared experts')
            n["all_reduce/model"] += (_attn_tp(cfg, tp) + _mlp_tp(cfg)) * nl
            if cfg.family == "moe":
                # xg's copy_to and the combine's all-reduce; the gathered
                # logits and the combine's split_to back
                n["all_reduce/model"] += 2 * nl
                n["all_gather/model"] += 2 * nl
        # with the vocab on 'model': the embedding, the head's copy_to,
        # the loss (sum of exps, target logit, max); the global norm
        vocab = cfg.vocab_size % tp == 0
        n["all_reduce/model"] += (1 + 1 + 3) * vocab + 1
    return {k: v * W.STEPS for k, v in sorted(n.items())}


@pytest.mark.parametrize("case", CASES + BATCH_CASES, ids=_id)
def test_collective_tallies_equal_the_count_from_the_specs(runs, case):
    assert runs["cases"][case]["counts"] == expected_counts(case[0], case[1])


@pytest.mark.parametrize("shape", W.MESHES, ids=_mesh_id)
def test_ssd_runs_on_each_ranks_heads(runs, shape):
    """zamba2's SSD scan on every rank: layers x steps calls, each on the
    rank's (B/(|pod| |data|), S, ssm_heads/|model|, head_dim) block."""
    cfg = get_config(W.MAMBA_ARCH, smoke=True)
    want = [[W.BATCH // W.row_blocks(shape), W.SEQ,
             cfg.ssm_heads // W.sizes(shape)["model"],
             cfg.ssm_head_dim]] * (cfg.num_layers * W.STEPS)
    for rank_calls in runs["cases"][(W.MAMBA_ARCH, shape, W.BATCH)]["ssd"]:
        assert rank_calls == want


@pytest.mark.parametrize("shape", W.MESHES, ids=_mesh_id)
def test_k4_runs_on_each_ranks_heads(runs, shape):
    cfg = get_config("rwkv6-7b", smoke=True)
    want = [[W.BATCH // W.row_blocks(shape), W.SEQ,
             cfg.rwkv_heads // W.sizes(shape)["model"],
             cfg.rwkv_head_dim]] * (cfg.num_layers * W.STEPS)
    for rank_calls in runs["cases"][("rwkv6-7b", shape, W.BATCH)]["wkv"]:
        assert rank_calls == want


# The uses whose chosen layout puts 'model' elsewhere than the stored
# spec: llama3.2-1b, llama4-scout and qwen2-vl on (1, 4) store wk/wv with
# head_dim on 'model' (2 KV heads do not divide 4) and use them whole (the JAX
# package's kv_tp fallback), so a gather over 'data' alone would not do.
DISAGREE = {arch: [((64, 2, 4), ("data", None, "model"), (None, None, None))]
            for arch in (("llama3.2-1b", (1, 4)),
                         ("llama4-scout-17b-a16e", (1, 4)),
                         ("qwen2-vl-2b", (1, 4)))}


@pytest.mark.parametrize("case", CASES + BATCH_CASES, ids=_id)
def test_layouts_that_disagree_with_the_stored_spec(runs, case):
    got = [(tuple(shape), tuple(stored), tuple(lay))
           for shape, stored, lay in runs["cases"][case]["layouts"]
           if (stored.index("model") if "model" in stored else None)
           != (lay.index("model") if "model" in lay else None)]
    assert got == DISAGREE.get(case[:2], [])


def _near(got, want, what, floor=0.0):
    top = float(np.abs(want).max())
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= max(MOE_TOL * top, MOE_FLOOR * floor), (what, err, top,
                                                          floor)


@pytest.mark.parametrize("case", MOE_CASES, ids=_id)
def test_sharded_moe_apply_against_one_device(runs, case, record_property):
    """Layer 0's ``moe_apply`` on every rank's blocks and rows: the routing
    is the same bits on the ``model`` ranks of a row block and equal to
    one device's; output, aux, the x gradient and (gathered) every
    parameter's gradient within ``MOE_TOL`` of their largest. The
    smallest gap between a token's k-th and (k+1)-th probability is
    recorded: a tie within rounding could route differently."""
    arch, shape = case
    cfg = get_config(arch, smoke=True)
    one = runs["one"][("moe_apply", arch)]
    (route,) = one["routes"]
    probs = np.sort(route["probs"].numpy(), axis=-1)[..., ::-1]
    gap = float((probs[..., cfg.top_k - 1] - probs[..., cfg.top_k]).min())
    record_property("min_kth_gap", gap)
    g = route["gate_idx"].shape[1]
    ranks = runs["moe"][case]
    by_rows = {}
    for got in ranks:
        lo, hi = got["rows"]
        (r,) = got["routes"]
        grp = slice(lo * W.SEQ // g, hi * W.SEQ // g)
        for key in ("gate_idx", "keep"):
            assert np.array_equal(r[key], route[key].numpy()[grp]), (
                key, got["coords"])
        first = by_rows.setdefault((lo, hi), r)
        for key in ("gate_idx", "keep", "probs"):
            assert first[key].tobytes() == r[key].tobytes(), (
                key, got["coords"])
        _near(got["out"], one["out"].numpy()[lo:hi], "out")
        _near(got["x_grad"], one["x_grad"].numpy()[lo:hi], "x grad")
        np.testing.assert_allclose(got["aux"], float(one["aux"]),
                                   rtol=MOE_TOL)
    assert len(by_rows) == W.row_blocks(shape)
    grads = ranks[0]["grads"]
    assert sorted(grads) == sorted(one["grads"])
    nudged = runs["one"][("moe_floor", arch)]
    for k, v in one["grads"].items():
        _near(grads[k], v.numpy(), k,
              float((v - nudged[k]).abs().max()))


@pytest.mark.parametrize("shape", W.MESHES, ids=_mesh_id)
def test_sharded_mamba_forward_against_one_device(runs, shape):
    """Layer 0's ``_mamba_forward`` of SMOKE zamba2 on every rank's blocks
    and rows: each rank's SSD ran on its ssm_heads/|model| heads and
    left their state, within ``MOE_TOL`` of one device's heads of it;
    the output, the x gradient and (gathered) every parameter's gradient
    within ``MOE_TOL`` of their largest, or of ``MOE_FLOOR`` times what a
    nudge of the cotangent moves on one device (every gradient here
    moves by <= 1e-6 of its largest, so the floor never decides)."""
    cfg = get_config(W.MAMBA_ARCH, smoke=True)
    one, nudged = runs["one"]["mamba"], runs["one"]["mamba_floor"]
    ranks = runs["mamba"][shape]
    per = cfg.ssm_heads // W.sizes(shape)["model"]
    for got in ranks:
        lo, hi = got["rows"]
        h0, h1 = got["heads"]
        assert h1 - h0 == per
        assert got["ssd"] == [[hi - lo, W.SEQ, per, cfg.ssm_head_dim]]
        _near(got["state"], one["state"].numpy()[lo:hi, h0:h1], "state")
        _near(got["out"], one["out"].numpy()[lo:hi], "out")
        _near(got["x_grad"], one["x_grad"].numpy()[lo:hi], "x grad")
    assert sorted({r["heads"] for r in ranks}) == [
        (i * per, (i + 1) * per) for i in range(W.sizes(shape)["model"])]
    grads = ranks[0]["grads"]
    assert sorted(grads) == sorted(one["grads"])
    for k, v in one["grads"].items():
        _near(grads[k], v.numpy(), k,
              float((v - nudged["grads"][k]).abs().max()))
