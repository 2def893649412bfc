"""The dry run's per-device collectives (``launch.collective_analysis``,
the role of the JAX package's ``launch/hlo_analysis.py``) on the CPU.

  * the ring formulas: :func:`collective_bytes` of a step's tallies equals
    ``repro.launch.hlo_analysis.collective_bytes`` of an HLO text listing
    the same operations (group sizes are powers of two, as on the
    production meshes, so every volume is exact in both);
  * one rank's sharded SMOKE step traced on fake tensors over a fake
    process group issues exactly the collectives that
    ``test_torch_dist_train.expected_counts`` counts from the specs for
    one step (the real four-rank runs of that file are held to the same
    count), on the (2, 2), (1, 4) and (2, 2, 1) meshes;
  * llama3.2-1b at full width and 4 of 16 layers, bf16, B=4, S=1024,
    with remat, over a fake (2, 2, 1) mesh: the tallies four gloo ranks
    measured on the H100 (chip_smoke's ``lm_train_sharded``, PERF.md);
  * one rank's sharded SMOKE decode step (the serve step on its blocks,
    float and ternary, of every family) issues exactly what
    ``test_torch_dist_decode.expected_counts`` counts from the specs (the
    real four-rank runs of that file are held to the same count);
  * the dry run's records: ``collectives`` for both production meshes of
    a train and a decode cell, and the reason where there is none (a
    model the sharded trainer refuses; a context-parallel decode cache,
    with its ROADMAP item).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES, ShapeSpec  # noqa: E402
from repro_torch.launch import collective_analysis as CA  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from test_torch_dist_decode import W as DW  # noqa: E402
from test_torch_dist_decode import expected_counts as decode_counts  # noqa
from test_torch_dist_train import W, expected_counts  # noqa: E402

# One rank's step a pod run of llama3.2-1b at 4 layers (PR 31's card run,
# four gloo ranks on one H100): collective tallies and tensor bytes.
LLAMA_POD_STEP = {
    "all_gather/data": (58, 2_023_751_680),
    "reduce_scatter/data": (30, 1_537_212_416),
    "all_reduce/data": (6, 36_876),
    "all_reduce/pod": (14, 505_974_796),
}
# SMOKE traces on the (2, 2), (1, 4) and (2, 2, 1) meshes: the dense,
# rwkv6 (heads over 'model'), MoE (experts over 'model', pod sums) and
# zamba2 (SSD heads) layers. The four-rank runs of
# test_torch_dist_train.py hold every arch on every mesh to the same
# count.
SMOKE_CASES = [("llama3.2-1b", (2, 2)), ("rwkv6-7b", (1, 4)),
               ("deepseek-moe-16b", (2, 2, 1)), ("zamba2-1.2b", (2, 2))]

_HLO_OPS = {"all_gather": "all-gather", "reduce_scatter": "reduce-scatter",
            "all_reduce": "all-reduce", "all_to_all": "all-to-all"}


def _hlo(ops):
    """An HLO text with one collective a line: ``ops`` are (op, group
    size, result shape, dtype), each a replica group of that size (a
    reduce-scatter's operand g times its result)."""
    lines = []
    for i, (op, g, shape, dtype) in enumerate(ops):
        res = f"{dtype}[{','.join(map(str, shape))}]"
        arg = res if op != "reduce_scatter" else \
            f"{dtype}[{','.join(map(str, (shape[0] * g,) + shape[1:]))}]"
        groups = "{{" + ",".join(map(str, range(g))) + "}}"
        lines.append(f"  %c.{i} = {res}{{0}} {_HLO_OPS[op]}({arg} %p.{i}), "
                     f"replica_groups={groups}")
    return "\n".join(lines)


def _tallies(ops, axis_of):
    """The tallies ``distributed.collectives`` keeps of ``ops``: one
    launch each, the gathered tensor of an all-gather, the whole input of
    a reduce-scatter, the tensor of an all-reduce or an all-to-all."""
    size = {"bf16": 2, "f32": 4}
    launches, nbytes = {}, {}
    for op, g, shape, dtype in ops:
        key = (op, axis_of[g])
        n = size[dtype]
        for d in shape:
            n *= d
        launches[key] = launches.get(key, 0) + 1
        nbytes[key] = nbytes.get(key, 0) + n * (g if op == "reduce_scatter"
                                                else 1)
    return launches, nbytes


@pytest.mark.parametrize("ops", [
    [("all_gather", 16, (4096, 128), "bf16")],
    [("reduce_scatter", 16, (256, 2048), "f32"),
     ("reduce_scatter", 16, (64, 7), "bf16")],
    [("all_reduce", 2, (262_144,), "f32"), ("all_reduce", 16, (3,), "f32")],
    [("all_gather", 16, (64, 32), "bf16"), ("all_gather", 2, (8, 8), "f32"),
     ("reduce_scatter", 16, (4, 32), "bf16"),
     ("all_reduce", 16, (1000,), "f32"), ("all_reduce", 2, (512, 3), "bf16"),
     ("all_gather", 16, (128,), "f32")],
    [("all_to_all", 16, (128, 2048), "bf16"),
     ("all_to_all", 2, (8, 1, 64), "f32"), ("all_gather", 16, (8,), "f32")],
], ids=["gather", "scatter", "reduce", "mixed", "all_to_all"])
def test_ring_formulas_equal_hlo_analysis(ops):
    from repro.launch.hlo_analysis import collective_bytes as jax_bytes
    axis_of = {2: "pod", 16: "data"}
    launches, nbytes = _tallies(ops, axis_of)
    got = CA.collective_bytes(launches, nbytes, {"pod": 2, "data": 16,
                                                 "model": 1})
    want = jax_bytes(_hlo(ops))
    for key in ("bytes_by_kind", "count_by_kind", "total_bytes"):
        assert got[key] == want[key], key
    # An axis of one rank issues nothing (collectives' identities).
    assert CA.collective_bytes({("all_reduce", "model"): 3},
                               {("all_reduce", "model"): 12},
                               {"model": 1})["total_bytes"] == 0


@pytest.mark.parametrize("arch,shape", SMOKE_CASES,
                         ids=[f"{a}-{W.mesh_name(m)}" for a, m in SMOKE_CASES])
def test_smoke_trace_equals_the_count_from_the_specs(arch, shape):
    cfg = get_config(arch, smoke=True)
    with CA.fake_process_mesh(shape, "cpu") as pm:
        got = CA.trace_step(cfg, ShapeSpec("t", "train", W.SEQ, W.BATCH),
                            pm, remat=False)
    want = {k: v // W.STEPS for k, v in expected_counts(arch, shape).items()}
    assert got["launches"] == want


DECODE_CASES = [("llama3.2-1b", None, (2, 2)),
                ("h2o-danube-1.8b", "ternary", (1, 4)),
                ("rwkv6-7b", "ternary", (2, 2)),
                ("rwkv6-7b", None, (2, 2, 1)),
                ("qwen2-vl-2b", "ternary", (1, 4)),
                ("deepseek-moe-16b", None, (2, 2, 1)),
                ("llama4-scout-17b-a16e", "ternary", (2, 2)),
                ("zamba2-1.2b", "ternary", (2, 2)),
                ("zamba2-1.2b", None, (1, 4)),
                ("seamless-m4t-medium", None, (2, 2))]


@pytest.mark.parametrize(
    "arch,quant,shape", DECODE_CASES,
    ids=[f"{a}-{q or 'float'}-{W.mesh_name(m)}" for a, q, m in DECODE_CASES])
def test_smoke_decode_trace_equals_the_count_from_the_specs(arch, quant,
                                                            shape):
    cfg = DW.config(arch, quant)
    with CA.fake_process_mesh(shape, "cpu") as pm:
        got = CA.trace_step(cfg, ShapeSpec("d", "decode", DW.CACHE,
                                           DW.BATCH), pm, quant=quant)
    assert (got["launches"], got["tensor_bytes"]) == decode_counts(
        arch, quant, shape)


def test_llama_pod_trace_equals_the_card_run():
    cfg = dataclasses.replace(get_config("llama3.2-1b"), num_layers=4)
    assert cfg.dtype == "bfloat16"
    with CA.fake_process_mesh((2, 2, 1), "cpu") as pm:
        got = CA.trace_step(cfg, ShapeSpec("t", "train", 1024, 4), pm,
                            remat=True)
    assert {k: (got["launches"][k], got["tensor_bytes"][k])
            for k in got["launches"]} == LLAMA_POD_STEP
    rec = CA.collective_bytes(got["launches"], got["tensor_bytes"],
                              {"pod": 2, "data": 2, "model": 1})
    assert rec["count_by_kind"] == {"all-gather": 58, "reduce-scatter": 30,
                                    "all-reduce": 20}
    assert rec["bytes_by_kind"]["all-reduce"] == 36_876 + 505_974_796


def test_records_hold_collectives_or_their_reason(monkeypatch, tmp_path):
    """A SMOKE llama train cell's record (one layer) has ``collectives``
    on both production meshes, and so has its decode cell (the serve
    step's all-to-alls among them), and a MoE's (16 experts, so that they
    divide the model axis), and a long_500k cell (B=1: a
    context-parallel cache, the rows whole on every rank: all-reduces
    and gathers over 'data', no all-to-all); a SMOKE rwkv6 (four heads)
    on a model axis of 16 holds the trainer's refusal."""
    monkeypatch.setattr(DR, "get_config", lambda arch: dataclasses.replace(
        get_config(arch, smoke=True), num_layers=1))
    monkeypatch.setattr(DR, "OUT_DIR", tmp_path)
    DR.main(["--arch", "llama3.2-1b", "--shape", "train_4k",
             "--device", "cpu", "--force"])
    rec = json.loads((tmp_path / "llama3.2-1b__train_4k.json").read_text())
    assert rec["status"] == "ok"
    for name in ("pod16x16", "pod2x16x16"):
        col = rec["meshes"][name]["collectives"]
        assert col["total_bytes"] > 0 and col["step"] == "train"
        assert set(col["count_by_kind"]) <= set(CA.KINDS.values())
        assert col["total_bytes"] == pytest.approx(
            sum(col["bytes_by_kind"].values()), rel=1e-12)
    assert "all_reduce/pod" in \
        rec["meshes"]["pod2x16x16"]["collectives"]["by_op_axis"]
    assert "all_reduce/pod" not in \
        rec["meshes"]["pod16x16"]["collectives"]["by_op_axis"]
    mesh = make_production_mesh(multi_pod=False)
    dec = CA.mesh_collectives(get_config("llama3.2-1b", smoke=True),
                              SHAPES["decode_32k"], mesh, "cpu")
    assert dec["step"] == "decode" and dec["count_by_kind"]["all-to-all"] > 0
    assert set(dec["count_by_kind"]) <= set(CA.KINDS.values())
    moe = CA.mesh_collectives(dataclasses.replace(
        get_config("deepseek-moe-16b", smoke=True), num_layers=1,
        num_experts=16), SHAPES["decode_32k"], mesh, "cpu")
    assert moe["step"] == "decode" and moe["count_by_kind"]["all-to-all"] > 0
    # SMOKE zamba2 at d_model 128, so that its 16 SSM heads divide the
    # model axis of 16: B=1 puts the SSM head dim over 'data' and the
    # shared block's 16-slot window over 'model'.
    long = CA.mesh_collectives(dataclasses.replace(
        get_config("zamba2-1.2b", smoke=True), d_model=128),
        SHAPES["long_500k"], mesh, "cpu")
    assert long["step"] == "decode" and "error" not in long
    assert long["by_op_axis"]["all_reduce/data"]["count"] > 0
    assert long["by_op_axis"]["all_gather/data"]["count"] > 0
    assert "all_to_all/data" not in long["by_op_axis"]
    assert "reduce_scatter/data" not in long["by_op_axis"]
    ref = CA.mesh_collectives(get_config("rwkv6-7b", smoke=True),
                              SHAPES["train_4k"], mesh, "cpu")
    assert ref["error"].startswith("NotImplementedError: rwkv6-7b-smoke")
    assert "would split a head" in ref["error"]


def test_rwkv6_long_500k_cell_runs_the_stripe_entry():
    """rwkv6's long_500k cell on pod16x16 (SMOKE at 16 heads of 64, so that
    the heads divide the model axis; one layer): B=1 puts the state's dk
    over 'data', 4 rows a rank. The trace's K4 calls are the stripe
    entry's, one a layer, with its 7 * dk_loc * hd FLOPs a head; the
    partials are gathered over 'data' (4 segments of one row-stripe each
    over 16 ranks: (1, 1, 1, 16, 64) f32), and the record has
    collectives."""
    from repro_torch.kernels import wkv6_scan as k4
    cfg = dataclasses.replace(get_config("rwkv6-7b", smoke=True),
                              d_model=1024, rwkv_head_dim=64, num_layers=1)
    mesh = make_production_mesh(multi_pod=False)
    calls, flops = k4.stripe_shape_only_calls, k4.shape_only_flops
    with CA.fake_process_mesh((16, 16), "cpu") as pm:
        got = CA.trace_step(cfg, SHAPES["long_500k"], pm)
    assert k4.stripe_shape_only_calls == calls + 1
    assert k4.shape_only_flops == flops + 7 * 1 * 4 * 64
    assert got["launches"]["all_gather/data"] >= 1
    rec = CA.mesh_collectives(cfg, SHAPES["long_500k"], mesh, "cpu")
    assert "error" not in rec and rec["total_bytes"] > 0
    assert "all_to_all/data" not in rec["by_op_axis"]
