"""The port's dry run (``launch.dryrun``) on the CPU: bytes against the
JAX package's abstract trees for every cell, FLOPs against a closed form,
K3's and K4's shape-only branches, the per-device bytes of the
production meshes and the CLI.

Full-size cells are never traced here: their bytes come from the meta
trees the trace starts from (``abstract_cell``). The traces run on fake
CPU tensors at small widths. Every comparison is exact: bytes and FLOPs
are integer arithmetic on shapes.
"""
import dataclasses
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as JAX_SHAPES  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.launch import steps as JST  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving.serve import \
    quantize_for_serving as jax_quantize  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.shapes import (SHAPES, ShapeSpec,  # noqa: E402
                                        cells_for)
from repro_torch.kernels import ternary_matmul as k3  # noqa: E402
from repro_torch.kernels import wkv6_scan as k4  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402


def _jax_bytes(tree):
    return sum(math.prod(x.shape) * np.dtype(x.dtype).itemsize
               for x in jax.tree.leaves(tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_bytes_equal_jax(arch):
    """Params, AdamW state, cache and inputs of every cell, bf16 and
    ternary decode, against prod(shape) * itemsize over the JAX
    package's abstract trees (``eval_shape`` of its
    ``quantize_for_serving`` for the ternary params)."""
    jcfg, cfg = jax_get_config(arch), get_config(arch)
    jparams = jax_build_model(jcfg).abstract_params()
    jq = None
    for cell in cells_for(cfg):
        jshape = JAX_SHAPES[cell.name]
        want = {"params": _jax_bytes(jparams),
                "inputs": _jax_bytes(JST.input_specs(jcfg, jshape))}
        if cell.kind == "train":
            want["opt"] = _jax_bytes(JST.abstract_opt_state(jcfg))
        if cell.kind == "decode":
            want["cache"] = _jax_bytes(JST.abstract_cache(jcfg, jshape))
        got = {k: DR.tree_bytes(v)
               for k, v in DR.abstract_cell(cfg, cell).items()}
        assert got == want, cell.name
        if cell.kind != "decode":
            continue
        if jq is None:
            jq = jax.eval_shape(lambda p: jax_quantize(p)[0], jparams)
            q = DR.abstract_cell(cfg, cell, "ternary")["params"]
        assert DR.tree_bytes(q) == _jax_bytes(jq), cell.name


def _small_dense():
    return dataclasses.replace(get_config("llama3.2-1b", smoke=True),
                               num_layers=2)


def _closed_form(cfg, kind, b, s):
    """The matmul FLOPs of a dense swiglu model with tied embeddings, 2
    per multiply-add: per layer the q/k/v and o projections, the scores
    and the weighted values over every key (the blockwise attention
    computes masked blocks too), the MLP's three products; then the
    lm_head. A decode step attends over the ``s`` cache slots. A train
    step runs the forward, remat's recompute of each layer and the
    backward (2 products a forward one), less each layer's down
    projection in the recompute: torch.utils.checkpoint stops
    recomputing once the saved activations are back, and nothing saves
    that product's output."""
    nl, d, f, v = cfg.num_layers, cfg.d_model, cfg.d_ff, cfg.vocab_size
    h, kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rows = b * (1 if kind == "decode" else s)
    proj = 2 * rows * d * hd * (h + 2 * kv) + 2 * rows * h * hd * d
    attn = 2 * 2 * b * h * hd * s * (1 if kind == "decode" else s)
    mlp = 3 * 2 * rows * d * f
    layer, head, down = proj + attn + mlp, 2 * rows * d * v, 2 * rows * f * d
    if kind == "train":
        return nl * (4 * layer - down) + 3 * head
    return nl * layer + head


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_flops_equal_closed_form(kind):
    cfg = _small_dense()
    b, s = 2, 48
    rec = DR.analyze(DR.lower_cell(cfg, ShapeSpec("x", kind, s, b), "cpu"),
                     "cpu")
    assert rec["flops"] == rec["counted_flops"] == _closed_form(cfg, kind,
                                                                b, s)
    assert rec["k3"] == rec["k4"] == {"calls": 0, "flops": 0}
    assert rec["fits"] and rec["memory"]["capacity_bytes"] == DR.CARD_BYTES
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"]


def _ternary_dense():
    """A dense config whose MLP products are packed (dims >= 256)."""
    return dataclasses.replace(_small_dense(), d_model=256, d_ff=512,
                               head_dim=64)


def test_ternary_decode_counts_k3():
    cfg = _ternary_dense()
    b, s = 2, 32
    before = k3.launches
    rec = DR.analyze(DR.lower_cell(cfg, ShapeSpec("x", "decode", s, b),
                                   "cpu", quant="ternary"), "cpu")
    k3_flops = cfg.num_layers * 3 * 2 * b * cfg.d_model * cfg.d_ff
    assert rec["k3"] == {"calls": 3 * cfg.num_layers, "flops": k3_flops}
    assert rec["flops"] == (_closed_form(cfg, "decode", b, s) - k3_flops
                            + rec["k3"]["flops"])
    assert rec["counted_flops"] == _closed_form(cfg, "decode", b, s) - \
        k3_flops
    assert k3.launches == before


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_rwkv_counts_k4(kind):
    cfg = get_config("rwkv6-7b", smoke=True)
    b, s = 2, 32
    before = k4.launches
    low = DR.lower_cell(cfg, ShapeSpec("x", kind, s, b), "cpu")
    t = 1 if kind == "decode" else s
    calls = cfg.num_layers * (2 if kind == "train" else 1)   # remat
    hd = cfg.rwkv_head_dim
    assert low["k4"] == {"calls": calls, "flops": calls * 7 * b * t
                         * cfg.rwkv_heads * hd * hd}
    assert k4.launches == before


def test_k3_shape_only_matches_plain():
    g = torch.Generator().manual_seed(0)
    w = torch.randint(0, 255, (32, 40), dtype=torch.uint8, generator=g)
    scale = torch.rand(40, generator=g)
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(3, 5, 128, generator=g).to(dtype)
        want = k3.ternary_matmul_plain(x, w, scale)
        calls, flops, launches = (k3.shape_only_calls, k3.shape_only_flops,
                                  k3.launches)
        got = k3.ternary_matmul_fwd(x.to("meta"), w.to("meta"),
                                    scale.to("meta"))
        assert (got.shape, got.dtype, got.device.type) == (
            want.shape, want.dtype, "meta")
        assert k3.shape_only_calls == calls + 1
        assert k3.shape_only_flops == flops + 2 * 15 * 128 * 40
        assert k3.launches == launches
    with pytest.raises(ValueError, match="K/4"):
        k3.ternary_matmul_fwd(x[..., :64].to("meta"), w.to("meta"),
                              scale.to("meta"))


@pytest.mark.parametrize("state", [False, True])
def test_k4_shape_only_matches_plain(state):
    g = torch.Generator().manual_seed(1)
    b, t, h, hd = 2, 3, 2, 16
    r, k, v = (torch.randn(b, t, h, hd, generator=g).bfloat16()
               for _ in range(3))
    logw = -torch.rand(b, t, h, hd, generator=g)
    u = torch.randn(h, hd, generator=g).bfloat16()
    s0 = torch.randn(b, h, hd, hd, generator=g) if state else None
    want = k4.wkv6_scan_plain(r, k, v, logw, u, s0)
    calls, flops, launches = (k4.shape_only_calls, k4.shape_only_flops,
                              k4.launches)
    meta = [None if x is None else x.to("meta")
            for x in (r, k, v, logw, u, s0)]
    got = k4.wkv6_scan_fwd(*meta)
    assert [(x.shape, x.dtype, x.device.type) for x in got] == [
        (x.shape, x.dtype, "meta") for x in want]
    assert k4.shape_only_calls == calls + 1
    assert k4.shape_only_flops == flops + 7 * b * t * h * hd * hd
    assert k4.launches == launches


class _JaxMesh:
    def __init__(self, mesh):
        self.axis_names = mesh.axis_names
        self.devices = np.empty(mesh.devices.shape)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_mesh_bytes_follow_jax_specs(multi_pod):
    """Per-device argument bytes of a train and a decode cell: each JAX
    leaf's bytes over the product of its JAX spec's axis sizes."""
    mesh = make_production_mesh(multi_pod=multi_pod)
    jmesh = _JaxMesh(mesh)
    sizes = mesh.shape

    def per_device(tree, specs):
        total = 0
        for x, sp in zip(jax.tree.leaves(tree), jax.tree.leaves(
                specs, is_leaf=lambda s: isinstance(
                    s, jax.sharding.PartitionSpec))):
            n = math.prod(sizes[a] for e in sp if e is not None
                          for a in (e if isinstance(e, tuple) else (e,)))
            total += math.prod(x.shape) * np.dtype(x.dtype).itemsize // n
        return total

    for arch, cell in (("llama3.2-1b", "train_4k"),
                       ("rwkv6-7b", "decode_32k")):
        jcfg, cfg = jax_get_config(arch), get_config(arch)
        shape, jshape = SHAPES[cell], JAX_SHAPES[cell]
        jdefs = jax_build_model(jcfg).defs()
        jparams = jax_build_model(jcfg).abstract_params()
        want = {"params": per_device(jparams, JSH.param_pspecs(jdefs,
                                                               jmesh))}
        if shape.kind == "train":
            want["opt"] = per_device(JST.abstract_opt_state(jcfg),
                                     JSH.opt_pspecs(jdefs, jmesh))
            binputs = JST.input_specs(jcfg, jshape)
            bspecs = JSH.batch_pspecs(jcfg, jmesh, shape.global_batch,
                                      "train")
            want["inputs"] = per_device(binputs, {k: bspecs[k]
                                                  for k in binputs})
        else:
            jcache = JST.abstract_cache(jcfg, jshape)
            want["cache"] = per_device(jcache, JSH.cache_pspecs(
                jcfg, jmesh, jcache, shape.global_batch))
            b = JSH._batch_dim_spec(jmesh, shape.global_batch)
            want["inputs"] = per_device(
                JST.input_specs(jcfg, jshape),
                {"tokens": jax.sharding.PartitionSpec(b, None)})
        got = DR.mesh_bytes(cfg, shape, DR.abstract_cell(cfg, shape), mesh)
        assert got["by_kind"] == want, (arch, cell)
        assert got["argument_bytes"] == sum(want.values())
        assert got["num_devices"] == mesh.size


def _smoke_cli(monkeypatch, tmp_path):
    monkeypatch.setattr(DR, "get_config",
                        lambda arch: get_config(arch, smoke=True))
    monkeypatch.setattr(DR, "OUT_DIR", tmp_path)


def test_cli_writes_a_record(monkeypatch, tmp_path):
    _smoke_cli(monkeypatch, tmp_path)
    DR.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
             "--device", "cpu", "--force", "--no-depth-variants"])
    rec = json.loads((tmp_path / "llama3.2-1b__decode_32k.json").read_text())
    assert rec["status"] == "ok" and rec["device"] == "cpu"
    assert rec["kind"] == "decode" and rec["global_batch"] == 128
    assert set(rec["meshes"]) == {"pod16x16", "pod2x16x16"}
    assert rec["full"]["flops"] > 0 and rec["full"]["fits"] is True
    mem = rec["full"]["memory"]
    assert mem["argument_bytes"] == (mem["param_bytes"] + mem["cache_bytes"]
                                     + mem["input_bytes"])


def test_cli_records_a_failed_cell_and_exits_1(monkeypatch, tmp_path):
    _smoke_cli(monkeypatch, tmp_path)

    def boom(*a, **k):
        raise RuntimeError("no trace")
    monkeypatch.setattr(DR, "lower_cell", boom)
    with pytest.raises(SystemExit) as exc:
        DR.main(["--arch", "llama3.2-1b", "--shape", "prefill_32k",
                 "--mesh", "single", "--device", "cpu"])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "llama3.2-1b__prefill_32k.json")
                     .read_text())
    assert rec["status"] == "error" and "no trace" in rec["error"]
