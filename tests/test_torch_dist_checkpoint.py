"""Sharded LM training's state across ranks and restarts, 4 ``gloo``
ranks on the CPU (``torch_dist_workers.ckpt_rank``, one spawn):

  * the FSDP collectives and their gradients against their definitions;
  * the backward of a sharded loss, run on a thread where no mesh is
    active (the autograd engine's device thread on the card), with and
    without remat, gives the same thread's gradients bit for bit;
  * ``compress_grads`` over blocks of a (2, 2) mesh sends exactly the
    JAX package's entries (its global per-leaf threshold, ties included)
    over three steps with error feedback: sent and residuals bit for bit,
    the norm within rtol 1e-6; on the ``("pod", "data", "model")`` meshes
    (2, 2, 1) and (2, 1, 2) likewise, from each rank's part of the
    gradient summed by ``trainer.reduce_grads``;
  * a checkpoint written by the 4 ranks of (2, 2) or of (2, 2, 1) holds
    the members of the one-device port's for the same state byte for
    byte (f32 and bf16 params), and the same manifest but for its time;
    one written on any of (2, 2, 1), (2, 2) and one device restores onto
    the others bit for bit;
  * a run crashed before step 2 and restarted from its checkpoints is
    the uninterrupted sharded run bit for bit (losses and params);
  * a (1, 4) mesh, a (2, 2, 1) mesh and one device, relaunched from the
    (2, 2) run's step-2 checkpoint, continue its step 3 within the
    first-step
    tolerances of ``test_torch_dist_train`` (loss rtol 1e-6, moments 1e-5
    of the largest, confident params 1e-3 lr, every param within its
    bound);
  * over the mesh ``run_with_restarts`` restarts on a simulated failure
    alone: a plain error on one rank, or on all of them, ends the run
    (``spawn`` raises) instead of restarting;
  * ``launch.train --mesh 2x2 --spawn --smoke --device cpu`` trains two
    steps (llama3.2-1b, deepseek-moe-16b, qwen2-vl-2b, zamba2-1.2b and
    seamless-m4t-medium), and so does ``--mesh 2x2x1``;
    ``Trainer(shardings=...)`` takes ``("pod", "data", "model")``,
    ``("data", "model")`` and ``("data",)`` meshes and refuses other axes,
    and heads or experts that a model axis would split, by name;
  * ``moe_groups`` groups the global batch as the JAX package does where
    the rows are copied over a batch axis, and ``runtime.init`` refuses a
    mesh of other dims.
"""
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro.training.compression import (  # noqa: E402
    compress_grads as jax_compress)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import runtime as R  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.training import Trainer  # noqa: E402
from repro_torch.training.trainer import state_shardings  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LOSS_RTOL, M_TOL, PARAM_TOL = 1e-6, 1e-5, 1e-3


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist_ckpt")
    R.spawn(W.ckpt_rank, 4, (R.free_port(), str(d)))
    with open(d / "ckpt.pkl", "rb") as f:
        return d, pickle.load(f)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_compression_masks_equal_the_jax_packages_on_sharded_leaves(runs):
    _, res = runs
    err = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                       W.grad_tree(0))
    for s in range(3):
        sent, err, m = jax_compress(jax.tree.map(jnp.asarray,
                                                 W.grad_tree(s)),
                                    err, ratio=W.COMP_RATIO)
        got = res[f"comp{s}"]
        for key, want in (("sent", sent), ("err", err)):
            for path, a in W.flat(got[key]).items():
                b = np.asarray(want["a"] if path == "a" else want["b"]["w"])
                assert a.tobytes() == b.tobytes(), (s, key, path)
        np.testing.assert_allclose(got["norm"],
                                   float(m["compressed_grad_norm"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("key, tree_fn", [("pod_comp", W.grad_tree),
                                          ("pod_moe_comp", W.moe_grad_tree)],
                         ids=["2x2x1", "moe-2x1x2"])
def test_compression_masks_on_a_pod_mesh_equal_the_jax_packages(runs, key,
                                                               tree_fn):
    """Each rank of a pod mesh holds a part of the gradient (1/|pod| of
    it, and a leaf replicated over ``data`` split over the data ranks);
    ``reduce_grads`` sums the parts, so ``compress_grads`` sends exactly
    the JAX package's entries of the whole gradient, ties included."""
    _, res = runs
    err = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                       tree_fn(0))
    for s in range(3):
        sent, err, m = jax_compress(jax.tree.map(jnp.asarray, tree_fn(s)),
                                    err, ratio=W.COMP_RATIO)
        got = res[f"{key}{s}"]
        for part, want in (("sent", sent), ("err", err)):
            want = W._paths(want)
            for path, a in W.flat(got[part]).items():
                assert a.tobytes() == np.asarray(want[path]).tobytes(), (
                    s, part, path)
        np.testing.assert_allclose(got["norm"],
                                   float(m["compressed_grad_norm"]),
                                   rtol=1e-6)


def test_compression_masks_on_moe_leaves_equal_the_jax_packages(runs):
    """As above, on expert-parallel leaves (experts on 'model', the embed
    dims on 'data'): a zero expert, ties inside one expert and across
    experts."""
    _, res = runs
    err = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                       W.moe_grad_tree(0))
    for s in range(3):
        sent, err, m = jax_compress(jax.tree.map(jnp.asarray,
                                                 W.moe_grad_tree(s)),
                                    err, ratio=W.COMP_RATIO)
        got = res[f"moe_comp{s}"]
        for key, want in (("sent", sent), ("err", err)):
            for path, a in W.flat(got[key]).items():
                assert a.tobytes() == np.asarray(want[path]).tobytes(), (
                    s, key, path)
        np.testing.assert_allclose(got["norm"],
                                   float(m["compressed_grad_norm"]),
                                   rtol=1e-6)


@pytest.mark.parametrize("op", ["all_gather", "reduce_scatter"])
def test_fsdp_collectives_and_their_gradients(runs, op):
    """``collectives.all_gather`` (gradient reduce-scattered) and
    ``reduce_scatter`` (gradient all-gathered) over 'data' of a (2, 2)
    mesh against their definitions on whole tensors, on every rank."""
    _, res = runs
    assert res["collectives"][op]


@pytest.mark.parametrize("arch", W.ARCHS)
def test_backward_on_another_thread_with_and_without_remat(runs, arch):
    """The gradients on every rank when the backward runs on a thread
    with no mesh active (as the autograd engine's device threads run it
    on the card), with remat's recompute there too, equal the same
    thread's bit for bit."""
    _, res = runs
    assert res[f"thread_backward_{arch}"]


def _members(path):
    with zipfile.ZipFile(path / "arrays.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_a_four_rank_checkpoint_is_the_one_device_ports(runs, dtype,
                                                         tmp_path):
    d, _ = runs
    st = W.start_state("llama3.2-1b")
    st["params"] = tree_map(lambda x: x.to(getattr(torch, dtype)),
                            st["params"])
    W.trainer("llama3.2-1b", ckpt_dir=tmp_path).save(5, st)
    four, one = d / f"save4_{dtype}" / "step_00000005", \
        tmp_path / "step_00000005"
    assert _members(four) == _members(one)
    m4, m1 = (json.loads((p / "manifest.json").read_text())
              for p in (four, one))
    assert m4.pop("time") > 0 and m1.pop("time") > 0
    assert m4 == m1


def _same_checkpoint(d, arch, tmp_path):
    W.trainer(arch, ckpt_dir=tmp_path).save(5, W.start_state(arch))
    four, one = d / f"save4_{arch}" / "step_00000005", \
        tmp_path / "step_00000005"
    assert _members(four) == _members(one)
    m4, m1 = (json.loads((p / "manifest.json").read_text())
              for p in (four, one))
    assert m4.pop("time") > 0 and m1.pop("time") > 0
    assert m4 == m1


@pytest.mark.parametrize("arch", W.FAMILY_ARCHS)
def test_a_four_rank_checkpoint_of_each_family_is_the_one_device_ports(
        runs, arch, tmp_path):
    """The VLM's, zamba2's (SSD heads and conv on 'model', in_proj over
    both axes) and the enc-dec's blocks of a (2, 2) mesh written as the
    whole arrays the one-device trainer writes, byte for byte."""
    _same_checkpoint(runs[0], arch, tmp_path)


def test_a_pod_mesh_checkpoint_is_the_one_device_ports(runs, tmp_path):
    """The blocks of a (2, 2, 1) mesh, whose pods hold copies of them,
    written as the whole arrays the one-device trainer writes, byte for
    byte."""
    d, _ = runs
    W.trainer("llama3.2-1b", ckpt_dir=tmp_path).save(
        5, W.start_state("llama3.2-1b"))
    four, one = d / "save_pod" / "step_00000005", tmp_path / "step_00000005"
    assert _members(four) == _members(one)


@pytest.mark.parametrize("name", [r[0] for r in W.RESTORES])
def test_a_checkpoint_restores_bit_for_bit_onto_another_mesh(runs, name):
    """A checkpoint of one device, of (2, 2) or of (2, 2, 1) restored onto
    another of them: every rank's blocks equal its blocks of the saved
    state bit for bit."""
    _, res = runs
    assert res[f"restore_{name}"]


def test_a_pod_mesh_checkpoint_restores_bit_for_bit_onto_one_device(
        runs, tmp_path):
    d, _ = runs
    shutil.copytree(d / "save_pod" / "step_00000005",
                    tmp_path / "step_00000005")
    tr = W.trainer("llama3.2-1b", ckpt_dir=tmp_path)
    step, got, _ = tr.restore(tr.init_state())
    assert step == 5
    want = W.flat(W.start_state("llama3.2-1b"))
    got = W.flat(got)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].tobytes() == v.tobytes(), k


@pytest.mark.parametrize("arch", W.MOE_ARCHS)
def test_a_four_rank_moe_checkpoint_is_the_one_device_ports(runs, arch,
                                                             tmp_path):
    """The expert-parallel blocks of a (2, 2) mesh written as the whole
    arrays the one-device trainer writes, byte for byte."""
    _same_checkpoint(runs[0], arch, tmp_path)


@pytest.mark.parametrize("arch", W.ARCHS)
def test_crash_and_restart_is_the_uninterrupted_sharded_run(runs, arch):
    _, res = runs
    plain, crash = res[arch]["plain"], res[arch]["crash"]
    assert len(plain["losses"]) == 3
    assert crash["losses"] == plain["losses"][2:]
    assert sorted(crash["params"]) == sorted(plain["params"])
    for k, v in plain["params"].items():
        assert crash["params"][k].tobytes() == v.tobytes(), k


def _continues(got, plain):
    np.testing.assert_allclose(got["losses"], plain["losses"][2:],
                               rtol=LOSS_RTOL)
    row = W.compare(got["params"], got["m"], plain["params"], plain["m"],
                    W.LR)
    assert row["m_rel"] <= M_TOL, row
    assert row["param_confident"] <= PARAM_TOL, row
    assert row["param_bounded"] <= 1.0, row


@pytest.mark.parametrize("arch", W.ARCHS)
def test_elastic_restart_onto_another_mesh(runs, arch):
    _, res = runs
    _continues(res[arch]["elastic"], res[arch]["plain"])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_elastic_restart_onto_a_pod_mesh(runs, arch):
    _, res = runs
    _continues(res[arch]["elastic_pod"], res[arch]["plain"])


@pytest.mark.parametrize("arch", W.ARCHS)
def test_elastic_restart_onto_one_device(runs, arch, tmp_path, one_thread):
    d, res = runs
    shutil.copytree(d / f"{arch}_plain" / "step_00000002",
                    tmp_path / "step_00000002")
    tr = W.trainer(arch, ckpt_dir=tmp_path, ckpt_every=1)
    out = tr.run_with_restarts(torch.Generator().manual_seed(7),
                               failure_hook=W.crash_at(0))
    st = out["state"]
    _continues(dict(losses=[h["loss"] for h in out["history"]],
                    params=W.flat(st["params"]), m=W.flat(st["opt"]["m"])),
               res[arch]["plain"])


@pytest.mark.parametrize("failing", [(1,), (0, 1, 2, 3)],
                         ids=["one_rank", "every_rank"])
def test_an_error_that_is_not_simulated_ends_the_sharded_run(tmp_path,
                                                             failing):
    import torch.multiprocessing as mp
    with pytest.raises(mp.ProcessRaisedException,
                       match="RuntimeError: simulated node failure"):
        R.spawn(W.fail_rank, 4, (R.free_port(), str(tmp_path), failing))
    # the step-1 checkpoint was written, and no rank restored from it
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000001"]


def _launch(tmp_path, arch, mesh="2x2"):
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch,
         "--smoke", "--mesh", mesh, "--spawn", "--steps", "2", "--batch",
         "4", "--seq", "16", "--device", "cpu", "--ckpt-dir",
         str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "mesh of 4 ranks (gloo)" in out.stdout
    assert "over 2 steps" in out.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_00000001", "step_00000002"]


def test_launch_train_moe_mesh_spawn_trains_two_steps(tmp_path):
    _launch(tmp_path, "deepseek-moe-16b")


def test_launch_train_mesh_spawn_trains_two_steps(tmp_path):
    _launch(tmp_path, "llama3.2-1b")


def test_launch_train_pod_mesh_spawn_trains_two_steps(tmp_path):
    _launch(tmp_path, "llama3.2-1b", "2x2x1")


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_launch_train_mesh_spawn_trains_every_family(tmp_path, arch):
    """The VLM on token-only batches, zamba2, and the enc-dec on its
    launcher-drawn frames, as the JAX launcher feeds them."""
    _launch(tmp_path, arch)


def _mesh(shape, axes):
    return R.ProcessMesh(axes, shape, (torch.device("cpu"),) * 4)


@pytest.mark.parametrize("shape, axes", [
    ((1, 2, 2), ("pod", "data", "model")), ((2, 2), ("data", "model")),
    ((4,), ("data",))], ids=["pod-data-model", "data-model", "data"])
def test_the_training_meshes_are_taken(shape, axes):
    model = build_model(get_config("llama3.2-1b", smoke=True))
    tr = Trainer(model, W.trainer_config(), W.batch_fn("llama3.2-1b"),
                 shardings=state_shardings(model, _mesh(shape, axes)))
    assert tr.pmesh.axis_names == axes


@pytest.mark.parametrize("shape, axes", [
    ((2, 2), ("model", "data")), ((2, 2), ("pod", "data")),
    ((4,), ("model",))], ids=["model-data", "pod-data", "model"])
def test_meshes_over_other_axes_are_refused(shape, axes):
    model = build_model(get_config("llama3.2-1b", smoke=True))
    with pytest.raises(NotImplementedError, match=r"a \(.*\) mesh: sharded "
                       r"training runs over \('pod', 'data', 'model'\)"):
        Trainer(model, W.trainer_config(), W.batch_fn("llama3.2-1b"),
                shardings=state_shardings(model, _mesh(shape, axes)))


@pytest.mark.parametrize("shape, batch", [((2, 2), 3), ((2, 2, 1), 2),
                                          ((4,), 4), ((1, 2, 2), 3)],
                         ids=["2x2-b3", "2x2x1-b2", "4-b4", "1x2x2-b3"])
def test_moe_groups_group_the_global_batch_as_the_jax_package(shape, batch):
    """A rank's rows of SMOKE deepseek's global batch, as
    ``Trainer.local_batch`` gives them (``batch_pspecs``, copied over the
    axes that do not divide it; ``moe_check_batch`` passes them): their
    groups are the JAX package's groups of the global batch
    (``g = min(moe_group_size, B * S)``, its capacity from g), a rank's
    share of them."""
    from repro_torch.models import layers as L
    cfg = get_config("deepseek-moe-16b", smoke=True)
    model = build_model(cfg)
    tr = Trainer(model, W.trainer_config(),
                 W.batch_fn("deepseek-moe-16b", batch=batch),
                 shardings=state_shardings(
                     model, _mesh(shape, R.MESH_AXES[len(shape)])))
    rows = tr.local_batch(tr.batch_fn(0))["tokens"].shape[0]
    blocks = W.row_blocks(shape, batch)
    assert rows * blocks == batch
    g_jax = min(cfg.moe_group_size, batch * W.SEQ)
    cap_jax = min(int(math.ceil(g_jax * cfg.top_k * cfg.capacity_factor
                                / cfg.num_experts)), g_jax)
    g, ng, cap = L.moe_groups(rows, W.SEQ, cfg)
    assert (g, cap) == (g_jax, cap_jax)
    assert ng * blocks == batch * W.SEQ // g_jax


def test_a_mesh_of_other_dims_is_refused_before_joining():
    """``runtime.init`` takes the axes of ``MESH_AXES`` by the shape's
    number of dims; a 4-part shape raises ValueError before the process
    group is joined."""
    with pytest.raises(ValueError, match=r"a mesh of shape \(1, 1, 2, 2\)"):
        R.init("localhost", R.free_port(), 4, 0, backend="gloo",
               device="cpu", shape=(1, 1, 2, 2))


@pytest.mark.parametrize("rows, seq", [(1, 4), (1, 12), (2, 6)],
                         ids=["short", "straddles", "uneven"])
def test_moe_groups_that_differ_from_the_global_batch_are_refused(rows,
                                                                  seq):
    """SMOKE deepseek groups 8 tokens. Over 2 data ranks a rank of 1 x 4
    tokens would group 4 (the global batch 8), one of 1 x 12 or 2 x 6
    would straddle groups of 8 across ranks: ``moe_check_batch`` raises
    ValueError naming the sizes, and so does ``Trainer.local_batch`` on
    such a global batch, before any collective, where 1 x 16 groups as
    one device does (one device groups 4 tokens as 4)."""
    from repro_torch.models import layers as L
    cfg = get_config("deepseek-moe-16b", smoke=True)
    L.moe_check_batch(1, 16, 2, cfg)
    assert L.moe_groups(1, 16, cfg) == (8, 2, 3)
    with pytest.raises(ValueError, match=f"holds {rows} x {seq} = "
                       f"{rows * seq} tokens of a {2 * rows} x {seq}"):
        L.moe_check_batch(rows, seq, 2 * rows, cfg)
    model = build_model(cfg)
    tr = Trainer(model, W.trainer_config(), W.batch_fn("deepseek-moe-16b"),
                 shardings=state_shardings(
                     model, _mesh((2, 2), ("data", "model"))))
    tokens = torch.zeros((2 * rows, seq), dtype=torch.int32)
    with pytest.raises(ValueError, match="grouped in 8 tokens"):
        tr.local_batch({"tokens": tokens, "targets": tokens})
    assert L.moe_groups(1, 4, cfg)[:2] == (4, 1)     # one device: its own


def test_moe_fallback_layout_is_refused():
    """6 experts over a model axis of 4: the specs put each expert's mlp
    dim on 'model' (the fallback layout), which sharded training refuses
    by name, in the Trainer and in ``moe_apply`` on its blocks."""
    import dataclasses
    from repro_torch.distributed import sharding as SH
    from repro_torch.models import layers as L
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              num_experts=6)
    model = build_model(cfg)
    pm = _mesh((1, 4), ("data", "model"))
    specs = SH.param_pspecs(model.defs(), pm)["layers"]["moe"]
    assert tuple(specs["we_up"]) == (None, None, "data", "model")
    assert tuple(specs["router"]) == (None, "data", None)
    with pytest.raises(NotImplementedError, match="6 experts over a model "
                       "axis of 4: the fallback layout"):
        Trainer(model, W.trainer_config(), W.batch_fn("deepseek-moe-16b"),
                shardings=state_shardings(model, pm))
    p = L.layer_params(SH.local_block(
        model.init(torch.Generator().manual_seed(0), device="cpu")["layers"],
        SH.param_pspecs(model.defs(), pm)["layers"], pm), 0)["moe"]
    with pm, pytest.raises(NotImplementedError,
                           match="the fallback layout"):
        L.moe_apply(p, torch.zeros((1, 16, cfg.d_model)), cfg)


def test_zamba2_heads_that_a_model_axis_would_split_are_refused():
    """6 SSD heads over a model axis of 4 would split a head: the Trainer
    and the launcher refuse it by name; over a model axis of 2 the same
    config is taken."""
    import dataclasses
    cfg = dataclasses.replace(get_config("zamba2-1.2b", smoke=True),
                              ssm_head_dim=32, ssm_expand=3)
    assert cfg.ssm_heads == 6
    model = build_model(cfg)
    with pytest.raises(NotImplementedError, match="6 SSD heads over a "
                       "model axis of 4 would split a head"):
        Trainer(model, W.trainer_config(), W.batch_fn("zamba2-1.2b"),
                shardings=state_shardings(model, _mesh((1, 4),
                                                       ("data", "model"))))
    Trainer(model, W.trainer_config(), W.batch_fn("zamba2-1.2b"),
            shardings=state_shardings(model, _mesh((2, 2),
                                                   ("data", "model"))))
    from repro_torch.launch import train as cli
    with pytest.raises(NotImplementedError, match="would split a head"):
        cli._mesh_shape("1x4", cfg)
