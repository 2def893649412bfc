"""The port's LM training entry points against the JAX package:
``launch.steps.make_train_step``, ``training.Trainer`` (histories,
crash-restart, stragglers, compression), the abstract specs of every
(arch x shape) cell and the ``launch.train`` CLI.

The JAX package's parameters and states cross as numpy arrays. Tolerances
(f32): one train step's metrics rtol 1e-5; the first moment (1 - b1) g
the gradients' tolerance of ``tests/test_torch_lm_training.py`` scaled
by (1 - b1), rtol 1e-4 / atol 1e-6, the second (1 - b2) g^2 rtol 2e-4 /
atol 1e-10; and params
rtol 1e-4 with atol 1e-3 * lr where |g| > 1e-6 (a first AdamW update is
lr * g / (|g| + eps), so an element moves by lr times its gradient's
relative error); where |g| <= 1e-6 the gradient is rounding noise and its
update only is bounded, by lr * (1 + weight_decay * |p|); ten ``Trainer``
steps' losses rtol 1e-4 (the params themselves drift apart where a
gradient's sign is a rounding away from zero, so the loss is what is
compared); crash-restart and remat within the port bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import shapes as jax_shapes  # noqa: E402
from repro.data import TokenTaskConfig as JTokenTaskConfig  # noqa: E402
from repro.data import token_batch as jax_token_batch  # noqa: E402
from repro.launch import steps as JS  # noqa: E402
from repro.models import ModelConfig as JaxModelConfig  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import TrainerConfig as JTrainerConfig  # noqa: E402
from repro_torch.configs import ARCHS, get_config, shapes  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.data import TokenTaskConfig, token_batch  # noqa: E402
from repro_torch.launch import steps as S  # noqa: E402
from repro_torch.launch import train as train_cli  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.training import (AdamWConfig, Trainer,  # noqa: E402
                                  TrainerConfig)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

from test_torch_rwkv6 import np_lm_params  # noqa: E402
from test_torch_transformer import np_params  # noqa: E402

STEP_LR = 1e-2
STEP_TOL = dict(rtol=1e-4, atol=1e-3 * STEP_LR)
HISTORY_TOL = dict(rtol=1e-4, atol=0)


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are SMOKE-sized: one intra-op thread runs them
    fastest, and parallel test workers then do not contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaves_np(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _close_trees(got, want, **tol):
    g, w = tree_leaves(got), _leaves_np(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.detach().float().numpy(),
                                   b.astype(np.float32), **tol)


# ----------------------------------------------------------------------
# make_train_step
# ----------------------------------------------------------------------


def test_public_names_match_jax():
    assert S.__all__ == JS.__all__
    assert all(hasattr(S, n) for n in S.__all__)


@pytest.mark.parametrize("arch,remat", [("llama3.2-1b", True),
                                        ("rwkv6-7b", False)])
def test_make_train_step_matches_jax(arch, remat):
    """One step from the same params and AdamW state: the new params, the
    moments and every metric."""
    jcfg, cfg = jax_get_config(arch, smoke=True), get_config(arch, smoke=True)
    p = (np_lm_params(jcfg) if arch == "rwkv6-7b" else np_params(arch))
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    targets = np.where(rng.random((2, 32)) < 0.25, -1, tokens).astype(
        np.int32)
    ocfg = dict(lr=STEP_LR, warmup_steps=1, total_steps=10)
    jstep = jax.jit(JS.make_train_step(jcfg, JAdamWConfig(**ocfg),
                                       remat=remat))
    jp = jax.tree.map(jnp.asarray, p)
    from repro.training.optimizer import adamw_init as jax_adamw_init
    wp, wo, wm = jstep(jp, jax_adamw_init(jp),
                       {"tokens": jnp.asarray(tokens),
                        "targets": jnp.asarray(targets)})
    tstep = S.make_train_step(cfg, AdamWConfig(**ocfg), remat=remat)
    tp = lm_params_from_numpy(p)
    from repro_torch.training import adamw_init
    gp, go, gm = tstep(tp, adamw_init(tp),
                       {"tokens": torch.from_numpy(tokens),
                        "targets": torch.from_numpy(targets)})
    assert sorted(gm) == sorted(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), rtol=1e-5)
    for a, b, m in zip(tree_leaves(gp), _leaves_np(wp), _leaves_np(wo["m"])):
        a = a.numpy()
        sure = np.abs(m) > (1 - 0.9) * 1e-6      # m = (1 - b1) g
        np.testing.assert_allclose(a[sure], b[sure], **STEP_TOL)
        assert np.all(np.abs(a - b) <= 2 * STEP_LR * (1 + 0.1 * np.abs(b)))
    _close_trees(go["m"], wo["m"], rtol=1e-4, atol=1e-6)
    _close_trees(go["v"], wo["v"], rtol=2e-4, atol=1e-10)
    assert int(go["step"]) == int(wo["step"]) == 1
    # the params passed in are left as they were
    for a, b in zip(tree_leaves(tp), tree_leaves(lm_params_from_numpy(p))):
        assert torch.equal(a, b)


# ----------------------------------------------------------------------
# Trainer
# ----------------------------------------------------------------------

_TINY = dict(name="t", family="dense", num_layers=2, d_model=64,
             vocab_size=64, d_ff=128, num_heads=4, num_kv_heads=2,
             dtype="float32")


def _tk(cls):
    return cls(vocab_size=64, seq_len=16, batch_size=16, task="repeat")


def _trainer(tmpdir, total=30, ckpt_every=10, **kw):
    tk = _tk(TokenTaskConfig)
    tc = TrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                       ckpt_dir=str(tmpdir), log_every=1000,
                       opt=AdamWConfig(lr=5e-3, warmup_steps=5,
                                       total_steps=total), **kw)
    return Trainer(build_model(ModelConfig(**_TINY)), tc,
                   lambda s: token_batch(tk, s, device="cpu"), device="cpu")


def _jax_trainer(tmpdir, total=30, ckpt_every=10, **kw):
    tk = _tk(JTokenTaskConfig)
    tc = JTrainerConfig(total_steps=total, ckpt_every=ckpt_every,
                        ckpt_dir=str(tmpdir), log_every=1000,
                        opt=JAdamWConfig(lr=5e-3, warmup_steps=5,
                                         total_steps=total), **kw)
    return JTrainer(jax_build_model(JaxModelConfig(**_TINY)), tc,
                    lambda s: jax_token_batch(tk, s))


@pytest.mark.parametrize("compression", [None, 0.25])
def test_trainer_history_matches_jax_from_the_same_state(tmp_path,
                                                         compression):
    """Ten steps of the tiny dense model of ``tests/test_training.py``
    from the JAX trainer's initial state (carried across as numpy): the
    loss histories agree."""
    jt = _jax_trainer(tmp_path / "jax", total=10,
                      grad_compression_ratio=compression)
    state0 = jt.init_state(jax.random.PRNGKey(0))
    jres = jt.run(None, start_state=state0)
    tt = _trainer(tmp_path / "port", total=10,
                  grad_compression_ratio=compression)
    tres = tt.run(start_state=jax.tree.map(np.asarray, state0))
    want = [h["loss"] for h in jres["history"]]
    got = [h["loss"] for h in tres["history"]]
    np.testing.assert_allclose(got, want, **HISTORY_TOL)
    assert tres["final_step"] == jres["final_step"] == 10


def test_loss_decreases_with_and_without_compression(tmp_path):
    for ratio, bound in ((None, 0.5), (0.25, 0.7)):
        tr = _trainer(tmp_path / str(ratio), total=40,
                      grad_compression_ratio=ratio)
        losses = [h["loss"]
                  for h in tr.run(torch.Generator().manual_seed(0))
                  ["history"]]
        assert losses[-1] < losses[0] * bound, losses[::10]


def test_crash_restart_is_bit_identical(tmp_path, capsys):
    """A simulated node failure + restore reproduces the uninterrupted
    run bit for bit: every loss and the final params and moments."""
    crashed = {"done": False}

    def hook(step):
        if step == 15 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("simulated node failure")

    g = torch.Generator().manual_seed(3)
    res1 = _trainer(tmp_path / "a", total=25, ckpt_every=5) \
        .run_with_restarts(g, failure_hook=hook)
    res2 = _trainer(tmp_path / "b", total=25, ckpt_every=5).run(g)
    assert "[trainer] restart #1 from step 15 after: simulated node " \
        "failure" in capsys.readouterr().out
    assert [h["loss"] for h in res1["history"]] == \
        [h["loss"] for h in res2["history"]][15:]
    for a, b in zip(tree_leaves(res1["state"]), tree_leaves(res2["state"])):
        assert torch.equal(a, b)


def test_restart_without_a_checkpoint_starts_over_from_the_same_init(
        tmp_path):
    """``init_state`` reads the generator and does not advance it, so a
    restart before the first checkpoint redraws the same params."""
    tr = _trainer(tmp_path, total=3, ckpt_every=10)
    g = torch.Generator().manual_seed(1)
    a, b = tr.init_state(g), tr.init_state(g)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
    fails = iter([True, False, False, False])
    res = tr.run_with_restarts(
        g, failure_hook=lambda s: (_ for _ in ()).throw(
            RuntimeError("boom")) if s == 1 and next(fails) else None)
    ref = _trainer(tmp_path / "ref", total=3, ckpt_every=10).run(g)
    assert [h["loss"] for h in res["history"]] == \
        [h["loss"] for h in ref["history"]]


def test_checkpoint_extras_and_keep_last(tmp_path):
    """The extras carry the data cursor and the trainer's own straggler
    count, whatever the wall clock made of the steps
    (``test_straggler_detection`` holds the counting rule)."""
    from repro_torch.training import checkpoint as CKPT
    tr = _trainer(tmp_path, total=8, ckpt_every=2, keep_last=2)
    tr.run(torch.Generator().manual_seed(0))
    assert CKPT.list_steps(tmp_path) == [6, 8]
    _, _, extra = CKPT.restore_latest(tmp_path, tr.init_state())
    assert extra == {"data_cursor": 8,
                     "straggler_steps": tr.straggler_steps}


def test_straggler_detection(tmp_path):
    tr = _trainer(tmp_path, total=1)
    for _ in range(20):
        tr._track_stragglers(0.01)
    tr._track_stragglers(0.5)   # 50x median
    assert tr.straggler_steps == 1
    assert len(tr.step_times) == 21


def test_shardings_are_refused(tmp_path):
    """Shardings must bind specs to a process mesh (one process a rank,
    ``distributed.runtime``): none at all, or a plain ``Mesh``, is
    refused; sharded training itself is ``tests/test_torch_dist_*.py``."""
    from repro_torch.distributed import make_mesh, shardings
    model = build_model(ModelConfig(**_TINY))
    with pytest.raises(ValueError, match="no NamedSharding"):
        Trainer(model, TrainerConfig(), lambda s: None, shardings=object(),
                device="cpu")
    mesh = make_mesh((1, 1), ("data", "model"),
                     devices=[torch.device("cpu")])
    with pytest.raises(TypeError, match="ProcessMesh"):
        Trainer(model, TrainerConfig(), lambda s: None,
                shardings=shardings(mesh, {"params": ()}), device="cpu")


def test_trainer_config_fields_equal_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)
                if f.name != "opt"]
    assert fields(TrainerConfig) == fields(JTrainerConfig)
    assert dataclasses.asdict(AdamWConfig()) == dataclasses.asdict(
        JAdamWConfig())


# ----------------------------------------------------------------------
# Abstract specs
# ----------------------------------------------------------------------


def _shape_dtypes(tree):
    if isinstance(tree, dict):
        return {k: _shape_dtypes(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        assert tree.device.type == "meta"
        return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))
    return (tuple(tree.shape), str(tree.dtype))


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_specs_match_jax_for_every_cell(arch):
    """``input_specs`` and ``abstract_cache`` for each of the arch's cells
    of ``configs/shapes.py``, and ``abstract_opt_state``: the JAX
    package's shapes and dtypes, as meta tensors (no storage)."""
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    cells = shapes.cells_for(cfg)
    assert [c.name for c in cells] == \
        [c.name for c in jax_shapes.cells_for(jcfg)]
    for cell in cells:
        jcell = jax_shapes.SHAPES[cell.name]
        assert _shape_dtypes(S.input_specs(cfg, cell)) == \
            _shape_dtypes(JS.input_specs(jcfg, jcell))
        if cell.kind == "decode":
            assert _shape_dtypes(S.abstract_cache(cfg, cell)) == \
                _shape_dtypes(JS.abstract_cache(jcfg, jcell))
    assert _shape_dtypes(S.abstract_opt_state(cfg)) == \
        _shape_dtypes(JS.abstract_opt_state(jcfg))


# ----------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------


def test_cli_trains_llama_smoke_on_the_cpu(tmp_path, capsys):
    res = train_cli.main(["--arch", "llama3.2-1b", "--smoke", "--steps",
                          "4", "--device", "cpu", "--ckpt-dir",
                          str(tmp_path)])
    out = capsys.readouterr().out
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 4 and losses[-1] < losses[0]
    assert "done: loss" in out and "over 4 steps" in out


def test_cli_trains_rwkv6_smoke_on_the_cpu(tmp_path, capsys):
    res = train_cli.main(["--arch", "rwkv6-7b", "--smoke", "--steps", "4",
                          "--device", "cpu", "--ckpt-dir", str(tmp_path),
                          "--remat", "--grad-compression", "0.1"])
    losses = [h["loss"] for h in res["history"]]
    assert len(losses) == 4 and np.isfinite(losses).all()
    assert "over 4 steps" in capsys.readouterr().out


def test_cli_refuses_a_mesh():
    """``--mesh`` trains over (data, model) and (pod, data, model) meshes
    (``tests/test_torch_dist_checkpoint.py``); a mesh of one part raises
    ``ValueError``, as the JAX package's launcher does (its ``make_mesh``
    pairs the shape with three axes), and a mesh without ``--spawn``
    needs the rank and port of this process."""
    with pytest.raises(ValueError, match="--mesh 4: DxM"):
        train_cli.main(["--smoke", "--device", "cpu", "--mesh", "4"])
    with pytest.raises(ValueError, match="--rank and --port"):
        train_cli.main(["--smoke", "--device", "cpu", "--mesh", "2x4"])
