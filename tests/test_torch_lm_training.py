"""LM training in the port against the JAX package: the loss, its
gradients, remat, the WKV gradient, gradient compression and bfloat16
checkpoints.

Parameters come from the JAX package's ``Model.init`` at SMOKE size (f32)
through ``convert.lm_params_from_numpy``, batches from numpy seeds.
Tolerances:

  * ``lm_loss``: rtol 1e-6 (one f32 log-softmax, sum orders differ);
  * ``Model.loss`` and every gradient leaf: rtol 1e-4, atol 1e-5 (whole
    f32 models forward and backward; the JAX package's own model tests
    hold 2e-4 on logits);
  * the WKV gradient: rtol 1e-4, atol 1e-5 against ``jax.grad`` of the
    JAX ``wkv6_chunked`` (the port's forward is K4's order, its gradient
    the chunked form's);
  * the chunked WKV's forward values: the JAX package's own WKV
    tolerance, rtol = atol = 2e-4 (as ``tests/test_torch_wkv6.py``);
  * exact: remat on/off, compression masks and residuals, checkpoint
    bytes.
"""
import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.model import lm_loss as jax_lm_loss  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked  # noqa: E402
from repro.training import checkpoint as JCKPT  # noqa: E402
from repro.training.compression import (  # noqa: E402
    compress_grads as jax_compress)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.training import checkpoint as CKPT  # noqa: E402
from repro_torch.training import compress_grads, compression_init  # noqa: E402
from repro_torch.training.optimizer import tree_leaves  # noqa: E402
from repro_torch.training.trainer import loss_and_grads  # noqa: E402

from test_torch_rwkv6 import np_lm_params  # noqa: E402
from test_torch_transformer import np_params  # noqa: E402
from test_torch_zamba2 import np_zamba  # noqa: E402

LOSS_TOL = dict(rtol=1e-6, atol=0)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
WKV_TOL = dict(rtol=2e-4, atol=2e-4)
# One arch per family; rwkv6's sequence is a multiple of its 16-step chunk.
FAMILY_ARCHS = ["llama3.2-1b", "deepseek-moe-16b", "qwen2-vl-2b",
                "rwkv6-7b", "zamba2-1.2b", "seamless-m4t-medium"]


@pytest.fixture(autouse=True)
def _one_thread():
    """The models here are SMOKE-sized: one intra-op thread runs them
    fastest, and parallel test workers then do not contend for cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_family_params(arch):
    if arch == "rwkv6-7b":
        return np_lm_params(jax_get_config(arch, smoke=True))
    if arch == "zamba2-1.2b":
        return np_zamba()
    return np_params(arch)


def _np_batch(cfg, b=2, s=32, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    targets = tokens.copy()
    targets[rng.random((b, s)) < 0.2] = -1
    batch = {"tokens": tokens, "targets": targets}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(b, 24, cfg.frontend_dim)).astype(
            np.float32)
    if cfg.family == "vlm":
        batch["patch_embeds"] = rng.normal(size=(b, 16, cfg.d_model)).astype(
            np.float32)
    return batch


def _tbatch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _flat_np(tree):
    """Leaves in the JAX package's flatten order (dict keys sorted)."""
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


# ----------------------------------------------------------------------
# lm_loss and Model.loss
# ----------------------------------------------------------------------


def test_public_names_match_jax():
    from repro.models import model as JM
    assert M.__all__ == JM.__all__
    assert all(hasattr(M, n) for n in M.__all__)


@pytest.mark.parametrize("with_aux", [False, True])
def test_lm_loss_matches_jax(with_aux):
    rng = np.random.default_rng(1)
    logits = (rng.normal(size=(3, 9, 50)) * 3).astype(np.float32)
    targets = rng.integers(0, 50, (3, 9)).astype(np.int32)
    targets[0, :4] = -1
    targets[2, -1] = -1
    aux = np.float32(0.37) if with_aux else None
    want, wm = jax_lm_loss(jnp.asarray(logits), jnp.asarray(targets),
                           None if aux is None else jnp.asarray(aux))
    got, gm = M.lm_loss(torch.from_numpy(logits), torch.from_numpy(targets),
                        None if aux is None else torch.tensor(aux))
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got), float(want), **LOSS_TOL)
    assert sorted(gm) == sorted(wm)
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **LOSS_TOL)


def test_lm_loss_of_all_pads_is_zero_over_one():
    logits = torch.zeros(1, 4, 8)
    loss, m = M.lm_loss(logits, torch.full((1, 4), -1))
    assert float(loss) == 0.0 and float(m["tokens"]) == 0.0


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_and_every_gradient_match_jax(arch):
    """``Model.loss`` and the gradient of every parameter leaf against
    ``jax.value_and_grad`` of the JAX ``Model.loss``, one arch per
    family (MoE aux loss included)."""
    cfg, jcfg = get_config(arch, smoke=True), jax_get_config(arch, smoke=True)
    p = _np_family_params(arch)
    batch = _np_batch(cfg)
    jmodel = jax_build_model(jcfg)
    (want, wm), wg = jax.jit(jax.value_and_grad(
        lambda q, b: jmodel.loss(q, b), has_aux=True))(
        jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, batch))
    got, gm, gg = loss_and_grads(build_model(cfg), lm_params_from_numpy(p),
                                 _tbatch(batch))
    np.testing.assert_allclose(float(got), float(want), **GRAD_TOL)
    assert sorted(gm) == sorted(wm) == ["aux", "ce", "tokens"]
    for k in wm:
        np.testing.assert_allclose(float(gm[k]), float(wm[k]), **GRAD_TOL)
    want_leaves = _flat_np(wg)
    got_leaves = tree_leaves(gg)
    assert len(got_leaves) == len(want_leaves)
    for g, w in zip(got_leaves, want_leaves):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_remat_is_bit_for_bit(arch):
    """``remat=True`` recomputes each layer in the backward: the loss and
    every gradient equal ``remat=False``'s bits."""
    cfg = get_config(arch, smoke=True)
    params = lm_params_from_numpy(_np_family_params(arch))
    model = build_model(cfg)
    batch = _tbatch(_np_batch(cfg, seed=3))
    plain = loss_and_grads(model, params, batch, remat=False)
    remat = loss_and_grads(model, params, batch, remat=True)
    assert torch.equal(plain[0], remat[0])
    for a, b in zip(tree_leaves(plain[2]), tree_leaves(remat[2])):
        assert torch.equal(a, b)


def test_rwkv6_loss_accepts_scan_layers():
    cfg = get_config("rwkv6-7b", smoke=True)
    params = lm_params_from_numpy(_np_family_params("rwkv6-7b"))
    batch = _tbatch(_np_batch(cfg))
    model = build_model(cfg)
    a = model.loss(params, batch, scan_layers=False)[0]
    assert torch.equal(a, model.loss(params, batch, scan_layers=True)[0])


# ----------------------------------------------------------------------
# The WKV gradient around K4
# ----------------------------------------------------------------------


def _wkv_inputs(b, t, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.maximum(-np.exp(rng.normal(size=(b, t, h, hd)) * 0.5),
                      -4.0).astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    g_o = rng.normal(size=(b, t, h, hd)).astype(np.float32)
    g_s = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return (r, k, v, logw, u, s0), (g_o, g_s)


@pytest.mark.parametrize("with_state", [False, True])
def test_wkv6_scan_gradients_match_jax_chunked(with_state):
    """``ops.wkv6_scan``'s gradients for r, k, v, logw, u (and state0)
    against ``jax.grad`` of the JAX package's ``wkv6_chunked``, for
    cotangents on both outputs."""
    (r, k, v, logw, u, s0), (g_o, g_s) = _wkv_inputs(2, 48, 3, 16)
    ins = [r, k, v, logw, u] + ([s0] if with_state else [])

    def jax_obj(*xs):
        o, s = jax_wkv6_chunked(*xs[:5], state0=xs[5] if with_state
                                else None)
        return jnp.sum(o * g_o) + jnp.sum(s * g_s)

    want = jax.grad(jax_obj, argnums=tuple(range(len(ins))))(
        *map(jnp.asarray, ins))
    live = [torch.from_numpy(x).requires_grad_() for x in ins]
    o, s = ops.wkv6_scan(*live[:5], live[5] if with_state else None)
    assert o.grad_fn is not None
    got = torch.autograd.grad(
        (o, s), live, (torch.from_numpy(g_o), torch.from_numpy(g_s)))
    for name, g, w in zip("r k v logw u state0".split(), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=name)


def test_wkv6_scan_forward_is_k4s_and_skips_autograd_without_grad():
    """Under autograd the forward values are K4's (its plain version on
    the CPU) bit for bit; without a gradient no autograd node is made."""
    from repro_torch.kernels.wkv6_scan import wkv6_scan_fwd
    (r, k, v, logw, u, s0), _ = _wkv_inputs(1, 32, 2, 16, seed=4)
    ts = [torch.from_numpy(x) for x in (r, k, v, logw, u, s0)]
    want = wkv6_scan_fwd(*ts)
    got = ops.wkv6_scan(ts[0].clone().requires_grad_(), *ts[1:])
    assert torch.equal(got[0].detach(), want[0])
    assert torch.equal(got[1].detach(), want[1])
    with torch.no_grad():
        o, _ = ops.wkv6_scan(ts[0].clone().requires_grad_(), *ts[1:])
    assert o.grad_fn is None


def test_wkv6_gradient_refuses_a_partial_chunk():
    (r, k, v, logw, u, _), _ = _wkv_inputs(1, 20, 1, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        ops.wkv6_scan(torch.from_numpy(r).requires_grad_(),
                      *map(torch.from_numpy, (k, v, logw, u)))


def test_wkv6_chunked_matches_jax_and_models_reexport():
    from repro_torch.kernels.wkv6_scan import wkv6_chunked
    from repro_torch.models import rwkv6
    assert rwkv6.wkv6_chunked is wkv6_chunked
    (r, k, v, logw, u, s0), _ = _wkv_inputs(2, 64, 2, 16, seed=5)
    o, s = wkv6_chunked(*map(torch.from_numpy, (r, k, v, logw, u)),
                        state0=torch.from_numpy(s0))
    o_j, s_j = jax_wkv6_chunked(*map(jnp.asarray, (r, k, v, logw, u)),
                                state0=jnp.asarray(s0))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **WKV_TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **WKV_TOL)


# ----------------------------------------------------------------------
# Gradient compression
# ----------------------------------------------------------------------


def _grad_tree(seed):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(40, 25)).astype(np.float32),
         "b": {"w": rng.normal(size=(333,)).astype(np.float32)}}
    # ties at the threshold: many equal magnitudes, both signs
    g["b"]["w"][:60] = np.where(np.arange(60) % 2, 0.5, -0.5)
    g["a"][0, :] = 0.0
    return g


@pytest.mark.parametrize("ratio", [0.05, 0.25, 0.001])
def test_compress_grads_matches_jax(ratio):
    """Three steps with error feedback: sent gradients (bit for bit,
    signed zeros included), residuals and the norm metric equal the JAX
    package's."""
    jerr = jax.tree.map(lambda a: jnp.zeros(a.shape, jnp.float32),
                        _grad_tree(0))
    terr = compression_init(lm_params_from_numpy(_grad_tree(0)))
    for step in range(3):
        g = _grad_tree(step)
        jsent, jerr, jm = jax_compress(jax.tree.map(jnp.asarray, g), jerr,
                                       ratio=ratio)
        tsent, terr, tm = compress_grads(lm_params_from_numpy(g), terr,
                                         ratio=ratio)
        for a, b in zip(tree_leaves(tsent), _flat_np(jsent)):
            assert a.numpy().tobytes() == b.tobytes()
        for a, b in zip(tree_leaves(terr), _flat_np(jerr)):
            assert a.numpy().tobytes() == b.tobytes()
        np.testing.assert_allclose(float(tm["compressed_grad_norm"]),
                                   float(jm["compressed_grad_norm"]),
                                   rtol=1e-6)


def test_compression_error_feedback_conserves_and_flushes():
    """The JAX package's property: sent + residual over N steps is N * g,
    and every coordinate is eventually sent."""
    rng = np.random.default_rng(0)
    vals = (0.5 + rng.random(64)) * np.sign(rng.normal(size=64))
    g = {"w": torch.tensor(vals, dtype=torch.float32)}
    err = compression_init(g)
    sent_total = torch.zeros(64)
    for _ in range(60):
        sent, err, _ = compress_grads(g, err, ratio=0.1)
        sent_total = sent_total + sent["w"]
    np.testing.assert_allclose((sent_total + err["w"]).numpy(),
                               60 * g["w"].numpy(), rtol=1e-4)
    ratio = (sent_total / (60 * g["w"])).numpy()
    assert (sent_total != 0).all()
    assert ratio.min() > 0.3 and ratio.max() < 1.05


def test_compression_sparsity_and_bf16_leaves():
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(1000,))
                         .astype(np.float32))
    sent, err, _ = compress_grads({"w": g}, compression_init({"w": g}),
                                  ratio=0.05)
    assert int((sent["w"] != 0).sum()) == 50          # no ties here
    gb = g.to(torch.bfloat16)
    sent, err, _ = compress_grads({"w": gb}, compression_init({"w": gb}),
                                  ratio=0.05)
    acc = gb.float()
    mask = sent["w"] != 0
    assert sent["w"].dtype == torch.bfloat16 and err["w"].dtype == \
        torch.float32
    assert torch.equal(sent["w"][mask], acc[mask].to(torch.bfloat16))
    assert torch.equal(err["w"][~mask], acc[~mask])
    assert bool((err["w"][mask] == 0).all())
    assert int(mask.sum()) >= 50


# ----------------------------------------------------------------------
# bfloat16 checkpoints across the packages
# ----------------------------------------------------------------------


def _bf16_states(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(37, 129)).astype(np.float32)
    b = rng.normal(size=(129,)).astype(np.float32)
    jstate = {"params": {"w": jnp.asarray(w).astype(jnp.bfloat16),
                         "b": jnp.asarray(b).astype(jnp.bfloat16)},
              "opt": {"m": jnp.asarray(w), "step": jnp.asarray(7, jnp.int32)}}
    tstate = {"params": {"w": torch.from_numpy(w).to(torch.bfloat16),
                         "b": torch.from_numpy(b).to(torch.bfloat16)},
              "opt": {"m": torch.from_numpy(w),
                      "step": torch.tensor(7, dtype=torch.int32)}}
    return jstate, tstate


def _members(path):
    with zipfile.ZipFile(path / "arrays.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


def test_bf16_checkpoint_files_equal_the_jax_packages(tmp_path):
    """The port writes a bf16 state as the JAX package does: the same npz
    members byte for byte (header descr ``<V2`` and the 16-bit patterns),
    the same manifest dtypes (``"bfloat16"``), shapes and fingerprints."""
    jstate, tstate = _bf16_states()
    jp = JCKPT.save_checkpoint(tmp_path / "jax", 3, jstate)
    tp = CKPT.save_checkpoint(tmp_path / "port", 3, tstate)
    assert _members(jp) == _members(tp)
    jm = json.loads((jp / "manifest.json").read_text())
    tm = json.loads((tp / "manifest.json").read_text())
    for key in ("keys", "shapes", "dtypes", "fingerprints"):
        assert jm[key] == tm[key], key
    assert tm["dtypes"]["params/w"] == "bfloat16"


def test_jax_reader_treats_a_port_bf16_checkpoint_as_its_own(tmp_path):
    """The JAX package reads the port's files as it reads its own: its
    numpy view of each leaf has the port's 16-bit patterns, and its
    ``restore_checkpoint`` answers both alike (it hashes a loaded ``V2``
    array under ``"|V2"``, not ``"bfloat16"``, and so refuses every bf16
    checkpoint, its own included; ROADMAP section 3)."""
    jstate, tstate = _bf16_states(1)
    jp = JCKPT.save_checkpoint(tmp_path / "jax", 5, jstate)
    tp = CKPT.save_checkpoint(tmp_path / "port", 5, tstate)
    with np.load(tp / "arrays.npz") as z:
        w = z["params/w"]
    assert w.dtype == np.dtype("V2")
    assert np.array_equal(w.view(jnp.bfloat16).view(np.uint16),
                          np.asarray(jstate["params"]["w"]).view(np.uint16))
    outcomes = []
    for root in (tmp_path / "jax", tmp_path / "port"):
        try:
            JCKPT.restore_checkpoint(root, 5, jstate)
            outcomes.append("read")
        except IOError as e:
            outcomes.append(type(e).__name__ + ": integrity")
    assert outcomes[0] == outcomes[1]
    assert JCKPT.restore_latest(tmp_path / "port", jstate) is \
        JCKPT.restore_latest(tmp_path / "jax", jstate)


def test_port_reads_a_jax_bf16_checkpoint_bit_for_bit(tmp_path):
    jstate, tstate = _bf16_states(2)
    JCKPT.save_checkpoint(tmp_path, 9, jstate, extra={"data_cursor": 9})
    template = {"params": {k: torch.zeros_like(v)
                           for k, v in tstate["params"].items()},
                "opt": {"m": torch.zeros(37, 129),
                        "step": torch.tensor(0, dtype=torch.int32)}}
    step, got, extra = CKPT.restore_latest(tmp_path, template)
    assert step == 9 and extra == {"data_cursor": 9}
    for k in ("w", "b"):
        assert got["params"][k].dtype == torch.bfloat16
        assert torch.equal(got["params"][k].view(torch.int16),
                           tstate["params"][k].view(torch.int16))
    assert torch.equal(got["opt"]["m"], tstate["opt"]["m"])
    assert int(got["opt"]["step"]) == 7


def test_bf16_checkpoint_falls_back_past_a_corrupt_step_and_keeps_last(
        tmp_path):
    _, tstate = _bf16_states(3)
    for s in (10, 20, 30, 40):
        CKPT.save_checkpoint(tmp_path, s, tstate, keep_last=3)
    assert CKPT.list_steps(tmp_path) == [20, 30, 40]
    (tmp_path / "step_00000040" / "arrays.npz").write_bytes(b"garbage")
    step, got, _ = CKPT.restore_latest(tmp_path, tstate)
    assert step == 30
    assert torch.equal(got["params"]["w"].view(torch.int16),
                       tstate["params"]["w"].view(torch.int16))
    # a flipped bit in a sampled bf16 element fails the fingerprint
    path = tmp_path / "step_00000030" / "arrays.npz"
    members = _members(tmp_path / "step_00000030")
    raw = bytearray(members["params/w.npy"])
    raw[128] ^= 0x01                       # the first element's low byte
    members["params/w.npy"] = bytes(raw)
    with zipfile.ZipFile(path, "w") as z:
        for n, data in members.items():
            z.writestr(n, data)
    assert CKPT.restore_latest(tmp_path, tstate)[0] == 20


# ----------------------------------------------------------------------
# The SSD scan's gradient where its masked exponents overflow
# ----------------------------------------------------------------------


def test_ssd_gradient_is_finite_where_masked_exponents_overflow():
    """Fast decays over a long chunk put exponents past f32's exp range
    above the diagonal of ``mamba2_chunked``'s intra-chunk matrix, whose
    exp overflows. The port masks the exponents, not the exps: the
    forward equals the JAX package's and the gradient is finite and
    equals the stepwise recurrence's, where a
    mask of the exps would give 0 * inf = NaN. The stepwise comparison
    holds the JAX package's chunked-vs-stepwise SSD tolerance
    (``tests/test_models.py``), rtol = atol = 1e-4."""
    from repro.models.zamba2 import mamba2_chunked as jax_mamba2_chunked
    from repro_torch.models.zamba2 import _mamba_step, mamba2_chunked
    rng = np.random.default_rng(11)
    b, s, h, p, n = 1, 64, 2, 4, 8
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    # a * dt of -1.2 .. -2.4 a step: over the 64-step chunk the exponents
    # above the diagonal reach 90 .. 150, past f32's exp range (88.7)
    dt = (1.0 + 0.5 * rng.random((b, s, h))).astype(np.float32)
    a = np.array([-1.6, -1.2], np.float32)
    b_in, c_in = (rng.normal(size=(b, s, n)).astype(np.float32)
                  for _ in range(2))
    ins = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a)]
    y, st = mamba2_chunked(*ins, torch.from_numpy(b_in),
                           torch.from_numpy(c_in), chunk=64)
    y_j, _ = jax_mamba2_chunked(*map(jnp.asarray, (x, dt, a, b_in, c_in)),
                                chunk=64)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               **GRAD_TOL)
    got = torch.autograd.grad(y.sum() + st.sum(), ins)
    live = [torch.from_numpy(v).requires_grad_() for v in (x, dt, a)]
    state = torch.zeros(b, h, p, n)
    total = 0.0
    for t in range(s):
        yt, state = _mamba_step(live[0][:, t], live[1][:, t], live[2],
                                torch.from_numpy(b_in[:, t]),
                                torch.from_numpy(c_in[:, t]), state)
        total = total + yt.sum()
    want = torch.autograd.grad(total + state.sum(), live)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
