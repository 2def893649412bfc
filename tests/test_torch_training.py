"""STBP training of the SCNN in the port, against the JAX package, on the CPU.

The same inputs (numpy seeds; JAX ``init_snn`` weights carried across by
``convert.snn_params_from_numpy``) go through ``repro.core.snn`` /
``repro.training`` / ``repro.data`` and their counterparts in
``repro_torch``. Tolerances:

  * weights on a 2**-8 grid make every conv and fc current exact in f32,
    so logits, accuracy and spikes are bit for bit; the loss is the one
    number that is not: its log-softmax runs in float64 in the port (so
    the card and the CPU agree) and in float32 in XLA, whose ``exp`` and
    ``log`` differ from the correctly rounded ones in the last bit
    (``LOSS_ATOL``, 4 ulps of a loss of ~2-8);
  * gradients run the same formulas with sums in other orders
    (``GRAD_RTOL`` of each gradient's largest magnitude);
  * the optimizer's elementwise arithmetic is the same; ``pow``, ``cos``
    and the global norm's sums are the library's (``OPT_RTOL``);
  * three training steps: after the first update the weights leave the
    grid, currents differ by ulps and a spike with a membrane within
    ulps of v_th may flip, which AdamW turns into at most ~lr a step
    (``TRAIN_ATOL``).
"""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import snn as jsnn  # noqa: E402
from repro.core import tcn as jtcn  # noqa: E402
from repro.core import ternary as jter  # noqa: E402
from repro.data import synthetic as jdata  # noqa: E402
from repro.training import checkpoint as JCKPT  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402

import repro_torch.data as tdata_pkg  # noqa: E402
from repro_torch.configs import CONFIG, TCN_CONFIG  # noqa: E402
from repro_torch.convert import snn_params_from_numpy  # noqa: E402
from repro_torch.core import lif as tlif  # noqa: E402
from repro_torch.core import snn as tsnn  # noqa: E402
from repro_torch.core import tcn as ttcn  # noqa: E402
from repro_torch.core import ternary as tter  # noqa: E402
from repro_torch.data import synthetic as tdata  # noqa: E402
from repro_torch.kernels import fc_lif_scan as k2  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
import repro_torch.training as ttrain  # noqa: E402
from repro_torch.training import checkpoint as TCKPT  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402

JCFG = jsnn.SNNConfig(height=32, width=32, time_bins=8, conv1_features=4,
                      conv2_features=8, hidden=32, num_classes=11)
TCFG = tsnn.SNNConfig(height=32, width=32, time_bins=8, conv1_features=4,
                      conv2_features=8, hidden=32, num_classes=11)
DATA = dict(height=32, width=32, time_bins=8, mean_events=1500,
            num_classes=11)
MODES = ["time_serial", "layer_serial"]

LOSS_ATOL = 4 * 2.0 ** -21       # 4 ulps of a loss in [2, 8)
GRAD_RTOL = 1e-5
OPT_RTOL = 1e-6
TRAIN_ATOL = 1e-5
OCFG = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=1e-4)


def _dyadic(tree):
    return {k: {"w": (np.round(v["w"] * 256.0) / 256.0).astype(np.float32)}
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def np_params():
    tree = jsnn.init_snn(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def batch():
    """One batch of 4 windows, the JAX pipeline's, as numpy."""
    b = jdata.dvs_gesture_batch(4, 3, **DATA)
    return np.asarray(b.vox), np.asarray(b.labels)


def _jax_loss_and_grads(tree, vox, labels, mode):
    fn = jax.value_and_grad(
        lambda p: jsnn.snn_loss(p, jnp.asarray(vox), jnp.asarray(labels),
                                JCFG, mode=mode), has_aux=True)
    (loss, aux), g = fn(jax.tree_util.tree_map(jnp.asarray, tree))
    return loss, aux, snn_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, g))


def _port_loss_and_grads(params, vox, labels, mode):
    return ttrain.snn_grads(params, torch.tensor(vox), torch.tensor(labels),
                            TCFG, mode=mode)


def _close_to_max(got, want, rtol):
    """|got - want| within ``rtol`` of ``want``'s largest magnitude."""
    want = np.asarray(want)
    err = float(np.abs(got.detach().numpy() - want).max())
    assert err <= rtol * float(np.abs(want).max()), (err, rtol)
    return err


# ----------------------------------------------------------------------
# The loss and its gradients.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_snn_loss_matches_jax(np_params, batch, mode):
    tree = _dyadic(np_params)
    vox, labels = batch
    jl, jaux = jsnn.snn_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                             jnp.asarray(vox), jnp.asarray(labels), JCFG,
                             mode=mode)
    tl, taux = tsnn.snn_loss(snn_params_from_numpy(tree),
                             torch.tensor(vox),
                             torch.tensor(labels).long(), TCFG,
                             mode=mode)
    np.testing.assert_array_equal(taux["logits"].numpy(),
                                  np.asarray(jaux["logits"]))
    assert float(taux["accuracy"]) == float(jaux["accuracy"])
    assert tl.dtype == torch.float32 and tl.shape == ()
    assert abs(float(tl) - float(jl)) <= LOSS_ATOL, (float(tl), float(jl))
    for k, v in jaux["firing_rates"].items():
        assert float(taux["firing_rates"][k]) == pytest.approx(
            float(v), rel=1e-6)


@pytest.mark.parametrize("mode", MODES)
def test_snn_grads_match_jax_and_reach_every_layer(np_params, batch, mode):
    tree = _dyadic(np_params)
    vox, labels = batch
    _, _, jg = _jax_loss_and_grads(tree, vox, labels, mode)
    _, _, tg = _port_loss_and_grads(snn_params_from_numpy(tree), vox,
                                    labels.astype(np.int64), mode)
    for k in tsnn.SNN_STATE_LAYERS:
        assert bool(torch.isfinite(tg[k]["w"]).all())
        assert float(tg[k]["w"].abs().max()) > 0, f"no gradient reaches {k}"
        _close_to_max(tg[k]["w"], jg[k]["w"].numpy(), GRAD_RTOL)


def test_modes_agree_on_loss_and_gradients(np_params, batch):
    params = snn_params_from_numpy(np_params)       # He init, f32
    vox, labels = batch
    ts = _port_loss_and_grads(params, vox, labels.astype(np.int64),
                              "time_serial")
    ls = _port_loss_and_grads(params, vox, labels.astype(np.int64),
                              "layer_serial")
    assert torch.equal(ts[0], ls[0])
    assert torch.equal(ts[1]["logits"], ls[1]["logits"])
    for k in tsnn.SNN_STATE_LAYERS:
        _close_to_max(ls[2][k]["w"], ts[2][k]["w"].numpy(), GRAD_RTOL)


# ----------------------------------------------------------------------
# The differentiable fc currents and K2's backward.
# ----------------------------------------------------------------------

def test_fc_currents_grad_matches_jax_vjp():
    rng = np.random.default_rng(5)
    s = (rng.binomial(4, 0.2, size=(3, 5, 64)) / 4.0).astype(np.float32)
    w = (rng.normal(size=(64, 24)) * 0.3).astype(np.float32)
    g = rng.normal(size=(3, 5, 24)).astype(np.float32)
    want, vjp = jax.vjp(lambda a, b: a @ b, jnp.asarray(s), jnp.asarray(w))
    js, jw = vjp(jnp.asarray(g))
    ts, tw = (torch.from_numpy(a).requires_grad_() for a in (s, w))
    before = (k2.launches, k2.currents_launches)
    out = ops.fc_currents(ts, tw)
    assert torch.equal(out.detach(), k2.fc_currents_plain(ts.detach(),
                                                          tw.detach()))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(ts.grad.numpy(), np.asarray(js), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-6)
    assert (k2.launches, k2.currents_launches) == before
    with torch.no_grad():                     # no node: the plain forward
        assert ops.fc_currents(ts, tw).grad_fn is None


def test_fc_lif_scan_backward_recomputes_the_forward_trajectory(
        monkeypatch):
    """With He-init weights the recomputed membrane in K2's backward is
    the forward's bit for bit: its currents are summed in the same
    ascending-k order (a library matmul would sum them in another)."""
    rng = np.random.default_rng(11)
    t, b, k, n = 8, 3, 256, 40
    s = torch.from_numpy((rng.binomial(4, 0.3, size=(t, b, k)) / 4.0)
                         .astype(np.float32)).requires_grad_()
    w = torch.from_numpy((rng.normal(size=(k, n)) * 2.0 * np.sqrt(2.0 / k))
                         .astype(np.float32)).requires_grad_()
    v0 = torch.from_numpy(rng.uniform(0, 1, size=(b, n)).astype(np.float32)
                          ).requires_grad_()
    p = tlif.LIFParams()
    seen = []
    real = ops.lif_scan_reference

    def spy(cur, p_, v):
        out = real(cur, p_, v)
        seen.append((cur.detach().clone(), out[0].detach().clone(),
                     out[1].detach().clone()))
        return out

    monkeypatch.setattr(ops, "lif_scan_reference", spy)
    out, v_fin = ops.fc_lif_scan(s, w, p, v0)
    (out.sum() + v_fin.sum()).backward()
    assert len(seen) == 1
    cur, r_out, r_vfin = seen[0]
    assert torch.equal(r_out, out.detach())
    assert torch.equal(r_vfin, v_fin.detach())
    # The library product's currents are not the forward's bits here.
    assert not torch.equal(torch.matmul(s.detach(), w.detach()), cur)
    assert all(torch.isfinite(x.grad).all() for x in (s, w, v0))


# ----------------------------------------------------------------------
# init_snn, init_tcn, ternary_ste.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("which", ["snn", "tcn"])
def test_init_shapes_layouts_and_scale(which):
    if which == "snn":
        cfg, init = CONFIG, tsnn.init_snn
        jtree = jsnn.init_snn(jax.random.PRNGKey(0), jsnn.SNNConfig())
    else:
        cfg, init = TCN_CONFIG, ttcn.init_tcn
        jtree = jtcn.init_tcn(jax.random.PRNGKey(0), jtcn.TCNConfig())
    params = init(7, cfg, device="cpu")
    again = init(torch.Generator().manual_seed(7), cfg, device="cpu")
    other = init(8, cfg, device="cpu")
    fan_in = {"conv1": 9 * cfg.in_channels, "conv2": 9 * cfg.conv1_features,
              "fc1": cfg.flat_dim, "fc2": cfg.hidden}
    for name, layer in params.items():
        w = layer["w"]
        jw = np.asarray(jtree[name]["w"])
        want_shape = (jw.transpose(3, 2, 0, 1).shape if w.ndim == 4
                      else jw.shape)            # HWIO -> OIHW
        assert tuple(w.shape) == want_shape and w.dtype == torch.float32
        assert torch.equal(w, again[name]["w"])
        assert not torch.equal(w, other[name]["w"])
        sd = cfg.init_gain * np.sqrt(2.0 / fan_in[name])
        n = w.numel()
        # The sample std is within 6 standard errors (sd / sqrt(2n)).
        assert abs(float(w.std()) - sd) <= 6 * sd / np.sqrt(2 * n)
        assert abs(float(w.mean())) <= 6 * sd / np.sqrt(n)


def test_ternary_ste_matches_jax():
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 48)).astype(np.float32)
    g = rng.normal(size=(64, 48)).astype(np.float32)
    jw, vjp = jax.vjp(jter.ternary_ste, jnp.asarray(w))
    (jg,) = vjp(jnp.asarray(g))
    tw = torch.from_numpy(w).requires_grad_()
    out = tter.ternary_ste(tw)
    q, scale = tter.ternarize(tw.detach())
    assert torch.equal(out.detach(), q.float() * scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jw),
                               rtol=1e-6)
    out.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(tw.grad.numpy(), np.asarray(jg))


# ----------------------------------------------------------------------
# The optimizer.
# ----------------------------------------------------------------------

def test_cosine_schedule_matches_jax():
    cfg = jopt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    tcfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_ratio=0.1)
    for s in (0, 1, 5, 10, 11, 37, 55, 99, 100, 150):
        want = float(jopt.cosine_schedule(cfg, jnp.asarray(s, jnp.int32)))
        got = topt.cosine_schedule(tcfg, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert float(got) == pytest.approx(want, rel=OPT_RTOL, abs=1e-7)


def test_clip_by_global_norm_matches_jax(np_params):
    tree = {k: {"w": v["w"] * 3.0} for k, v in np_params.items()}
    for max_norm in (1.0, 1e6):
        jt, jn = jopt.clip_by_global_norm(
            jax.tree_util.tree_map(jnp.asarray, tree), max_norm)
        tt, tn = topt.clip_by_global_norm(snn_params_from_numpy(tree),
                                          max_norm)
        assert float(tn) == pytest.approx(float(jn), rel=OPT_RTOL)
        want = snn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jt))
        for k in tt:
            np.testing.assert_allclose(tt[k]["w"].numpy(),
                                       want[k]["w"].numpy(), rtol=OPT_RTOL,
                                       atol=1e-9)


def test_adamw_three_steps_match_jax(np_params):
    rng = np.random.default_rng(9)
    jcfg, tcfg = jopt.AdamWConfig(**OCFG), topt.AdamWConfig(**OCFG)
    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jstate = jopt.adamw_init(jp)
    tp = snn_params_from_numpy(np_params)
    tstate = topt.adamw_init(tp)
    assert tstate["step"].dtype == torch.int32
    for _ in range(3):
        g = {k: {"w": rng.normal(size=v["w"].shape).astype(np.float32)}
             for k, v in np_params.items()}
        jp, jstate, jm = jopt.adamw_update(
            jax.tree_util.tree_map(jnp.asarray, g), jstate, jp, jcfg)
        tp, tstate, tm = topt.adamw_update(snn_params_from_numpy(g), tstate,
                                           tp, tcfg)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]),
                                                rel=OPT_RTOL)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=OPT_RTOL)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
    as_port = lambda t: snn_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, t))
    for got, want in ((tp, as_port(jp)), (tstate["m"], as_port(jstate["m"])),
                      (tstate["v"], as_port(jstate["v"]))):
        for k in got:
            # Moments are sums of terms that cancel, so each leaf is held
            # to its largest magnitude, not elementwise.
            _close_to_max(got[k]["w"], want[k]["w"].numpy(), OPT_RTOL)


# ----------------------------------------------------------------------
# Checkpoints.
# ----------------------------------------------------------------------

def _tstate():
    g = torch.Generator().manual_seed(0)
    return {"a": {"w": torch.randn(3, 4, generator=g)},
            "b": torch.arange(5, dtype=torch.int32),
            "c": [torch.randn(2, generator=g),
                  torch.zeros((), dtype=torch.int32)]}


def _equal_trees(a, b):
    la, lb = topt.tree_leaves(a), topt.tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_checkpoint_round_trip(tmp_path):
    state = _tstate()
    path = TCKPT.save_checkpoint(tmp_path, 7, state, extra={"cursor": 7})
    assert path.name == "step_00000007"
    assert sorted(json.loads((path / "manifest.json").read_text())["keys"]) \
        == ["a/w", "b", "c/0", "c/1"]
    template = topt.tree_map(torch.zeros_like, state)
    restored, extra = TCKPT.restore_checkpoint(tmp_path, 7, template)
    assert _equal_trees(restored, state) and extra == {"cursor": 7}
    assert TCKPT.latest_step(tmp_path) == 7
    bad = dict(template, a={"w": torch.zeros(4, 3)})
    with pytest.raises(ValueError, match="shape"):
        TCKPT.restore_checkpoint(tmp_path, 7, bad)
    # bf16 leaves, once refused, are written as the JAX package writes
    # them and come back bit for bit.
    bf = {"x": torch.tensor([1.5, -0.0, 3.0e-39, 65504.0],
                            dtype=torch.bfloat16)}
    path = TCKPT.save_checkpoint(tmp_path, 8, bf)
    assert json.loads((path / "manifest.json").read_text())["dtypes"] \
        == {"x": "bfloat16"}
    got, _ = TCKPT.restore_checkpoint(tmp_path, 8,
                                      {"x": torch.zeros(4,
                                                        dtype=torch.bfloat16)})
    assert torch.equal(got["x"].view(torch.int16), bf["x"].view(torch.int16))


def test_checkpoint_keep_last_and_unpublished(tmp_path):
    state = {"x": torch.zeros(2)}
    for s in (10, 20, 30, 40):
        TCKPT.save_checkpoint(tmp_path, s, state, keep_last=2)
    assert TCKPT.list_steps(tmp_path) == [30, 40]
    # A write that died before its rename is never listed.
    (tmp_path / "step_00000050.tmp-123").mkdir()
    assert TCKPT.list_steps(tmp_path) == [30, 40]
    assert TCKPT.latest_step(tmp_path) == 40


def test_corrupt_checkpoint_falls_back(tmp_path):
    state = {"x": torch.arange(4.0)}
    TCKPT.save_checkpoint(tmp_path, 10, state, keep_last=5)
    TCKPT.save_checkpoint(tmp_path, 20, {"x": torch.arange(4.0) + 1},
                          keep_last=5)
    (tmp_path / "step_00000020" / "arrays.npz").write_bytes(b"garbage")
    out = TCKPT.restore_latest(tmp_path, state)
    assert out is not None and out[0] == 10
    assert torch.equal(out[1]["x"], torch.arange(4.0))
    with pytest.raises(Exception):
        TCKPT.restore_checkpoint(tmp_path, 20, state)


def test_restore_latest_raises_on_a_template_mismatch(tmp_path, np_params):
    """An intact checkpoint that does not fit the template is not passed
    over as corrupt: a JAX-written SCNN checkpoint (HWIO convolutions)
    restored into the port's OIHW params raises, as does a template leaf
    the checkpoint lacks, and the steps stay on disk."""
    jtree = jax.tree_util.tree_map(jnp.asarray, np_params)
    JCKPT.save_checkpoint(tmp_path, 5, {"params": jtree})
    with pytest.raises(ValueError, match="shape"):
        TCKPT.restore_latest(tmp_path, {"params": tsnn.init_snn(
            0, TCFG, device="cpu")})
    as_stored = topt.tree_map(lambda a: torch.from_numpy(np.array(a)),
                              np_params)
    with pytest.raises(KeyError, match="opt"):
        TCKPT.restore_latest(tmp_path, {"params": as_stored,
                                        "opt": topt.adamw_init(as_stored)})
    assert TCKPT.list_steps(tmp_path) == [5]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    tree = {"params": {"fc1": {"w": rng.normal(size=(6, 5)).astype(
        np.float32)}, "fc2": {"w": rng.normal(size=(5, 3)).astype(
            np.float32)}},
        "opt": {"step": np.asarray(12, np.int32),
                "m": [rng.normal(size=(4,)).astype(np.float32)]}}
    extra = {"cursor": 12, "note": "x"}
    ttree = topt.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    if writer == "jax":
        JCKPT.save_checkpoint(tmp_path, 12, jtree, extra=extra)
        step, got, ex = TCKPT.restore_latest(
            tmp_path, topt.tree_map(torch.zeros_like, ttree))
        assert _equal_trees(got, ttree)
    else:
        TCKPT.save_checkpoint(tmp_path, 12, ttree, extra=extra)
        step, got, ex = JCKPT.restore_latest(
            tmp_path, jax.tree_util.tree_map(jnp.zeros_like, jtree))
        for a, b in zip(jax.tree_util.tree_leaves(got),
                        jax.tree_util.tree_leaves(jtree)):
            assert np.asarray(a).dtype == np.asarray(b).dtype
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert step == 12 and ex == extra


# ----------------------------------------------------------------------
# Data.
# ----------------------------------------------------------------------

def test_data_exports_match_jax():
    import repro.data as jdata_pkg
    assert tdata.__all__ == jdata.__all__
    assert sorted(tdata_pkg.__all__) == sorted(
        n for n in dir(jdata_pkg) if n in jdata.__all__)
    assert tsnn.__all__ == jsnn.__all__
    assert topt.__all__ == jopt.__all__
    assert TCKPT.__all__ == JCKPT.__all__
    import repro_torch.training as ttrain
    assert set(jopt.__all__) | set(JCKPT.__all__) <= set(ttrain.__all__)
    assert "init_tcn" in ttcn.__all__ and "ternary_ste" in tter.__all__


@pytest.mark.parametrize("step", [0, 5])
def test_dvs_gesture_batch_matches_jax(step):
    want = jdata.dvs_gesture_batch(3, step, **DATA)
    got = tdata.dvs_gesture_batch(3, step, device="cpu", **DATA)
    assert got.vox.dtype == torch.float32 and got.labels.dtype == torch.int64
    np.testing.assert_array_equal(got.vox.numpy(), np.asarray(want.vox))
    np.testing.assert_array_equal(got.labels.numpy(), np.asarray(want.labels))
    np.testing.assert_array_equal(got.num_events, want.num_events)


@pytest.mark.parametrize("task", ["copy_map", "repeat"])
def test_token_batches_match_jax(task):
    jc = jdata.TokenTaskConfig(vocab_size=64, seq_len=16, batch_size=4,
                               task=task)
    tc = tdata.TokenTaskConfig(vocab_size=64, seq_len=16, batch_size=4,
                               task=task)
    want = jdata.token_stream(jc, 3)
    got = tdata.token_stream(tc, 3, device="cpu")
    for _ in range(3):
        (js, jb), (ts, tb) = next(want), next(got)
        assert js == ts
        for key in ("tokens", "targets"):
            assert tb[key].dtype == torch.int64
            np.testing.assert_array_equal(tb[key].numpy(),
                                          np.asarray(jb[key]))
    np.testing.assert_array_equal(
        tdata.token_batch(tc, 9, device="cpu")["tokens"].numpy(),
        np.asarray(jdata.token_batch(jc, 9)["tokens"]))


# ----------------------------------------------------------------------
# The slice as a whole: training steps.
# ----------------------------------------------------------------------

def _port_step(params, opt, vox, labels, ocfg, mode="time_serial"):
    params, opt, loss, _ = ttrain.stbp_step(params, opt, vox, labels, TCFG,
                                            ocfg, mode=mode)
    return params, opt, loss


def _batches(n):
    return [tdata.dvs_gesture_batch(4, s, device="cpu", **DATA)
            for s in range(n)]


def test_three_training_steps_match_jax(np_params):
    """3 AdamW steps from the same (converted) init on the same batches,
    the port against the JAX package, time_serial (the STBP default)."""
    jcfg, tcfg = jopt.AdamWConfig(**OCFG), topt.AdamWConfig(**OCFG)

    @jax.jit
    def jstep(p, opt, vox, labels):
        (loss, _), g = jax.value_and_grad(
            lambda q: jsnn.snn_loss(q, vox, labels, JCFG), has_aux=True)(p)
        p, opt, _ = jopt.adamw_update(g, opt, p, jcfg)
        return p, opt, loss

    jp = jax.tree_util.tree_map(jnp.asarray, np_params)
    jo = jopt.adamw_init(jp)
    tp = snn_params_from_numpy(np_params)
    to = topt.adamw_init(tp)
    for b in _batches(3):
        jp, jo, jl = jstep(jp, jo, jnp.asarray(b.vox.numpy()),
                           jnp.asarray(b.labels.numpy()))
        tp, to, tl = _port_step(tp, to, b.vox, b.labels, tcfg)
        assert abs(float(tl.detach()) - float(jl)) <= 1e-3 * abs(float(jl))
    want = snn_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp))
    for k in tp:
        moved = float((tp[k]["w"] - snn_params_from_numpy(np_params)[k]["w"])
                      .abs().max())
        assert moved > 10 * TRAIN_ATOL          # the steps did train
        np.testing.assert_allclose(tp[k]["w"].numpy(), want[k]["w"].numpy(),
                                   rtol=0, atol=TRAIN_ATOL)


def test_restart_from_checkpoint_is_bit_identical(tmp_path, np_params):
    """4 uninterrupted steps against 2 + save + restore into fresh
    tensors + 2, parameters and optimizer state bit for bit."""
    tcfg = topt.AdamWConfig(**OCFG)
    data = _batches(4)
    p0 = snn_params_from_numpy(np_params)

    def run(params, opt, steps):
        for s in steps:
            params, opt, _ = _port_step(params, opt, data[s].vox,
                                        data[s].labels, tcfg)
        return params, opt

    full = run(p0, topt.adamw_init(p0), range(4))
    half = run(p0, topt.adamw_init(p0), range(2))
    TCKPT.save_checkpoint(tmp_path, 2, {"params": half[0], "opt": half[1]})
    fresh = tsnn.init_snn(1, TCFG, device="cpu")
    step, state, _ = TCKPT.restore_latest(
        tmp_path, {"params": fresh, "opt": topt.adamw_init(fresh)})
    assert step == 2
    resumed = run(state["params"], state["opt"], range(2, 4))
    assert _equal_trees({"params": full[0], "opt": full[1]},
                        {"params": resumed[0], "opt": resumed[1]})
