"""The port's spiking CNN against the JAX package and against itself.

Against JAX: with dyadic weights (JAX ``init_snn`` rounded to multiples of
2**-8) every conv and fc current is exact in f32, so the whole layer-serial
network with the kernels' paths must equal JAX bit for bit. With He-init
weights the flipped-spike fraction is bounded. Inside the port the
contracts are bitwise: layer_serial (the kernels' path) == time_serial,
W chained windows == one scan, zero state == stateless.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import snn as jsnn  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.convert import snn_params_from_numpy  # noqa: E402
from repro_torch.core import snn as tsnn  # noqa: E402

JCFG = jsnn.SNNConfig(height=32, width=32, time_bins=8, conv1_features=4,
                      conv2_features=8, hidden=32, num_classes=11)
TCFG = tsnn.SNNConfig(height=32, width=32, time_bins=8, conv1_features=4,
                      conv2_features=8, hidden=32, num_classes=11)
# He-init weights: currents differ by f32 ulps between the packages, which
# flips a spike only when a membrane sits within ulps of v_th.
MAX_FLIP_FRACTION = 0.01


@pytest.fixture(scope="module")
def np_params():
    tree = jsnn.init_snn(jax.random.PRNGKey(0), JCFG)
    return jax.tree_util.tree_map(np.asarray, tree)


def _dyadic(tree):
    return {k: {"w": (np.round(v["w"] * 256.0) / 256.0).astype(np.float32)}
            for k, v in tree.items()}


def _vox(seed, b, t=8, p=0.06):
    return (np.random.default_rng(seed).random((b, t, 2, 32, 32))
            < p).astype(np.float32)


def _jax_run(tree, vox, state=None):
    return jsnn.snn_apply(jax.tree_util.tree_map(jnp.asarray, tree),
                          jnp.asarray(vox), JCFG, mode="layer_serial",
                          lif_scan_fn=jops.lif_scan, fuse_fc=True,
                          state=state)


def _port_run(tree, vox, state=None, mode="layer_serial"):
    return tsnn.snn_apply(snn_params_from_numpy(tree), torch.from_numpy(vox),
                          TCFG, mode=mode, state=state)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


def test_layer_serial_fused_dyadic_bitwise_vs_jax(np_params):
    tree = _dyadic(np_params)
    vox = _vox(1, 3)
    rng = np.random.default_rng(2)
    jstate = jsnn.snn_init_state(JCFG, 3)
    state_np = {k: rng.uniform(-0.3, 1.0, size=v.shape).astype(np.float32)
                for k, v in jstate.items()}
    want = _jax_run(tree, vox, {k: jnp.asarray(v)
                                for k, v in state_np.items()})
    got = _port_run(tree, vox, {k: torch.from_numpy(v)
                                for k, v in state_np.items()})
    _eq(want["out_spikes"], got["out_spikes"])
    for k in tsnn.SNN_STATE_LAYERS:
        _eq(want["state"][k], got["state"][k])
        _eq(want["firing_rates_per_stream"][k],
            got["firing_rates_per_stream"][k])
    _eq(jsnn.snn_logits(want, JCFG), tsnn.snn_logits(got, TCFG))
    assert float(got["out_spikes"].sum()) > 0     # the network is not silent


def test_layer_serial_he_init_flip_fraction(np_params):
    vox = _vox(3, 4)
    want = np.asarray(_jax_run(np_params, vox)["out_spikes"])
    got = _port_run(np_params, vox)["out_spikes"].numpy()
    flipped = float(np.mean(want != got))
    print(f"He-init snn_apply: flipped output-spike fraction {flipped:.2e}")
    assert flipped <= MAX_FLIP_FRACTION


@pytest.mark.parametrize("b,with_state", [(1, False), (3, False),
                                          (3, True)],
                         ids=["b1", "b3", "b3_state"])
def test_layer_serial_equals_time_serial(np_params, b, with_state):
    vox = _vox(4, b)
    state = None
    if with_state:
        rng = np.random.default_rng(7)
        state = {k: torch.from_numpy(rng.uniform(-0.3, 1.0, size=v.shape)
                                     .astype(np.float32))
                 for k, v in tsnn.snn_init_state(TCFG, b).items()}
    ts = _port_run(np_params, vox, state, mode="time_serial")
    ls = _port_run(np_params, vox, state)
    assert torch.equal(ts["out_spikes"], ls["out_spikes"])
    for k in tsnn.SNN_STATE_LAYERS:
        assert torch.equal(ts["state"][k], ls["state"][k])


@pytest.mark.parametrize("mode", ["time_serial", "layer_serial"],
                         ids=["time_serial", "kernels"])
def test_chained_windows_equal_one_scan(np_params, mode):
    vox = _vox(5, 2)
    full = _port_run(np_params, vox, mode=mode)
    state = tsnn.snn_init_state(TCFG, 2)
    chunks = []
    for lo, hi in ((0, 3), (3, 5), (5, 8)):
        out = _port_run(np_params, np.ascontiguousarray(vox[:, lo:hi]),
                        state, mode=mode)
        state = out["state"]
        chunks.append(out["out_spikes"])
    assert torch.equal(torch.cat(chunks, 1), full["out_spikes"])
    for k in tsnn.SNN_STATE_LAYERS:
        assert torch.equal(state[k], full["state"][k])


def test_zero_state_equals_stateless(np_params):
    vox = _vox(6, 2)
    for mode in ("time_serial", "layer_serial"):
        a = _port_run(np_params, vox, mode=mode)
        z = _port_run(np_params, vox, tsnn.snn_init_state(TCFG, 2),
                      mode=mode)
        assert torch.equal(a["out_spikes"], z["out_spikes"])


def test_time_serial_rejects_unsupported_device(np_params):
    """time_serial runs on CUDA and CPU tensors (the STBP training view on
    the card); on any other device it raises ValueError."""
    params = {k: {"w": v["w"].to("meta")}
              for k, v in snn_params_from_numpy(np_params).items()}
    vox = torch.zeros(1, 8, 2, 32, 32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tsnn.snn_apply(params, vox, TCFG, mode="time_serial")


def test_state_planes_match_jax_layout():
    jst = jsnn.snn_init_state(JCFG, 3)
    tst = tsnn.snn_init_state(TCFG, 3)
    assert {k: tuple(v.shape) for k, v in jst.items()} == \
        {k: tuple(v.shape) for k, v in tst.items()}
