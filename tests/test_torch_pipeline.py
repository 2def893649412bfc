"""The port's batched closed loop against the JAX package and itself.

Against JAX at the same batch shape: predictions equal; PWM, logits,
energy and latency within tolerances (PWM goes through a softmax whose
exp and sum round differently in the two libraries; energy and latency
are float64 host math on per-stream firing rates). Inside the port:
B in {1, 4, 8} give the same bits per stream, and export/import of a
slot's carry round-trips exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import snn as jsnn  # noqa: E402
from repro.core.pipeline import BatchedClosedLoop as JLoop  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.convert import snn_params_from_numpy  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import snn as tsnn  # noqa: E402
from repro_torch.core.pipeline import (BatchedClosedLoop,  # noqa: E402
                                       ClosedLoopPipeline, pwm_from_logits)

JCFG = jsnn.SNNConfig(height=32, width=32, time_bins=8, conv1_features=4,
                      conv2_features=8, hidden=32, num_classes=11)
TCFG = tsnn.SNNConfig(height=32, width=32, time_bins=8, conv1_features=4,
                      conv2_features=8, hidden=32, num_classes=11)
# Softmax over 11 logits: exp and the normalising sum differ by f32 ulps.
PWM_ATOL = 1e-6
# Logits are spike counts x 10 / T: exact given equal spikes.
LOGIT_ATOL = 0.0
# Energy and latency are host float64 math on f32 rates that are equal.
ACCT_RTOL = 1e-12


@pytest.fixture(scope="module")
def np_params():
    return jax.tree_util.tree_map(
        np.asarray, jsnn.init_snn(jax.random.PRNGKey(0), JCFG))


def _windows(seed, n):
    rng = np.random.default_rng(seed)
    return [ev.synthetic_gesture_events(rng, (3 * i + seed) % 11,
                                        mean_events=2000, height=32,
                                        width=32)
            for i in range(n)]


def _port_loop(np_params, **kw):
    return BatchedClosedLoop(snn_params_from_numpy(np_params), TCFG,
                             device="cpu", **kw)


def test_results_match_jax(np_params):
    ws = _windows(1, 4)
    batch = ev.pad_event_windows(ws + [None], max_events=4096)
    jl = JLoop(jax.tree_util.tree_map(jnp.asarray, np_params), JCFG,
               lif_scan_fn=jops.lif_scan, fuse_fc=True)
    want, _ = jl.infer(batch, jl.init_state(5))
    got = _port_loop(np_params).infer(batch)
    assert got[4] is None and want[4] is None
    for a, b in zip(want[:4], got[:4]):
        np.testing.assert_array_equal(a.label_pred, b.label_pred)
        np.testing.assert_allclose(b.logits, a.logits, rtol=0,
                                   atol=LOGIT_ATOL)
        np.testing.assert_allclose(b.pwm, a.pwm, rtol=0, atol=PWM_ATOL)
        np.testing.assert_allclose(b.energy_mj, a.energy_mj, rtol=ACCT_RTOL)
        np.testing.assert_allclose(b.latency_ms, a.latency_ms,
                                   rtol=ACCT_RTOL)
        assert b.realtime == a.realtime


def test_pwm_from_logits_matches_jax():
    from repro.core.pipeline import pwm_from_logits as jpwm
    logits = np.random.default_rng(2).normal(0, 4, size=(6, 11)).astype(
        np.float32)
    np.testing.assert_allclose(
        pwm_from_logits(torch.from_numpy(logits)).numpy(),
        np.asarray(jpwm(jnp.asarray(logits))), rtol=0, atol=PWM_ATOL)


@pytest.mark.parametrize("b", [1, 4, 8])
def test_batch_rows_bitwise_equal_alone(np_params, b):
    ws = _windows(3, b)
    loop = _port_loop(np_params)
    batched = loop.infer_windows(ws, max_events=4096)
    for w, r in zip(ws, batched):
        alone = loop.infer_windows([w], max_events=4096)[0]
        np.testing.assert_array_equal(alone.pwm, r.pwm)
        np.testing.assert_array_equal(alone.logits, r.logits)
        assert alone.energy_mj == r.energy_mj
        assert alone.breakdown["firing_rates"] == r.breakdown["firing_rates"]


def test_pipeline_b1_wrapper_equals_batched(np_params):
    ws = _windows(4, 3)
    pipe = ClosedLoopPipeline(snn_params_from_numpy(np_params), TCFG,
                              device="cpu")
    batched = _port_loop(np_params).infer_windows(ws)
    for w, r in zip(ws, batched):
        np.testing.assert_array_equal(pipe(w).pwm, r.pwm)


def test_stateful_chaining_and_export_import_roundtrip(np_params):
    ws = _windows(5, 4)
    loop = _port_loop(np_params)
    batch = ev.pad_event_windows(ws[:2], max_events=4096)
    state = loop.init_state(2)
    zero_res, state = loop.infer(batch, state)
    stateless = loop.infer(batch)
    for a, b in zip(zero_res, stateless):
        np.testing.assert_array_equal(a.pwm, b.pwm)
    payload = loop.export_state(state, 1)
    assert all(isinstance(v, np.ndarray) for v in payload.values())
    spliced = loop.import_state(loop.init_state(2), 1, payload)
    assert torch.equal(spliced["fc1"][1], state["fc1"][1])
    for k in state:
        assert torch.equal(spliced[k][1], state[k][1])
        assert not spliced[k][0].any()
    # The spliced carry continues exactly like the original.
    nxt = ev.pad_event_windows(ws[2:], max_events=4096)
    a, _ = loop.infer(nxt, state)
    b, _ = loop.infer(nxt, spliced)
    np.testing.assert_array_equal(a[1].pwm, b[1].pwm)
    np.testing.assert_array_equal(a[1].logits, b[1].logits)


def test_warmup_records_keys(np_params):
    loop = _port_loop(np_params, duration_us=300_000)
    loop.warmup([(2, 1024), (4, 2048, 300_000)])
    assert loop.compiled_shape_keys() == {(2, 1024, 300_000),
                                          (4, 2048, 300_000)}
    with pytest.raises(ValueError):
        loop.warmup([(1, 2, 3, 4)])


def test_pwm_mix_matrix_is_made_once_per_device():
    from repro_torch.core import pipeline as tpipe
    a = tpipe._mix_on(11, 4, torch.device("cpu"))
    assert a is tpipe._mix_on(11, 4, torch.device("cpu"))
    np.testing.assert_array_equal(a.numpy(), tpipe._mix_matrix(11, 4))


def test_megastep_adapters_compose_to_the_dispatch(np_params):
    """``_mega_split(run(_mega_args(...)))`` -- what the fused megastep
    does with this wing -- gives infer_dispatch's bits, stateless and
    chained; the keys served are the keys compiled."""
    ws = _windows(6, 3)
    loop = _port_loop(np_params)
    batch = ev.pad_event_windows(ws, max_events=4096)
    key = loop.shape_key(batch)
    assert loop.compiled_shape_keys() == set()
    state = None
    for _ in range(2):
        run, inputs = loop._mega_parts(key)
        assert inputs[0].shape == (5, 3, 4096)
        assert set(inputs[1]) == set(loop.init_state(3))
        pending, new = loop._mega_split(run(loop._mega_args(batch, state)),
                                        batch, state)
        want = loop.infer_dispatch(batch, state)
        want_pending, want_new = want if state is not None else (want, new)
        assert torch.equal(pending[1], want_pending[1])
        for k in want_new:
            assert torch.equal(new[k], want_new[k])
        state = new
    assert loop.compiled_shape_keys() == {key}
