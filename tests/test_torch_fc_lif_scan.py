"""Kernel K2 (fused ``spikes @ W`` + LIF) against the JAX package, on the CPU.

On a CPU tensor ``ops.fc_lif_scan`` runs K2's plain version: ascending-k
f32 currents, then the LIF loop, and ``fc_currents`` (the currents alone,
the frame wing's fc2) runs the loop. Two weight sets:

  * dyadic weights (He-init rounded to multiples of 2**-8): with fc1-like
    inputs (multiples of 1/4) every product and partial sum is exact in
    f32, so summation order cannot matter and the port must equal JAX
    bit for bit;
  * He-init f32 weights: currents agree within a tolerance, and the
    fraction of output spikes that flip is reported and bounded.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.lif import LIFParams as JLIFParams  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402

from repro_torch.core.lif import LIFParams  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import fc_lif_scan as k2  # noqa: E402

P = LIFParams()
JP = JLIFParams()

# He-init currents: the same f32 products summed in another order differ
# by a few ulps of the largest partial sum.
CUR_RTOL, CUR_ATOL = 1e-5, 1e-6
# A current a few ulps off flips a spike only when the membrane sits that
# close to v_th; over a few thousand neuron-steps that is rare.
MAX_FLIP_FRACTION = 0.01
# Gradients: same formulas, different autodiff evaluation order.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _he(rng, k, n):
    return (rng.normal(size=(k, n)) * 2.0 * np.sqrt(2.0 / k)).astype(
        np.float32)


def _dyadic(w):
    return (np.round(w * 256.0) / 256.0).astype(np.float32)


def _pooled_spikes(rng, shape):
    """fc1-like input: a 2x2 average pool of spikes, values in {0, 1/4,
    1/2, 3/4, 1}, mostly zero."""
    return (rng.binomial(4, 0.15, size=shape) / 4.0).astype(np.float32)


@pytest.mark.parametrize("with_v0", [False, True], ids=["cold", "v0"])
@pytest.mark.parametrize("b", [1, 4])
def test_fc_lif_scan_dyadic_bitwise_vs_jax(b, with_v0):
    rng = np.random.default_rng(10 + b)
    t, k, n = 8, 64, 24
    s = _pooled_spikes(rng, (t, b, k))
    w = _dyadic(_he(rng, k, n))
    v0 = (rng.uniform(-0.2, 1.2, size=(b, n)).astype(np.float32)
          if with_v0 else None)
    want = jops.fc_lif_scan(jnp.asarray(s), jnp.asarray(w), JP,
                            None if v0 is None else jnp.asarray(v0))
    got = ops.fc_lif_scan(torch.from_numpy(s), torch.from_numpy(w), P,
                          None if v0 is None else torch.from_numpy(v0))
    np.testing.assert_array_equal(np.asarray(want[0]), got[0].numpy())
    np.testing.assert_array_equal(np.asarray(want[1]), got[1].numpy())


def test_fc_lif_scan_2d_input_matches_batched_row():
    rng = np.random.default_rng(3)
    s = torch.from_numpy(_pooled_spikes(rng, (6, 3, 40)))
    w = torch.from_numpy(_he(rng, 40, 16))
    full_s, full_v = ops.fc_lif_scan(s, w, P)
    one_s, one_v = ops.fc_lif_scan(s[:, 1], w, P)          # (T, K)
    assert one_s.shape == (6, 16) and one_v.shape == (16,)
    assert torch.equal(one_s, full_s[:, 1]) and torch.equal(one_v,
                                                            full_v[1])


def test_fc_lif_scan_he_init_within_tolerance():
    rng = np.random.default_rng(4)
    t, b, k, n = 16, 4, 128, 64
    s = _pooled_spikes(rng, (t, b, k))
    w = _he(rng, k, n)
    want_cur = np.asarray(jnp.matmul(jnp.asarray(s), jnp.asarray(w),
                                     precision="highest"))
    got_cur = k2.fc_currents(torch.from_numpy(s), torch.from_numpy(w))
    np.testing.assert_allclose(got_cur.numpy(), want_cur, rtol=CUR_RTOL,
                               atol=CUR_ATOL)
    want = np.asarray(jops.fc_lif_scan(jnp.asarray(s), jnp.asarray(w),
                                       JP)[0])
    got = ops.fc_lif_scan(torch.from_numpy(s), torch.from_numpy(w),
                          P)[0].numpy()
    flipped = float(np.mean(want != got))
    print(f"He-init fc_lif_scan: flipped spike fraction {flipped:.2e}")
    assert flipped <= MAX_FLIP_FRACTION


@pytest.mark.parametrize("big", [4, 8])
def test_plain_b1_rows_equal_batched_rows(big):
    """The port's own contract: a stream's rows do not depend on the batch
    (ascending-k sums are per row)."""
    rng = np.random.default_rng(5)
    s = torch.from_numpy(_pooled_spikes(rng, (8, big, 96)))
    w = torch.from_numpy(_he(rng, 96, 48))
    v0 = torch.from_numpy(rng.uniform(0, 1, size=(big, 48)).astype(
        np.float32))
    bs, bv = k2.fc_lif_scan_plain(s, w, P, v0)
    for r in range(big):
        s1, v1 = k2.fc_lif_scan_plain(s[:, r:r + 1], w, P, v0[r:r + 1])
        assert torch.equal(s1[:, 0], bs[:, r]) and torch.equal(v1[0], bv[r])


def test_fc_lif_scan_batched_entry():
    rng = np.random.default_rng(6)
    s = torch.from_numpy(_pooled_spikes(rng, (3, 5, 32)))     # (B, T, K)
    w = torch.from_numpy(_he(rng, 32, 8))
    out, v = ops.fc_lif_scan_batched(s, w, P)
    ref, rv = ops.fc_lif_scan(s.transpose(0, 1).contiguous(), w, P)
    assert torch.equal(out, ref.transpose(0, 1)) and torch.equal(v, rv)


def test_fc_lif_scan_grads_match_jax():
    rng = np.random.default_rng(7)
    t, b, k, n = 6, 2, 32, 12
    s = _pooled_spikes(rng, (t, b, k))
    w = _dyadic(_he(rng, k, n))
    v0 = rng.uniform(0, 1, size=(b, n)).astype(np.float32)
    gs = rng.normal(size=(t, b, n)).astype(np.float32)
    gv = rng.normal(size=(b, n)).astype(np.float32)

    def j_loss(s_, w_, v_):
        o, vf = jops.fc_lif_scan(s_, w_, JP, v_)
        return jnp.sum(o * gs) + jnp.sum(vf * gv)

    jg = jax.grad(j_loss, argnums=(0, 1, 2))(
        jnp.asarray(s), jnp.asarray(w), jnp.asarray(v0))
    ts, tw, tv = (torch.from_numpy(a).requires_grad_() for a in (s, w, v0))
    o, vf = ops.fc_lif_scan(ts, tw, P, tv)
    ((o * torch.from_numpy(gs)).sum()
     + (vf * torch.from_numpy(gv)).sum()).backward()
    for want, got in zip(jg, (ts.grad, tw.grad, tv.grad)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("shape", [(8, 64), (1, 64), (4, 3, 40)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fc_currents_on_cpu_is_the_loop(shape, dtype):
    """The dispatcher sends CPU tensors to the ascending-k loop, bit for
    bit, whatever the leading dims, and launches nothing."""
    rng = np.random.default_rng(8)
    s = torch.from_numpy(_pooled_spikes(rng, shape)).to(dtype)
    w = torch.from_numpy(_he(rng, shape[-1], 11))
    before = (k2.launches, k2.currents_launches)
    got = k2.fc_currents(s, w)
    assert got.dtype == torch.float32 and got.shape == (*shape[:-1], 11)
    assert torch.equal(got, k2.fc_currents_plain(s, w))
    assert (k2.launches, k2.currents_launches) == before


@pytest.mark.parametrize("b", [1, 8])
def test_fc_currents_ternary_bitwise_vs_jax(b):
    """The frame wing's fc2: ternary activations times dyadic weights are
    exact products and sums, so the port's ascending-k currents equal the
    JAX package's ``s3 @ w`` bit for bit."""
    rng = np.random.default_rng(20 + b)
    s3 = rng.integers(-1, 2, size=(b, 96)).astype(np.float32)
    w = _dyadic(_he(rng, 96, 11))
    want = np.asarray(jnp.asarray(s3) @ jnp.asarray(w))
    got = k2.fc_currents(torch.from_numpy(s3), torch.from_numpy(w))
    np.testing.assert_array_equal(want, got.numpy())


def test_fc_currents_refuses_bad_inputs():
    s, w = torch.zeros(4, 16), torch.zeros(16, 8)
    with pytest.raises(ValueError, match="do not match"):
        k2.fc_currents(s, torch.zeros(15, 8))
    with pytest.raises(ValueError, match="do not match"):
        k2.fc_currents(s, torch.zeros(16))
    with pytest.raises(ValueError, match="unsupported device"):
        k2.fc_currents(s.to("meta"), w.to("meta"))
    before = k2.currents_launches
    with pytest.raises(TypeError, match="spikes"):
        k2.fc_currents_cuda(s.half(), w)
    with pytest.raises(TypeError, match="float32 spikes"):
        k2.fc_currents_cuda(s.bfloat16(), w)       # the entry takes f32
    with pytest.raises(TypeError, match="weights"):
        k2.fc_currents_cuda(s, w.double())
    with pytest.raises(ValueError, match="do not match"):
        k2.fc_currents_cuda(s, torch.zeros(15, 8))
    with pytest.raises(ValueError, match="contiguous"):
        k2.fc_currents_cuda(torch.zeros(16, 4).t(), w)
    with pytest.raises(ValueError, match="CUDA"):
        k2.fc_currents_cuda(s, w)                    # CPU tensors
    assert k2.currents_launches == before
