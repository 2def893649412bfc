"""The port's ternary substrate and kernel K3 against the JAX package.

  * ``pack2bit``/``unpack2bit``: bitwise equal to JAX's, round trips exact;
  * ``ternarize``: ``q`` equal to JAX's; ``scale`` within 1e-6 relative
    (both are means of the same f32 values, summed in different orders);
  * ``pack_ternary_weights``: packed bytes equal, scale as above;
  * K3's plain version against ``ternary_matmul_pallas(interpret=True)``
    at the JAX tests' shapes: within the JAX tests' own tolerances (f32
    1e-4: summation order; bf16 2e-2: the output's bf16 rounding), and
    bit for bit when ``x`` lies on the 1/4 grid (every partial sum is then
    exact in any order), as it does at the frame wing's fc1.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import ternary as jter  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ternary_matmul import ternary_matmul_pallas  # noqa: E402

from repro_torch.core import ternary as tter  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ternary_matmul as k3  # noqa: E402
from repro_torch.kernels.ref import ternary_matmul_ref  # noqa: E402

# The JAX kernel tests' shapes (tests/test_kernels_ternary.py).
SHAPES = [(8, 128, 256), (5, 64, 32), (129, 512, 1000), (1, 256, 512),
          (64, 260, 130)]
SCALE_RTOL = 1e-6


def _weights(k, n, seed):
    return np.random.default_rng(seed).normal(size=(k, n)).astype(np.float32)


def test_pack_unpack_bitwise_and_round_trip():
    rng = np.random.default_rng(0)
    for shape in [(2, 4), (7, 64), (3, 5, 16)]:
        q = rng.integers(-1, 2, size=shape).astype(np.int8)
        want = np.asarray(jter.pack2bit(jnp.asarray(q)))
        got = tter.pack2bit(torch.from_numpy(q))
        assert got.dtype == torch.uint8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            tter.unpack2bit(got).numpy(),
            np.asarray(jter.unpack2bit(jnp.asarray(want))))
        np.testing.assert_array_equal(tter.unpack2bit(got).numpy(), q)
    # Every byte value unpacks like JAX's, including the unused field 3.
    every = np.arange(256, dtype=np.uint8)[None]
    np.testing.assert_array_equal(
        tter.unpack2bit(torch.from_numpy(every)).numpy(),
        np.asarray(jter.unpack2bit(jnp.asarray(every))))
    with pytest.raises(ValueError, match="multiple of 4"):
        tter.pack2bit(torch.zeros(2, 6, dtype=torch.int8))


@pytest.mark.parametrize("axis", [-1, 0, None])
def test_ternarize_matches_jax(axis):
    w = _weights(64, 32, 1) * 2.0
    jq, js = jter.ternarize(jnp.asarray(w), axis=axis)
    q, s = tter.ternarize(torch.from_numpy(w), axis=axis)
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert tuple(s.shape) == tuple(js.shape)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=SCALE_RTOL)


def test_pack_ternary_weights_matches_jax():
    w = _weights(260, 130, 2)
    jp, js = jops.pack_ternary_weights(jnp.asarray(w))
    p, s = ops.pack_ternary_weights(torch.from_numpy(w))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=SCALE_RTOL)
    with pytest.raises(ValueError, match="multiple of 4"):
        ops.pack_ternary_weights(torch.zeros(6, 3))


def _jax_packed(k, n, seed):
    jp, js = jops.pack_ternary_weights(jnp.asarray(_weights(k, n, seed)))
    return (jp, js, torch.from_numpy(np.array(jp)),
            torch.from_numpy(np.array(js)))


@pytest.mark.parametrize("m,k,n", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(m, k, n, dtype):
    jp, js, wp, sc = _jax_packed(k, n, 3)
    x = np.random.default_rng(4).normal(size=(m, k)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = np.asarray(ternary_matmul_pallas(jx, jp, js, interpret=True),
                      np.float32)
    tx = torch.from_numpy(np.asarray(jx.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = k3.ternary_matmul_plain(tx, wp, sc)
    assert got.dtype == tx.dtype and tuple(got.shape) == (m, n)
    tol = 2e-2 if dtype == "bfloat16" else 1e-4
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    # The oracle computes the same function through a library matmul.
    np.testing.assert_allclose(
        ternary_matmul_ref(tx, wp, sc).float().numpy(), want, rtol=tol,
        atol=tol)


@pytest.mark.parametrize("m", [1, 8])
def test_quarter_grid_is_bitwise_at_the_call_site(m):
    """fc1 of the frame wing: x is a 2x2 average of ternary activations
    (a multiple of 1/4 in [-1, 1]), K=2048, N=512."""
    jp, js, wp, sc = _jax_packed(2048, 512, 5)
    x = (np.random.default_rng(6).integers(-4, 5, size=(m, 2048))
         / 4.0).astype(np.float32)
    want = np.asarray(ternary_matmul_pallas(jnp.asarray(x), jp, js,
                                            interpret=True))
    got = k3.ternary_matmul_plain(torch.from_numpy(x), wp, sc).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        ops.ternary_matmul(torch.from_numpy(x), wp, sc).numpy(), want)


def test_plain_rows_do_not_depend_on_the_batch():
    _, _, wp, sc = _jax_packed(260, 130, 7)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        size=(8, 260)).astype(np.float32))
    full = k3.ternary_matmul_plain(x, wp, sc)
    for i in (0, 5):
        assert torch.equal(k3.ternary_matmul_plain(x[i:i + 1], wp, sc)[0],
                           full[i])


def test_wrapper_refuses_bad_inputs_and_cpu_takes_plain():
    _, _, wp, sc = _jax_packed(16, 8, 9)
    x = torch.rand(3, 16)
    before = k3.launches
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3.ternary_matmul_cuda(x.double(), wp, sc)
    with pytest.raises(TypeError, match="uint8"):
        k3.ternary_matmul_cuda(x, wp.int(), sc)
    with pytest.raises(ValueError, match="K/4"):
        k3.ternary_matmul_cuda(torch.rand(3, 12), wp, sc)
    with pytest.raises(ValueError, match="CUDA"):
        k3.ternary_matmul_cuda(x, wp, sc)               # CPU tensors
    assert torch.equal(k3.ternary_matmul_fwd(x, wp, sc),
                       k3.ternary_matmul_plain(x, wp, sc))
    assert k3.launches == before
