"""The port's ternary substrate and kernel K3 against the JAX package.

  * ``pack2bit``/``unpack2bit``: bitwise equal to JAX's, round trips exact;
  * ``ternarize``: ``q`` equal to JAX's; ``scale`` within 1e-6 relative
    (both are means of the same f32 values, summed in different orders);
  * ``pack_ternary_weights``: packed bytes equal, scale as above;
  * K3's plain version against ``ternary_matmul_pallas(interpret=True)``
    at the JAX tests' shapes: within the JAX tests' own tolerances (f32
    1e-4: summation order; bf16 2e-2: the output's bf16 rounding), and
    bit for bit when ``x`` lies on the 1/4 grid (every partial sum is then
    exact in any order), as it does at the frame wing's fc1;
  * K3's plain version bit for bit against a float32 numpy model of its
    segmented order (ascending k within 512-k segments, the partials in
    ascending segment order), which at K <= 512 is the ascending-k sum,
    on random bytes that include the unused field 3 (+2); its rows at any
    M; and the kernel's launch plan (split or serial path).
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


def _np_unpack(wp):
    """(K/4, N) uint8 -> (K, N) float32 field values - 1 (field 3 is +2)."""
    f = np.stack([(wp >> (2 * i)) & 3 for i in range(4)], axis=1)
    return f.reshape(-1, wp.shape[1]).astype(np.float32) - 1.0


def _np_sum(x, q, segment):
    """Float32 numpy model of K3's order: per ``segment`` k an ascending
    sum from +0, each product and add rounded on its own, the partials
    added in ascending order."""
    acc = np.zeros((x.shape[0], q.shape[1]), np.float32)
    for k0 in range(0, q.shape[0], segment):
        part = np.zeros_like(acc)
        for k in range(k0, min(k0 + segment, q.shape[0])):
            part = part + x[:, k, None] * q[k]
        acc = acc + part
    return acc


def _random_case(m, k, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    wp = rng.integers(0, 256, size=(k // 4, n), dtype=np.uint8)
    scale = (rng.random(n) + 0.1).astype(np.float32)
    return x, wp, scale


@pytest.mark.parametrize("k", [260, 1024, 1300, 2048])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_is_the_segmented_sum(k, dtype):
    x, wp, scale = _random_case(3, k, 40, 10 + k)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = _np_sum(tx.float().numpy(), _np_unpack(wp), k3.KS) * scale
    got = k3.ternary_matmul_plain(tx, torch.from_numpy(wp),
                                  torch.from_numpy(scale))
    assert got.dtype == tx.dtype
    assert torch.equal(got, torch.from_numpy(want).to(tx.dtype))


@pytest.mark.parametrize("k", [4, 260, 512])
def test_plain_is_the_ascending_sum_up_to_one_segment(k):
    x, wp, scale = _random_case(5, k, 24, 20 + k)
    want = _np_sum(x, _np_unpack(wp), k) * scale
    got = k3.ternary_matmul_plain(torch.from_numpy(x), torch.from_numpy(wp),
                                  torch.from_numpy(scale))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m", [1, 3, 8, 33])
def test_plain_rows_do_not_depend_on_m(m):
    x, wp, scale = _random_case(33, 1300, 36, 30)
    wp, scale = torch.from_numpy(wp), torch.from_numpy(scale)
    full = k3.ternary_matmul_plain(torch.from_numpy(x), wp, scale)
    got = k3.ternary_matmul_plain(torch.from_numpy(x[:m]), wp, scale)
    assert torch.equal(got, full[:m])
    last = k3.ternary_matmul_plain(torch.from_numpy(x[m - 1:m]), wp, scale)
    assert torch.equal(last[0], full[m - 1])


@pytest.mark.parametrize("lead", [(2, 3), (4, 1), (1, 2, 3)])
def test_plain_takes_leading_dims(lead):
    """``x`` (..., K) gives (..., N): the rows of the (M, K) product."""
    m = int(np.prod(lead))
    x, wp, scale = _random_case(m, 1300, 36, 31)
    wp, scale = torch.from_numpy(wp), torch.from_numpy(scale)
    flat = k3.ternary_matmul_plain(torch.from_numpy(x), wp, scale)
    got = ops.ternary_matmul(torch.from_numpy(x).reshape(*lead, 1300), wp,
                             scale)
    assert got.shape == (*lead, 36)
    assert torch.equal(got.reshape(m, 36), flat)


@pytest.mark.parametrize("m,k,n,path", [
    (4, 4096, 4096, "split"), (4, 4096, 14336, "split"),
    (4, 14336, 4096, "split"), (8, 2048, 512, "split"),
    (1, 2048, 512, "split"), (4, 1300, 130, "split"),
    (32, 4096, 4096, "split"), (32, 14336, 4096, "split"),
    (32, 4096, 14336, "split"), (64, 14336, 4096, "split"),
    (96, 4096, 4096, "serial"), (4096, 1024, 256, "serial"),
    (8192, 4096, 4096, "serial"), (129, 512, 1000, "serial"),
    (8, 512, 512, "serial"), (1, 4, 1, "serial"),
    (4, 1 << 20, 4096, "serial")])
def test_plan_splits_only_small_products(m, k, n, path):
    """Up to 64 rows take the split path (the segments of a tile spread
    over the warps of one block, at most 16), more the serial one (one
    warp walks every segment of its tile), as do one segment and more
    than 32; a thread holds at most M rows rounded up to a power of
    two."""
    p = k3.plan(m, k, n)
    assert p.path == path
    assert p.rows in (1, 2, 4, 8) and (p.rows == 1 or p.rows < 2 * m)
    assert p == k3.launch_plan(m, k, n, p.rows, p.group)
    if path == "split":
        assert p.warps <= 16 and p.warps * p.group >= -(-k // k3.KS)
