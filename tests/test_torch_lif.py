"""The port's LIF dynamics and kernel K1 against the JAX package, on the CPU.

On a CPU tensor ``repro_torch.kernels.ops.lif_scan`` runs K1's plain
version, which repeats the kernel's arithmetic (every multiply and add
rounded on its own). Given the same currents, the LIF scan is exact in
both frameworks, so values are compared bit for bit; gradients go through
different autodiff machinery and are compared within a tolerance.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core.lif import LIFParams as JLIFParams  # noqa: E402
from repro.core.lif import lif_scan_reference as j_lif_ref  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels.ref import lif_scan_ref as j_lif_scan_ref  # noqa: E402

from repro_torch.core.lif import LIFParams, lif_scan_reference  # noqa: E402
from repro_torch.core.lif import spike_surrogate  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import lif_scan as k1  # noqa: E402
from repro_torch.kernels.ref import lif_scan_ref  # noqa: E402

P = LIFParams()
JP = JLIFParams()

# Gradients: same formulas, different evaluation order in the two autodiff
# systems, so a few f32 ulps apart.
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def _currents(seed, shape):
    return np.random.default_rng(seed).normal(0.3, 0.5, size=shape).astype(
        np.float32)


def _eq(a, b):
    np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


@pytest.mark.parametrize("with_v0", [False, True], ids=["cold", "v0"])
@pytest.mark.parametrize("shape", [(8, 37), (6, 3, 5, 4), (17, 37), (1, 37)])
def test_lif_scan_bitwise_vs_jax(shape, with_v0):
    cur = _currents(0, shape)
    v0 = None
    if with_v0:
        # Membranes above threshold: the initial spike state is implied by
        # v0 (s0 = v0 >= v_th), so these neurons reset at the first step.
        v0 = np.random.default_rng(1).uniform(-0.2, 1.2,
                                              size=shape[1:]).astype(
            np.float32)
    jv0 = None if v0 is None else jnp.asarray(v0)
    tv0 = None if v0 is None else torch.from_numpy(v0)
    j_ref = j_lif_ref(jnp.asarray(cur), JP, jv0)
    j_kern = jops.lif_scan(jnp.asarray(cur), JP, jv0)
    j_oracle = j_lif_scan_ref(jnp.asarray(cur), JP, jv0)
    for got in (lif_scan_reference(torch.from_numpy(cur), P, tv0),
                ops.lif_scan(torch.from_numpy(cur), P, tv0),
                k1.lif_scan_plain(torch.from_numpy(cur), P, tv0),
                lif_scan_ref(torch.from_numpy(cur), P, tv0)):
        for want in (j_ref, j_kern, j_oracle):
            _eq(want[0], got[0])
            _eq(want[1], got[1])


def test_lif_scan_bf16_plain_matches_jax_oracle():
    """bf16 currents, f32 membrane, bf16 outputs, as the JAX kernel."""
    cur = _currents(2, (8, 64))
    jc = jnp.asarray(cur).astype(jnp.bfloat16)
    tc = torch.from_numpy(cur).to(torch.bfloat16)
    want_s, want_v = j_lif_scan_ref(jc, JP)
    got_s, got_v = k1.lif_scan_plain(tc, P)
    assert got_s.dtype == torch.bfloat16 and got_v.dtype == torch.bfloat16
    np.testing.assert_array_equal(np.asarray(want_s.astype(jnp.float32)),
                                  got_s.float().numpy())
    np.testing.assert_array_equal(np.asarray(want_v.astype(jnp.float32)),
                                  got_v.float().numpy())


def test_lif_scan_bf16_with_v0_plain_matches_jax_oracle():
    """bf16 currents with an f32 v0 partly above threshold: the membrane
    starts from v0 in f32, spikes and v_final come back in bf16."""
    cur = _currents(11, (17, 3, 37))
    v0 = np.random.default_rng(12).uniform(-0.2, 1.2,
                                           size=(3, 37)).astype(np.float32)
    jc = jnp.asarray(cur).astype(jnp.bfloat16)
    tc = torch.from_numpy(cur).to(torch.bfloat16)
    want_s, want_v = j_lif_scan_ref(jc, JP, jnp.asarray(v0))
    for got_s, got_v in (k1.lif_scan_plain(tc, P, torch.from_numpy(v0)),
                         ops.lif_scan(tc, P, torch.from_numpy(v0))):
        assert got_s.dtype == torch.bfloat16
        assert got_v.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(want_s.astype(jnp.float32)), got_s.float().numpy())
        np.testing.assert_array_equal(
            np.asarray(want_v.astype(jnp.float32)), got_v.float().numpy())


@pytest.mark.parametrize("key", ["TC", "TAIL", "THREADS"])
def test_cu_geometry_matches_the_wrapper(key):
    """The wrapper's geometry constants are the .cu's constexprs (the
    library also reports them through lif_scan_geometry when it loads)."""
    src = (Path(k1.__file__).resolve().parents[1] / "csrc"
           / "lif_scan.cu").read_text()
    found = re.search(rf"constexpr int {key} = (\d+);", src)
    assert found is not None and int(found.group(1)) == getattr(k1, key)


def test_grad_through_v0_alone_matches_jax():
    """With grad on and only v0 requiring it, ``ops.lif_scan`` keeps the
    autograd node: v0's STBP gradient matches JAX's."""
    cur = _currents(17, (6, 20))
    v0 = np.random.default_rng(18).uniform(0, 1, size=(20,)).astype(
        np.float32)
    gv = np.random.default_rng(19).normal(size=v0.shape).astype(np.float32)

    def j_loss(v):
        return jnp.sum(jops.lif_scan(jnp.asarray(cur), JP, v)[1] * gv)

    want = jax.grad(j_loss)(jnp.asarray(v0))
    tv = torch.from_numpy(v0).requires_grad_()
    s, vf = ops.lif_scan(torch.from_numpy(cur), P, tv)
    assert s.grad_fn is not None
    (vf * torch.from_numpy(gv)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_no_grad_call_skips_autograd_with_the_same_values():
    """``ops.lif_scan`` under no_grad (how the engines call it) calls the
    forward directly: no autograd node, the same bits."""
    cur = torch.from_numpy(_currents(13, (9, 4, 6)))
    v0 = torch.from_numpy(_currents(14, (4, 6)))
    with torch.no_grad():
        s, v = ops.lif_scan(cur.requires_grad_(), P, v0)
    assert s.grad_fn is None and v.grad_fn is None
    want_s, want_v = k1.lif_scan_plain(cur.detach(), P, v0)
    assert torch.equal(s, want_s) and torch.equal(v, want_v)
    s, v = ops.lif_scan(cur, P, v0)
    assert s.grad_fn is not None
    assert torch.equal(s.detach(), want_s)


def test_two_chained_windows_equal_one_scan():
    cur = torch.from_numpy(_currents(3, (12, 50)))
    full_s, full_v = ops.lif_scan(cur, P)
    s_a, v_a = ops.lif_scan(cur[:5], P)
    s_b, v_b = ops.lif_scan(cur[5:], P, v_a)
    assert torch.equal(torch.cat([s_a, s_b]), full_s)
    assert torch.equal(v_b, full_v)


def test_lif_scan_batched_rows_equal_per_stream_calls():
    cur = torch.from_numpy(_currents(4, (3, 7, 4, 5)))   # (B, T, ...)
    v0 = torch.from_numpy(_currents(5, (3, 4, 5)))
    s, v = ops.lif_scan_batched(cur, P, v0)
    for b in range(3):
        sb, vb = ops.lif_scan(cur[b], P, v0[b])
        assert torch.equal(s[b], sb) and torch.equal(v[b], vb)


def test_spike_surrogate_grad_matches_jax():
    from repro.core.lif import spike_surrogate as j_spike
    v = np.linspace(-1.5, 2.5, 41).astype(np.float32)
    g = np.random.default_rng(6).normal(size=v.shape).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(j_spike(x, jnp.float32(0.5), 2.0)
                                      * g))(jnp.asarray(v))
    tv = torch.from_numpy(v).requires_grad_()
    (spike_surrogate(tv, 0.5, 2.0) * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(want),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_lif_scan_grads_match_jax():
    cur = _currents(7, (6, 20))
    v0 = np.random.default_rng(8).uniform(0, 1, size=(20,)).astype(
        np.float32)
    gs = np.random.default_rng(9).normal(size=cur.shape).astype(np.float32)
    gv = np.random.default_rng(10).normal(size=v0.shape).astype(np.float32)

    def j_loss(c, v):
        s, vf = jops.lif_scan(c, JP, v)
        return jnp.sum(s * gs) + jnp.sum(vf * gv)

    jgc, jgv = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(cur),
                                                jnp.asarray(v0))
    tc = torch.from_numpy(cur).requires_grad_()
    tv = torch.from_numpy(v0).requires_grad_()
    s, vf = ops.lif_scan(tc, P, tv)
    ((s * torch.from_numpy(gs)).sum()
     + (vf * torch.from_numpy(gv)).sum()).backward()
    np.testing.assert_allclose(tc.grad.numpy(), np.asarray(jgc),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(tv.grad.numpy(), np.asarray(jgv),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
