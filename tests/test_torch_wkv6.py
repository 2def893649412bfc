"""K4 (the RWKV-6 WKV recurrence) in the port against the JAX package.

The same numpy inputs go through the port's plain version (what a CPU
tensor runs), JAX's Pallas kernel in interpret mode (as
``tests/test_kernels_wkv6.py`` runs it), the JAX stepwise and chunked
oracles, and the port's own oracles. Cross-package comparisons hold the
JAX tests' tolerance (rtol = atol = 2e-4); the port's contracts (chaining
through ``state0``, bf16 inputs as their f32 values) hold bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.ref import wkv6_ref as jax_wkv6_ref  # noqa: E402
from repro.kernels.wkv6_scan import wkv6_scan_pallas  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked as jax_wkv6_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6_scan as k4  # noqa: E402
from repro_torch.kernels.ref import wkv6_ref  # noqa: E402
from repro_torch.models.rwkv6 import _wkv6_step, wkv6_chunked  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)      # the JAX package's own WKV tolerance
SHAPES = [(1, 8, 1, 64), (2, 24, 3, 64), (2, 17, 2, 64), (1, 40, 5, 64)]


def _inputs(b, t, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.maximum(-np.exp(rng.normal(size=(b, t, h, hd)) * 0.5),
                      -4.0).astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.1).astype(np.float32)
    return r, k, v, logw, u


def _t(*xs):
    return [torch.from_numpy(x) for x in xs]


def _chunk(t):
    return min(8, t) if t % 8 == 0 else 1


@pytest.mark.parametrize("b,t,h,hd", SHAPES)
def test_plain_matches_jax_kernel_and_oracles(b, t, h, hd):
    np_in = _inputs(b, t, h, hd)
    o, s = k4.wkv6_scan_plain(*_t(*np_in))
    o_k, s_k = wkv6_scan_pallas(*map(jnp.asarray, np_in), interpret=True)
    o_c, s_c = jax_wkv6_chunked(*map(jnp.asarray, np_in), chunk=_chunk(t))
    for want_o, want_s in ((o_k, s_k), (o_c, s_c)):
        np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **TOL)
        np.testing.assert_allclose(s.numpy(), np.asarray(want_s), **TOL)
    r, k, v, logw, u = np_in
    for bi, hi in {(0, 0), (b - 1, h - 1)}:        # the stepwise oracle
        o_r, s_r = jax_wkv6_ref(*(jnp.asarray(x[bi, :, hi])
                                  for x in (r, k, v)),
                                jnp.exp(logw[bi, :, hi]), u[hi])
        np.testing.assert_allclose(o[bi, :, hi].numpy(), np.asarray(o_r),
                                   **TOL)
        np.testing.assert_allclose(s[bi, hi].numpy(), np.asarray(s_r),
                                   **TOL)


@pytest.mark.parametrize("b,t,h,hd", [(2, 24, 3, 64), (1, 40, 2, 16)])
def test_port_oracles_match_jax_oracles(b, t, h, hd):
    np_in = _inputs(b, t, h, hd, seed=1)
    r, k, v, logw, u = np_in
    s0 = np.random.default_rng(2).normal(size=(b, h, hd, hd)).astype(
        np.float32) * 0.1
    o, s = wkv6_chunked(*_t(*np_in), state0=torch.from_numpy(s0),
                        chunk=_chunk(t))
    o_j, s_j = jax_wkv6_chunked(*map(jnp.asarray, np_in),
                                state0=jnp.asarray(s0), chunk=_chunk(t))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    w = np.exp(logw)
    for bi, hi in ((0, 0), (b - 1, h - 1)):
        args = [x[bi, :, hi] for x in (r, k, v, w)] + [u[hi], s0[bi, hi]]
        o_p, s_p = wkv6_ref(*_t(*args))
        o_r, s_r = jax_wkv6_ref(*map(jnp.asarray, args))
        np.testing.assert_allclose(o_p.numpy(), np.asarray(o_r), **TOL)
        np.testing.assert_allclose(s_p.numpy(), np.asarray(s_r), **TOL)


@pytest.mark.parametrize("hd", [16, 32, 64])
def test_plain_matches_port_oracles_with_state0(hd):
    """Against the port's chunked form and, one token at a time, its
    stepwise decode oracle ``_wkv6_step``."""
    np_in = _inputs(2, 16, 3, hd, seed=3)
    s0 = torch.randn(2, 3, hd, hd, generator=torch.Generator().manual_seed(4))
    o, s = k4.wkv6_scan_plain(*_t(*np_in), state0=s0)
    o_c, s_c = wkv6_chunked(*_t(*np_in), state0=s0, chunk=8)
    torch.testing.assert_close(o, o_c, **TOL)
    torch.testing.assert_close(s, s_c, **TOL)
    r, k, v, logw, u = _t(*np_in)
    st = s0
    for t in range(r.shape[1]):
        o_t, st = _wkv6_step(r[:, t], k[:, t], v[:, t], logw[:, t], u, st)
        torch.testing.assert_close(o_t, o[:, t], **TOL)
    torch.testing.assert_close(st, s, **TOL)


def test_state0_chaining_is_bitwise():
    """Two halves chained through state0, and T one-token calls, give the
    bits of one unbroken scan (what decode relies on)."""
    r, k, v, logw, u = _t(*_inputs(2, 12, 3, 32, seed=5))
    o, s = k4.wkv6_scan_plain(r, k, v, logw, u)
    o_a, s_a = k4.wkv6_scan_plain(r[:, :5], k[:, :5], v[:, :5],
                                  logw[:, :5], u)
    o_b, s_b = k4.wkv6_scan_plain(r[:, 5:], k[:, 5:], v[:, 5:],
                                  logw[:, 5:], u, state0=s_a)
    assert torch.equal(torch.cat([o_a, o_b], dim=1), o)
    assert torch.equal(s_b, s)
    st = None
    for t in range(12):
        o_t, st = k4.wkv6_scan_plain(r[:, t:t + 1], k[:, t:t + 1],
                                     v[:, t:t + 1], logw[:, t:t + 1], u, st)
        assert torch.equal(o_t, o[:, t:t + 1])
    assert torch.equal(st, s)


def test_rows_do_not_depend_on_the_batch():
    r, k, v, logw, u = _t(*_inputs(4, 10, 2, 16, seed=6))
    o, s = k4.wkv6_scan_plain(r, k, v, logw, u)
    o1, s1 = k4.wkv6_scan_plain(r[2:3], k[2:3], v[2:3], logw[2:3], u)
    assert torch.equal(o1[0], o[2]) and torch.equal(s1[0], s[2])


def test_bf16_inputs_with_f32_logw():
    """bf16 r/k/v/u with f32 logw (what the bf16 model hands over): the
    state equals the f32 scan of the same (upcast) values bit for bit and
    o is that scan's o rounded to bf16. Against the JAX kernel on the same
    bf16 inputs: within one bf16 rounding of o (2**-8 relative) plus the
    f32 tolerance."""
    r, k, v, logw, u = _t(*_inputs(2, 24, 3, 64, seed=7))
    rb, kb, vb, ub = (x.to(torch.bfloat16) for x in (r, k, v, u))
    o, s = ops.wkv6_scan(rb, kb, vb, logw, ub)
    o32, s32 = k4.wkv6_scan_plain(rb.float(), kb.float(), vb.float(), logw,
                                  ub.float())
    assert o.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert torch.equal(s, s32) and torch.equal(o, o32.to(torch.bfloat16))
    to_j = lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    o_j, s_j = wkv6_scan_pallas(to_j(rb), to_j(kb), to_j(vb),
                                jnp.asarray(logw.numpy()), to_j(ub),
                                interpret=True)
    assert o_j.dtype == jnp.bfloat16
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), **TOL)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(o_j.astype(jnp.float32)),
                               rtol=2 ** -8, atol=2e-4)


def _np_order(r, k, v, w, u, s0):
    """The order K4 defines, in float32 numpy, one (b, h) and step at a
    time: segment partials of r.S in ascending i, the partials added in
    ascending segment order from +0, then beta v with beta the ascending
    dot (r*u).k; the state update as it always was. ``w`` is
    exp(logw) from the same elementwise exp as the plain version: the
    exp is no part of the order."""
    f32 = np.float32
    b, t, h, hd = r.shape
    seg = min(k4.IS, hd)
    o = np.zeros((b, t, h, hd), f32)
    s_out = np.zeros((b, h, hd, hd), f32)
    for bi in range(b):
        for hi in range(h):
            s = (np.zeros((hd, hd), f32) if s0 is None
                 else s0[bi, hi].astype(f32).copy())
            for ti in range(t):
                rt, kt, vt, wt = (x[bi, ti, hi] for x in (r, k, v, w))
                beta = f32(0)
                for i in range(hd):
                    beta = f32(beta + f32(f32(rt[i] * u[hi, i]) * kt[i]))
                acc = np.zeros(hd, f32)
                for g0 in range(0, hd, seg):
                    p = np.zeros(hd, f32)
                    for i in range(g0, g0 + seg):
                        p = p + rt[i] * s[i]
                    acc = acc + p
                o[bi, ti, hi] = acc + beta * vt
                s = wt[:, None] * s + kt[:, None] * vt[None, :]
            s_out[bi, hi] = s
    return o, s_out


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("t", [1, 5, 37])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_plain_is_the_segmented_order(hd, t, dtype, with_state):
    """wkv6_scan_plain equals the numpy model of its order bit for bit,
    bf16 inputs taken at their f32 values."""
    np_in = _inputs(2, t, 2, hd, seed=8 + hd + t)
    s0 = (np.random.default_rng(9).normal(size=(2, 2, hd, hd)).astype(
        np.float32) * 0.1 if with_state else None)
    r, k, v, logw, u = _t(*np_in)
    if dtype == "bfloat16":
        r, k, v, u = (x.to(torch.bfloat16) for x in (r, k, v, u))
    o, s = k4.wkv6_scan_plain(r, k, v, logw, u,
                              None if s0 is None else torch.from_numpy(s0))
    w = torch.exp(logw).numpy()
    o_np, s_np = _np_order(*(x.float().numpy() for x in (r, k, v)), w,
                           u.float().numpy(), s0)
    assert o.dtype == r.dtype
    np.testing.assert_array_equal(s.numpy(), s_np)
    want_o = torch.from_numpy(o_np).to(r.dtype)
    assert torch.equal(o, want_o)


@pytest.mark.parametrize("hd", [16, 64])
def test_final_state_keeps_its_rounding(hd):
    """The state update is the one K4 always had, element by element:
    S_ij <- exp(logw_i) * S_ij + k_i * v_j, each op rounded alone."""
    r, k, v, logw, u = _t(*_inputs(2, 9, 3, hd, seed=10))
    s0 = torch.randn(2, 3, hd, hd, generator=torch.Generator().manual_seed(
        11))
    _, s = k4.wkv6_scan_plain(r, k, v, logw, u, s0)
    want = s0.clone()
    w = torch.exp(logw)
    for t in range(r.shape[1]):
        for i in range(hd):
            kv = k[:, t, :, i, None] * v[:, t]
            want[:, :, i] = w[:, t, :, i, None] * want[:, :, i] + kv
    assert torch.equal(s, want)


def test_segment_width_matches_the_cuda_source():
    """The plain version's IS is the .cu's constexpr IS (the library also
    reports it when it loads, checked by the wrapper on the card)."""
    import re
    from pathlib import Path
    src = (Path(k4.__file__).resolve().parents[1] / "csrc"
           / "wkv6_scan.cu").read_text()
    found = re.search(r"constexpr int IS = (\d+);", src)
    assert found is not None and int(found.group(1)) == k4.IS


@pytest.mark.parametrize("seg", [16, 32])
def test_plain_segment_width_only_moves_o(seg):
    """Another segment width (a probe's kernel variant) changes o only by
    rounding and leaves the state's bits alone."""
    r, k, v, logw, u = _t(*_inputs(2, 7, 2, 64, seed=12))
    o, s = k4.wkv6_scan_plain(r, k, v, logw, u)
    o2, s2 = k4.wkv6_scan_plain(r, k, v, logw, u, seg=seg)
    assert torch.equal(s, s2)
    torch.testing.assert_close(o2, o, **TOL)
