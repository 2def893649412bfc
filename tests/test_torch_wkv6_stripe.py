"""K4's stripe entry (``kernels.wkv6_scan.wkv6_stripe_*``): the WKV of a
decode step on a stripe of each state's dk rows, as a rank of a
context-parallel rwkv6 decode runs it (the state's dk over ``data``).

On the CPU the entry is its plain version. Each (dk_loc, hd) splits a
whole state into hd / dk_loc stripes; every stripe's call runs on the same
inputs, and against the whole-state plain version
(``wkv6_scan_plain``):

  * each stripe's new rows are the whole state's rows bit for bit;
  * the partials of every stripe, in ascending row order, added by
    ``wkv6_stripe_combine`` give the whole-state ``o`` bit for bit where
    dk_loc is a multiple of ``IS`` (= 16), and within 1e-6 relative
    otherwise (a stripe of 4 or 8 rows is summed as one segment);
  * at T = 1 ``o`` and the state agree with the JAX package's stepwise
    decode step (``repro.models.rwkv6._wkv6_step``) on the whole state
    within 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models.rwkv6 import _wkv6_step as jax_wkv6_step  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import wkv6_scan as k4  # noqa: E402

PAIRS = [(dk, hd) for hd in (16, 32, 64) for dk in (4, 8, 16, 32)
         if dk <= hd]


def _inputs(b, t, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.normal(size=(b, t, h, hd)).astype(np.float32)
               for _ in range(3))
    logw = np.maximum(-np.exp(rng.normal(size=(b, t, h, hd)) * 0.5),
                      -4.0).astype(np.float32)
    u = (rng.normal(size=(h, hd)) * 0.5).astype(np.float32)
    s0 = rng.normal(size=(b, h, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, s0


def _stripes(dk, hd, b=2, t=3, h=3, seed=0):
    """Every stripe's call on the same inputs: ([(partials, beta, rows)],
    the whole-state plain version's (o, state), the inputs)."""
    r, k, v, logw, u, s0 = (torch.from_numpy(x)
                            for x in _inputs(b, t, h, hd, seed))
    calls = [k4.wkv6_stripe_plain(r, k, v, logw, u,
                                  s0[:, :, lo:lo + dk].contiguous(), lo)
             for lo in range(0, hd, dk)]
    return calls, k4.wkv6_scan_plain(r, k, v, logw, u, s0), (
        r, k, v, logw, u, s0)


@pytest.mark.parametrize("dk,hd", PAIRS)
def test_stripe_rows_equal_the_whole_states_rows(dk, hd):
    calls, (_, state), _ = _stripes(dk, hd)
    for i, (part, beta, rows) in enumerate(calls):
        assert rows.shape == (2, 3, dk, hd) and rows.dtype == torch.float32
        assert torch.equal(rows, state[:, :, i * dk:(i + 1) * dk])
        assert part.shape == (2, 3, 3, dk // min(k4.IS, dk), hd)
        assert torch.equal(beta, calls[0][1])


@pytest.mark.parametrize("dk,hd", PAIRS)
def test_ordered_sum_of_stripes_is_the_whole_states_o(dk, hd):
    calls, (o, _), (r, k, v, *_rest) = _stripes(dk, hd)
    parts = torch.cat([c[0] for c in calls], dim=3)
    got = k4.wkv6_stripe_combine(parts, calls[0][1], v)
    assert got.dtype == o.dtype
    if dk % k4.IS == 0:
        assert torch.equal(got, o)
    else:
        rel = float(((got - o).abs().max() / o.abs().max()))
        assert rel <= 1e-6, rel


@pytest.mark.parametrize("dk,hd", PAIRS)
def test_stripes_agree_with_the_jax_decode_step(dk, hd):
    calls, _, (r, k, v, logw, u, s0) = _stripes(dk, hd, t=1, seed=3)
    parts = torch.cat([c[0] for c in calls], dim=3)
    o = k4.wkv6_stripe_combine(parts, calls[0][1], v)[:, 0]
    state = torch.cat([c[2] for c in calls], dim=2)
    o_j, s_j = jax_wkv6_step(*(jnp.asarray(x[:, 0].numpy())
                               for x in (r, k, v, logw)),
                             jnp.asarray(u.numpy()), jnp.asarray(s0.numpy()))
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(state.numpy(), np.asarray(s_j), rtol=1e-5,
                               atol=1e-5)


def test_one_stripe_of_every_row_is_the_whole_state_kernel():
    """A stripe of all hd rows (a data axis of one rank) is the whole-state
    plain version bit for bit, in bf16 with f32 logw too."""
    r, k, v, logw, u, s0 = (torch.from_numpy(x)
                            for x in _inputs(2, 2, 4, 64, seed=4))
    rb, kb, vb, ub = (x.to(torch.bfloat16) for x in (r, k, v, u))
    part, beta, rows = ops.wkv6_stripe(rb, kb, vb, logw, ub, s0, 0)
    o, state = k4.wkv6_scan_plain(rb, kb, vb, logw, ub, s0)
    got = k4.wkv6_stripe_combine(part, beta, vb)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, o) and torch.equal(rows, state)


def test_stripe_shape_only_counts_its_calls_and_flops():
    """On tensors without storage the entry launches nothing: shape-only
    outputs, one call and 7 * B * T * H * dk_loc * hd FLOPs in K4's
    shape-only tallies (and its own call count)."""
    meta = dict(device="meta")
    r = torch.empty(1, 1, 32, 64, dtype=torch.bfloat16, **meta)
    logw = torch.empty(1, 1, 32, 64, **meta)
    u = torch.empty(32, 64, dtype=torch.bfloat16, **meta)
    s0 = torch.empty(1, 32, 32, 64, **meta)
    calls, flops, own = (k4.shape_only_calls, k4.shape_only_flops,
                         k4.stripe_shape_only_calls)
    part, beta, rows = k4.wkv6_stripe_fwd(r, r, r, logw, u, s0, 32)
    assert part.shape == (1, 1, 32, 2, 64) and beta.shape == (1, 1, 32)
    assert rows.shape == s0.shape and part.dtype == torch.float32
    assert k4.shape_only_calls == calls + 1
    assert k4.stripe_shape_only_calls == own + 1
    assert k4.shape_only_flops == flops + 7 * 32 * 32 * 64
    assert k4.stripe_launches == 0


@pytest.mark.parametrize("bad", ["rows", "place", "dtype"])
def test_stripe_arguments_are_checked(bad):
    r, k, v, logw, u, s0 = (torch.from_numpy(x)
                            for x in _inputs(1, 1, 2, 32))
    rows, lo = s0[:, :, :8].contiguous(), 8
    if bad == "rows":
        rows = s0[:, :, :12].contiguous()
    if bad == "place":
        lo = 4
    if bad == "dtype":
        with pytest.raises(TypeError):
            k4.wkv6_stripe_cuda(r.double(), k, v, logw, u, rows, lo)
        return
    with pytest.raises(ValueError):
        k4.wkv6_stripe_plain(r, k, v, logw, u, rows, lo)
