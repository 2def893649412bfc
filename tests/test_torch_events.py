"""Voxelization in the port against the JAX package: bitwise.

Voxel counts are integers in both packages, so grids must be equal bit for
bit -- with padding, empty slots, and malformed events on one stream that
must not leak into its neighbour's voxels.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import events as jev  # noqa: E402

from repro_torch.core import events as tev  # noqa: E402

H = W = 32
TB = 8


def _windows(seed, n, mean_events=1500):
    rng = np.random.default_rng(seed)
    return [tev.synthetic_gesture_events(rng, i % 11, mean_events=mean_events,
                                         height=H, width=W)
            for i in range(n)]


def test_copied_generators_match_jax():
    a = _windows(0, 3)
    rng = np.random.default_rng(0)
    b = [jev.synthetic_gesture_events(rng, i % 11, mean_events=1500,
                                      height=H, width=W) for i in range(3)]
    for wa, wb in zip(a, b):
        for f in ("x", "y", "t", "p"):
            np.testing.assert_array_equal(getattr(wa, f), getattr(wb, f))
    pa = tev.pad_event_windows(a + [None], max_events=4096)
    pb = jev.pad_event_windows(b + [None], max_events=4096)
    for f in ("x", "y", "t", "p", "valid", "num_events", "occupied",
              "labels"):
        np.testing.assert_array_equal(getattr(pa, f), getattr(pb, f))
    assert tev.next_pow2(1500) == jev.next_pow2(1500) == 2048


@pytest.mark.parametrize("binary", [True, False])
def test_voxelize_single_bitwise(binary):
    w = _windows(1, 1)[0]
    # Malformed events: negative and too-large coordinates, bad polarity.
    x = np.concatenate([w.x, [-1, W, 3]]).astype(np.int32)
    y = np.concatenate([w.y, [0, 0, H + 5]]).astype(np.int32)
    t = np.concatenate([w.t, [5, 5, 5]]).astype(np.int32)
    p = np.concatenate([w.p, [0, 1, 1]]).astype(np.int32)
    kw = dict(duration_us=w.duration_us, time_bins=TB, height=H, width=W,
              binary=binary)
    want = jev.voxelize(jnp.asarray(x), jnp.asarray(y), jnp.asarray(t),
                        jnp.asarray(p), **kw)
    got = tev.voxelize(*(torch.from_numpy(a) for a in (x, y, t, p)), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("binary", [True, False])
def test_voxelize_batch_bitwise_with_padding_and_bad_events(binary):
    ws = _windows(2, 3)
    batch = tev.pad_event_windows([ws[0], None, ws[1], ws[2]],
                                  max_events=4096, batch_size=5)
    # Out-of-range events on stream 2 only: without the per-stream mask
    # they would land in stream 3's voxels.
    c = int(batch.num_events[2])
    batch.x[2, c - 3:c] = [W + 1, -2, W * H]
    batch.y[2, c - 3:c] = [H - 1, 0, H - 1]
    kw = dict(duration_us=batch.duration_us, time_bins=TB, height=H,
              width=W, binary=binary)
    want = jev.voxelize_batch(*(jnp.asarray(getattr(batch, f))
                                for f in ("x", "y", "t", "p", "valid")),
                              **kw)
    got = tev.voxelize_batch(*(torch.from_numpy(getattr(batch, f))
                               for f in ("x", "y", "t", "p", "valid")),
                             **kw)
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    assert got[1].sum() == 0 and got[4].sum() == 0       # empty slots
    # Each occupied slot equals its window voxelized alone.
    for slot, win in ((0, ws[0]), (3, ws[2])):
        alone = tev.voxelize(*(torch.from_numpy(getattr(win, f))
                               for f in ("x", "y", "t", "p")), **kw)
        assert torch.equal(got[slot], alone)
