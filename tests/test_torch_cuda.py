"""The CUDA kernels on the card, against their plain versions.

Marked ``cuda``: each test asks the ``card`` fixture, which skips without
a GPU (this is decided inside the fixture, never at import). On a machine
with an H100 and no jax run them with
``PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py``
(the suite's conftest imports jax).
All comparisons are bitwise: the kernels repeat their plain versions'
arithmetic operation for operation.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import events as ev  # noqa: E402
from repro_torch.configs import TCN_SMOKE  # noqa: E402
from repro_torch.core import frames as fr  # noqa: E402
from repro_torch.core._api import EngineConfig  # noqa: E402
from repro_torch.core import graphs  # noqa: E402
from repro_torch.core.engine import FrameTCNEngine  # noqa: E402
from repro_torch.core.lif import LIFParams  # noqa: E402
from repro_torch.core.pipeline import BatchedClosedLoop  # noqa: E402
from repro_torch.core.snn import SNNConfig  # noqa: E402
from repro_torch.kernels import fc_lif_scan as k2  # noqa: E402
from repro_torch.kernels import lif_scan as k1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ternary_matmul as k3  # noqa: E402
from repro_torch.kernels import wkv6_scan as k4  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.serving import (FairQuantumPolicy,  # noqa: E402
                                 FusionSession, StreamEngine)

P = LIFParams()
pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run on the card only)")
    return torch.device("cuda")


def _same(a, b):
    return all(torch.equal(x.cpu(), y.cpu()) for x, y in zip(a, b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,misaligned", [
    ((16, 8, 32, 32, 16), False), ((16, 8, 16, 16, 32), False),
    ((17, 3, 37), False), ((16, 1, 5), False), ((1, 8, 1000), False),
    ((17, 2, 64), False), ((16, 8, 8192), True), ((17, 3, 40), True),
    ((7, 3, 12), False), ((40, 2, 96), False)])
def test_k1_matches_plain(card, dtype, shape, misaligned):
    """K1 against its plain version, bit for bit: the event wing's conv1
    and conv2, ragged rows (n % 4, n % 8), a row narrower than a block,
    T = 1, 7, 17 and 40 (every loop of the kernel: chunks of 16 and of 4
    steps, single steps), and storage one element off a 16-byte boundary;
    from rest and from a membrane partly above threshold; the last row
    alone; and (f32) chained at T//2 + 3, which splits a time chunk."""
    g = torch.Generator().manual_seed(0)
    cur = (torch.randn(*shape, generator=g) * 0.6 + 0.3).to(dtype).to(card)
    v0 = (torch.rand(*shape[1:], generator=g) * 1.4 - 0.2).to(card)
    if misaligned:
        cur, v0 = _misaligned(cur), _misaligned(v0)
    t, b = shape[0], shape[1]
    for v in (None, v0):
        want = k1.lif_scan_plain(cur, P, v)
        got = k1.lif_scan_cuda(cur, P, v)
        assert got[0].dtype == dtype and _same(want, got)
        one = k1.lif_scan_cuda(cur[:, b - 1:].contiguous(), P,
                               None if v is None else v[b - 1:])
        assert torch.equal(one[0][:, 0], got[0][:, b - 1])
        assert torch.equal(one[1][0], got[1][b - 1])
        cut = t // 2 + 3
        if dtype == torch.float32 and cut < t:
            a = k1.lif_scan_cuda(cur[:cut], P, v)
            z = k1.lif_scan_cuda(cur[cut:], P, a[1])
            assert torch.equal(torch.cat([a[0], z[0]]), got[0])
            assert torch.equal(z[1], got[1])


@pytest.mark.parametrize("t,b,k,n,dtype", [
    (16, 8, 256, 40, torch.float32), (16, 8, 2048, 512, torch.float32),
    (16, 8, 512, 11, torch.float32), (5, 1, 100, 11, torch.float32),
    (16, 3, 100, 40, torch.bfloat16), (17, 13, 100, 11, torch.float32),
    (17, 8, 100, 40, torch.bfloat16), (17, 13, 100, 520, torch.float32),
    (40, 4, 64, 300, torch.float32), (5, 8, 37, 1000, torch.bfloat16),
    (16, 3, 37, 40, torch.float32)])
def test_k2_matches_plain_and_rows_are_batch_invariant(card, t, b, k, n,
                                                       dtype):
    """K2 against its plain version, bit for bit, at the main path's and
    ragged shapes (both tile shapes, odd K, several T chunks): from rest
    and from a membrane partly above threshold, with the last row alone,
    and (f32, whose v_final chains exactly) in two T halves."""
    g = torch.Generator().manual_seed(1)
    s = (torch.randint(0, 5, (t, b, k), generator=g) / 4.0).to(dtype).to(
        card)
    w = (torch.randn(k, n, generator=g) * k ** -0.5).to(card)
    v0 = (torch.rand(b, n, generator=g) * 1.4 - 0.2).to(card)
    for v in (None, v0):
        want = k2.fc_lif_scan_plain(s, w, P, v)
        got = k2.fc_lif_scan_cuda(s, w, P, v)
        assert got[0].dtype == dtype and _same(want, got)
        one = k2.fc_lif_scan_cuda(s[:, b - 1:].contiguous(), w, P,
                                  None if v is None else v[b - 1:])
        assert torch.equal(one[0][:, 0], got[0][:, b - 1])
        assert torch.equal(one[1][0], got[1][b - 1])
        if dtype == torch.float32:
            a = k2.fc_lif_scan_cuda(s[:t // 2].contiguous(), w, P, v)
            z = k2.fc_lif_scan_cuda(s[t // 2:].contiguous(), w, P, a[1])
            assert torch.equal(torch.cat([a[0], z[0]]), got[0])
            assert torch.equal(z[1], got[1])


@pytest.mark.parametrize("m,k,n", [
    (8, 512, 11), (1, 512, 11), (13, 100, 40), (300, 512, 520), (7, 37, 11)])
def test_k2_currents_entry_matches_plain_and_rows_are_batch_invariant(
        card, m, k, n):
    """``fc_currents`` on the card is one launch of K2's currents entry,
    bit for bit the ascending-k loop, each row as it is alone; the entry
    takes f32 only."""
    g = torch.Generator().manual_seed(4)
    x = torch.randint(-1, 2, (m, k), generator=g).float().to(card)
    w = torch.randn(k, n, generator=g).to(card)
    before = k2.currents_launches
    got = k2.fc_currents(x, w)
    assert k2.currents_launches == before + 1
    assert got.dtype == torch.float32
    assert torch.equal(got, k2.fc_currents_plain(x, w))
    for r in {0, m // 2, m - 1}:
        assert torch.equal(k2.fc_currents(x[r:r + 1], w)[0], got[r])
    with pytest.raises(TypeError, match="float32"):
        k2.fc_currents(x.bfloat16(), w)


def test_ops_count_launches_on_the_card(card):
    before = (k1.launches, k2.launches)
    ops.lif_scan(torch.rand(4, 64, device=card), P)
    ops.fc_lif_scan(torch.rand(4, 2, 32, device=card),
                    torch.rand(32, 8, device=card), P)
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)


CFG = SNNConfig(height=32, width=32, time_bins=4, conv1_features=4,
                conv2_features=8, hidden=32, num_classes=11)


def _mk(rng):
    return lambda *s: torch.from_numpy(
        (rng.normal(size=s) * 0.5).astype(np.float32))


def _snn_params(rng):
    mk = _mk(rng)
    return {"conv1": {"w": mk(4, 2, 3, 3)}, "conv2": {"w": mk(8, 4, 3, 3)},
            "fc1": {"w": mk(CFG.flat_dim, 32)}, "fc2": {"w": mk(32, 11)}}


def _tcn_params(rng):
    mk = _mk(rng)
    return {"conv1": {"w": mk(4, 1, 3, 3)}, "conv2": {"w": mk(8, 4, 3, 3)},
            "fc1": {"w": mk(TCN_SMOKE.flat_dim, 32)},
            "fc2": {"w": mk(32, 11)}}


@pytest.mark.parametrize("m,k,n,dtype,grid", [
    (1, 2048, 512, torch.float32, True), (8, 2048, 512, torch.float32, True),
    (8, 2048, 512, torch.float32, False),
    (8, 2048, 512, torch.bfloat16, False),
    (5, 260, 130, torch.float32, False), (129, 512, 1000, torch.float32,
                                          False),
    (4, 1300, 130, torch.float32, False), (32, 1300, 520, torch.bfloat16,
                                           False),
    (4, 4096, 4096, torch.bfloat16, False),
    (4, 14336, 4096, torch.bfloat16, False),
    (32, 4096, 1000, torch.float32, False),
    (4096, 1024, 256, torch.float32, False)])
def test_k3_matches_plain_and_rows_are_batch_invariant(card, m, k, n, dtype,
                                                       grid):
    """K3 against its plain version, bit for bit, on random bytes (field 3
    included): the split path (up to 64 rows: the 512-k segments of a tile
    in the warps of one block), a short last segment (K=1300), the serial
    path (M=4096), twice in a row, and the last row alone."""
    g = torch.Generator().manual_seed(2)
    x = (torch.randint(-4, 5, (m, k), generator=g) / 4.0 if grid
         else torch.randn(m, k, generator=g)).to(dtype).to(card)
    wp = torch.randint(0, 256, (k // 4, n), generator=g,
                       dtype=torch.uint8).to(card)
    scale = (torch.rand(n, generator=g) + 0.1).to(card)
    want = k3.ternary_matmul_plain(x, wp, scale)
    got = k3.ternary_matmul_cuda(x, wp, scale)
    assert got.dtype == dtype and torch.equal(want, got)
    assert torch.equal(k3.ternary_matmul_cuda(x, wp, scale), got)
    one = k3.ternary_matmul_cuda(x[m - 1:].contiguous(), wp, scale)
    assert torch.equal(one[0], got[m - 1])


def test_default_hetero_engine_launches_all_three_kernels(card):
    """A heterogeneous StreamEngine of default-built wings serves fusion
    ticks on the card through K1, K2 and K3: one K3 launch (fc1) and one
    of K2's currents entry (fc2) per frame-lane step, each step a replay
    of its key's graph, and one more set per key for the eager call
    before the key's capture."""
    rng = np.random.default_rng(3)
    eng = StreamEngine(engines=[BatchedClosedLoop(_snn_params(rng), CFG),
                                FrameTCNEngine(_tcn_params(rng), TCN_SMOKE)],
                       config=EngineConfig(max_streams=2))
    sess = [FusionSession(eng, session_id=i) for i in range(2)]
    for k in range(2):
        for s in sess:
            s.submit(ev.synthetic_gesture_events(
                rng, k, mean_events=800, height=32, width=32),
                fr.synthetic_gesture_frames(rng, k, height=32, width=32))
    before = (k1.launches, k2.launches, k3.launches, k2.currents_launches)
    out = []
    while len(out) < 4:
        rows = eng.step()
        for s in sess:
            rows = s.absorb(rows)
            out += s.drain()
    steps = eng.stats["steps"]
    ev_runs = steps + len(eng.engines["event"].compiled_shape_keys())
    fr_runs = steps + len(eng.engines["frame"].compiled_shape_keys())
    assert (k1.launches - before[0], k2.launches - before[1],
            k3.launches - before[2], k2.currents_launches - before[3]) == (
                2 * ev_runs, 2 * ev_runs, fr_runs, fr_runs)


def test_default_stream_engine_launches_both_kernels(card):
    """A StreamEngine built with no device, no config and no kernel
    arguments serves on the card through K1 and K2: two launches of each
    per engine step (a replay of its key's graph), and two more per key
    for the eager call before the key's capture."""
    cfg = CFG
    rng = np.random.default_rng(0)
    params = _snn_params(rng)
    eng = StreamEngine(params, cfg)
    assert eng.loop.device.type == "cuda"
    hs = [eng.open(stateful=i == 0) for i in range(2)]
    for k in range(3):
        for h in hs:
            h.submit(ev.synthetic_gesture_events(
                rng, k, mean_events=800, height=32, width=32))
    before = (k1.launches, k2.launches)
    out = eng.run()
    steps = eng.stats["steps"]
    runs = steps + len(eng.loop.compiled_shape_keys())
    assert len(out) == 6 and steps >= 1
    assert (k1.launches - before[0], k2.launches - before[1]) == \
        (2 * runs, 2 * runs)


def _wkv(card, b, t, h, hd, dtype, lw_dtype=torch.float32, seed=5):
    g = torch.Generator().manual_seed(seed)
    r, k, v = (torch.randn(b, t, h, hd, generator=g) for _ in range(3))
    logw = torch.clamp(-torch.exp(torch.randn(b, t, h, hd, generator=g)
                                  * 0.5), min=-4.0)
    u = torch.randn(h, hd, generator=g) * 0.5
    return [x.to(dtype).to(card) for x in (r, k, v)] + [
        logw.to(lw_dtype).to(card), u.to(dtype).to(card)]


@pytest.mark.parametrize("b,t,h,hd,dtype,lw_dtype", [
    (4, 32, 64, 64, torch.bfloat16, torch.float32),
    (4, 32, 64, 64, torch.float32, torch.float32),
    (2, 24, 4, 64, torch.bfloat16, torch.bfloat16),
    (2, 16, 4, 16, torch.float32, torch.float32),
    (2, 16, 4, 32, torch.float32, torch.float32),
    # T not a multiple of the kernel's 16-step time chunk: ragged last
    # chunks, a chunk of one step, halves that split a chunk.
    (4, 37, 8, 64, torch.bfloat16, torch.float32),
    (2, 17, 4, 64, torch.float32, torch.float32),
    (2, 37, 4, 32, torch.bfloat16, torch.float32),
    (3, 37, 4, 16, torch.float32, torch.float32),
    # The longest call of the short-chunk instance (4 steps).
    (2, 4, 4, 64, torch.bfloat16, torch.float32)])
def test_k4_matches_plain_chains_and_rows_are_batch_invariant(
        card, b, t, h, hd, dtype, lw_dtype):
    """K4 against its plain version, bit for bit: from zeros, as one-token
    decode calls from a nonzero state, chained in two halves (split
    inside a time chunk where T allows), and with one row alone."""
    r, k, v, logw, u = _wkv(card, b, t, h, hd, dtype, lw_dtype)
    want = k4.wkv6_scan_plain(r, k, v, logw, u)
    got = k4.wkv6_scan_cuda(r, k, v, logw, u)
    assert got[0].dtype == dtype and got[1].dtype == torch.float32
    assert _same(want, got)
    s0 = torch.randn(b, h, hd, hd, generator=torch.Generator().manual_seed(
        6)).to(card)
    one = [x[:, :1].contiguous() for x in (r, k, v, logw)]
    assert _same(k4.wkv6_scan_plain(*one, u, s0),
                 k4.wkv6_scan_cuda(*one, u, s0))
    half = t // 2 + (3 if t >= 8 else 0)
    a = k4.wkv6_scan_cuda(*[x[:, :half].contiguous()
                            for x in (r, k, v, logw)], u)
    z = k4.wkv6_scan_cuda(*[x[:, half:].contiguous()
                            for x in (r, k, v, logw)], u, a[1])
    assert torch.equal(torch.cat([a[0], z[0]], dim=1), got[0])
    assert torch.equal(z[1], got[1])
    row = k4.wkv6_scan_cuda(*[x[b - 1:].contiguous()
                              for x in (r, k, v, logw)], u)
    assert torch.equal(row[0][0], got[0][b - 1])
    assert torch.equal(row[1][0], got[1][b - 1])


@pytest.mark.parametrize("b,t,h,hd,dk,dtype,lw_dtype", [
    (1, 1, 32, 64, 32, torch.bfloat16, torch.float32),
    (1, 1, 32, 64, 4, torch.bfloat16, torch.float32),
    (2, 3, 4, 64, 16, torch.float32, torch.float32),
    (2, 2, 4, 64, 64, torch.bfloat16, torch.bfloat16),
    (3, 1, 4, 32, 8, torch.float32, torch.float32),
    (2, 2, 4, 16, 16, torch.bfloat16, torch.float32)])
def test_k4_stripe_matches_plain_and_the_whole_state_kernel(
        card, b, t, h, hd, dk, dtype, lw_dtype):
    """K4's stripe entry against its plain version bit for bit, stripe by
    stripe; the stripes' rows are the whole-state kernel's rows, and
    where dk is a multiple of 16 their combined partials are its ``o``,
    bit for bit."""
    r, k, v, logw, u = _wkv(card, b, t, h, hd, dtype, lw_dtype)
    s0 = torch.randn(b, h, hd, hd, generator=torch.Generator().manual_seed(
        6)).to(card)
    o, state = k4.wkv6_scan_cuda(r, k, v, logw, u, s0)
    parts = []
    for lo in range(0, hd, dk):
        rows = s0[:, :, lo:lo + dk].contiguous()
        got = k4.wkv6_stripe_cuda(r, k, v, logw, u, rows, lo)
        assert _same(k4.wkv6_stripe_plain(r, k, v, logw, u, rows, lo), got)
        assert torch.equal(got[2], state[:, :, lo:lo + dk])
        parts.append(got[0])
    comb = k4.wkv6_stripe_combine(torch.cat(parts, dim=3), got[1], v)
    if dk % k4.IS == 0:
        assert torch.equal(comb, o)


def _misaligned(x):
    """A contiguous copy of ``x`` whose data starts one element past a
    16-byte boundary."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = flat[1:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_unaligned_inputs_match_plain(card, dtype):
    """Inputs off a 16-byte boundary take K4's element loads in place of
    cp.async; the bits stay the plain version's."""
    r, k, v, logw, u = _wkv(card, 2, 21, 4, 64, dtype, seed=9)
    args = [_misaligned(x) for x in (r, k, v, logw)] + [u]
    assert args[0].data_ptr() % 16 != 0
    assert _same(k4.wkv6_scan_plain(r, k, v, logw, u),
                 k4.wkv6_scan_cuda(*args))


def test_dense_sends_packed_weights_through_k3(card):
    g = torch.Generator().manual_seed(7)
    wp, scale = ops.pack_ternary_weights(torch.randn(512, 256, generator=g))
    w = {"packed": wp.to(card), "scale": scale.to(card)}
    x = torch.randn(2, 3, 512, generator=g).to(card)
    before = k3.launches
    got = layers.dense(x, w)
    assert k3.launches == before + 1 and got.shape == (2, 3, 256)
    want = k3.ternary_matmul_plain(x.reshape(6, 512), w["packed"],
                                   w["scale"]).reshape(2, 3, 256)
    assert torch.equal(got, want)


def test_unembed_gives_f32_logits_of_bf16_operands_on_the_card(card):
    """The bf16 lm_head product on the card has an f32 output and no f32
    copy of lm_head; it is the f32 product of the casts up to the order
    of its f32 sum (the logits are O(1): 1e-4 is ~100 f32 ulps of them,
    and a bf16 rounding of the output would miss it by ~1e-2)."""
    from repro_torch.configs.rwkv6_7b import SMOKE
    from repro_torch.models import rwkv6
    g = torch.Generator().manual_seed(8)
    d, v = SMOKE.d_model, SMOKE.vocab_size
    params = {"ln_f_s": torch.ones(d, dtype=torch.bfloat16, device=card),
              "ln_f_b": torch.zeros(d, dtype=torch.bfloat16, device=card),
              "lm_head": (torch.randn(d, v, generator=g) / d ** 0.5).to(
                  torch.bfloat16).to(card)}
    h = torch.randn(2, 3, d, generator=g).to(torch.bfloat16).to(card)
    got = rwkv6._unembed(params, h, SMOKE)
    hn = rwkv6.L.layer_norm(h, params["ln_f_s"], params["ln_f_b"],
                            SMOKE.norm_eps)
    want = torch.matmul(hn.float(), params["lm_head"].float())
    assert got.dtype == torch.float32 and got.shape == (2, 3, v)
    assert torch.allclose(got, want, rtol=0, atol=1e-4)


# -- captured CUDA graphs (one per shape key) ---------------------------------

def _event_windows(rng, streams, n):
    return [[ev.synthetic_gesture_events(rng, (s + k) % 11, mean_events=1500,
                                         height=32, width=32)
             for k in range(n)] for s in range(streams)]


def _frame_windows(rng, streams, n):
    return [[fr.synthetic_gesture_frames(rng, (s + 3 * k) % 11, height=32,
                                         width=32)
             for k in range(n)] for s in range(streams)]


def _eager(engine, key, batch, state):
    """The key's run function called eagerly on the batch, with the
    staged host arrays moved to the card."""
    args = engine._mega_args(batch, state)
    args = (args[0].to(engine.device), *args[1:])
    return engine._build_run(key)(args)


def test_captured_steps_equal_eager_runs(card):
    """A replay of a key's graph equals an eager call of the same run
    function bit for bit: the event wing over three chained stateful
    windows (its state planes too), and the frame wing."""
    rng = np.random.default_rng(11)
    loop = BatchedClosedLoop(_snn_params(rng), CFG)
    ws = _event_windows(rng, 4, 3)
    state_g, state_e = loop.init_state(4), loop.init_state(4)
    for k in range(3):
        batch = loop.prepare([w[k] for w in ws], batch_size=4)
        key = loop.shape_key(batch)
        (_, got), state_g = loop.infer_dispatch(batch, state_g)
        want = _eager(loop, key, batch, state_e)
        state_e = dict(zip(state_g, want[1:]))
        assert key in loop.compiled_shape_keys()
        assert torch.equal(got, want[0])
        for name in state_g:
            assert torch.equal(state_g[name], state_e[name])
    fe = FrameTCNEngine(_tcn_params(rng), TCN_SMOKE, duration_us=300_000)
    batch = fe.prepare([f[0] for f in _frame_windows(rng, 3, 1)],
                       batch_size=4)
    _, got = fe.infer_dispatch(batch)
    want = _eager(fe, fe.shape_key(batch), batch, None)
    assert torch.equal(got, want[0])


def test_launch_counters_follow_replays(card):
    """Each replay adds its graph's captured tally to the kernels'
    counters: two K1 and two K2 launches an event step, one K3 and one
    of K2's currents entry a frame step; the capture itself adds none."""
    rng = np.random.default_rng(12)
    loop = BatchedClosedLoop(_snn_params(rng), CFG)
    fe = FrameTCNEngine(_tcn_params(rng), TCN_SMOKE, duration_us=300_000)
    ekey, fkey = (2, 2048, 300_000), (2, 32, 32, 300_000)
    loop.warmup([ekey])
    fe.warmup([fkey])
    assert loop._graphs.steps[ekey].tally == (2, 2, 0, 0, 0)
    assert fe._graphs.steps[fkey].tally == (0, 0, 1, 1, 0)
    before = graphs.launch_counts()
    ws = _event_windows(rng, 2, 1)
    frames = _frame_windows(rng, 2, 1)
    n = 5
    for _ in range(n):
        loop.infer(loop.prepare([w[0] for w in ws], batch_size=2))
        fe.infer(fe.prepare([f[0] for f in frames], batch_size=2))
    after = graphs.launch_counts()
    assert tuple(a - b for a, b in zip(after, before)) == (
        2 * n, 2 * n, n, n, 0)


def test_warmed_keys_capture_nothing_new(card):
    """``compiled_shape_keys``/``compiled_megastep_keys`` list exactly the
    keys holding a graph, and serving a warmed key captures nothing."""
    rng = np.random.default_rng(13)
    loop = BatchedClosedLoop(_snn_params(rng), CFG)
    fe = FrameTCNEngine(_tcn_params(rng), TCN_SMOKE)
    eng = StreamEngine(engines=[loop, fe], config=EngineConfig(
        max_streams=2, megastep=True, duration_us=300_000))
    pair = ((2, 2048, 300_000), (2, 32, 32, 300_000))
    eng.warmup_megastep([pair])
    assert eng.compiled_megastep_keys() == {pair}
    assert loop.compiled_shape_keys() == fe.compiled_shape_keys() == set()
    held = eng._mega_graphs.steps[pair]
    sess = [FusionSession(eng, session_id=i) for i in range(2)]
    for s, w, f in zip(sess, _event_windows(rng, 2, 1),
                       _frame_windows(rng, 2, 1)):
        s.submit(w[0], f[0])
    out = []
    while len(out) < 2:
        rows = eng.step()
        for s in sess:
            rows = s.absorb(rows)
            out += s.drain()
    assert eng.compiled_megastep_keys() == {pair}
    assert eng._mega_graphs.steps[pair] is held
    loop.warmup([pair[0]])
    step = loop._graphs.steps[pair[0]]
    loop.infer(loop.prepare([w[0] for w in _event_windows(rng, 2, 1)],
                            batch_size=2))
    assert loop.compiled_shape_keys() == {pair[0]}
    assert loop._graphs.steps[pair[0]] is step


def _contended_event_run(params, depth):
    eng = StreamEngine(params, CFG, EngineConfig(
        max_streams=4, pipeline_depth=depth, policy=FairQuantumPolicy(1)))
    hs = [eng.open(stream_id=i, stateful=True) for i in range(8)]
    ws = _event_windows(np.random.default_rng(14), 8, 3)
    for k in range(3):
        for h, w in zip(hs, ws):
            h.submit(w[k])
    return {(r.stream_id, r.seq): r.result for r in eng.run()}, eng


def _contended_fused_run(params, tparams, depth, megastep):
    eng = StreamEngine(
        engines=[BatchedClosedLoop(params, CFG),
                 FrameTCNEngine(tparams, TCN_SMOKE)],
        config=EngineConfig(max_streams=4, pipeline_depth=depth,
                            policy=FairQuantumPolicy(1), megastep=megastep))
    sess = [FusionSession(eng, session_id=i, stateful=True)
            for i in range(8)]
    rng = np.random.default_rng(15)
    data = zip(_event_windows(rng, 8, 3), _frame_windows(rng, 8, 3))
    data = list(data)
    for k in range(3):
        for s, (w, f) in zip(sess, data):
            s.submit(w[k], f[k])
    out = {}
    for _ in range(100):
        rows = eng.step()
        for s in sess:
            rows = s.absorb(rows)
            out.update({(r.stream_id, r.seq): r.result for r in s.drain()})
        if len(out) == 24:
            break
    return out, eng


def test_pipelined_contention_keeps_the_bits(card):
    """8 stateful streams over 4 slots (quantum 1) pipelined one step deep
    equal the synchronous run bit for bit: each step's readout and carry
    are fresh memory (a replay overwrites the graph's own outputs), and a
    staging buffer is not rewritten while its copy may still be queued.
    The same for fusion sessions with the megastep on."""
    rng = np.random.default_rng(16)
    params, tparams = _snn_params(rng), _tcn_params(rng)
    sync, _ = _contended_event_run(params, 0)
    piped, eng = _contended_event_run(params, 1)
    assert eng._lanes["event"].parked and sorted(sync) == sorted(piped)
    for k in sync:
        np.testing.assert_array_equal(sync[k].logits, piped[k].logits)
        np.testing.assert_array_equal(sync[k].pwm, piped[k].pwm)
    ref, _ = _contended_fused_run(params, tparams, 0, False)
    fused, feng = _contended_fused_run(params, tparams, 1, True)
    assert len(ref) == len(fused) == 24 and feng.compiled_megastep_keys()
    for k in ref:
        np.testing.assert_array_equal(ref[k].logits, fused[k].logits)
        np.testing.assert_array_equal(ref[k].pwm, fused[k].pwm)
