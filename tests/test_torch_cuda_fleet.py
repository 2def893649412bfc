"""What the fleet's churn asks of the engines on the card.

The fleet control plane builds, resizes and drops engines while others
serve. Two things it found on the H100 are pinned here:

  * a CUDA graph capture survives dead engines being collected: a dead
    engine is cyclic garbage holding graphs, pinned staging buffers and
    events, and a collector pass that frees them inside a capture
    invalidates it (``core/graphs.capture`` holds the collector off until
    the capture ends);
  * a conv row's bits do not depend on the slot count: cuDNN picks its
    algorithm by the batch size, and for 256 images it picked one that
    rounds inside the sum, so ``core/snn._conv`` convolves at most
    ``CONV_CHUNK`` images a call.

Marked ``cuda`` where the card is needed (the ``card`` fixture skips
without one; run on the H100 with ``PYTHONPATH=src python -m pytest -q
--noconftest tests/test_torch_cuda_fleet.py``). The chunking itself is
checked on the CPU too.
"""
import gc

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import CONFIG  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import snn  # noqa: E402
from repro_torch.core._api import EngineConfig  # noqa: E402
from repro_torch.core.pipeline import BatchedClosedLoop  # noqa: E402
from repro_torch.core.snn import SNNConfig  # noqa: E402
from repro_torch.serving import StreamEngine  # noqa: E402

CFG = SNNConfig(height=32, width=32, time_bins=4, conv1_features=4,
                conv2_features=8, hidden=32, num_classes=11)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and cuDNN run on the card)")
    return torch.device("cuda")


def _dyadic(rng, *shape):
    w = rng.normal(size=shape) * 0.2
    return torch.from_numpy((np.round(w * 256) / 256).astype(np.float32))


def _snn_params(rng):
    return {"conv1": {"w": _dyadic(rng, 4, 2, 3, 3)},
            "conv2": {"w": _dyadic(rng, 8, 4, 3, 3)},
            "fc1": {"w": _dyadic(rng, CFG.flat_dim, 32)},
            "fc2": {"w": _dyadic(rng, 32, 11)}}


def _event_windows(rng, streams):
    return [ev.synthetic_gesture_events(rng, s % 11, mean_events=1500,
                                        height=32, width=32)
            for s in range(streams)]


def test_conv_takes_at_most_conv_chunk_images_a_call(monkeypatch):
    """``_conv`` of more than ``CONV_CHUNK`` images calls the conv on
    chunks of at most that many, and equals one call on exact (2**-8 grid)
    inputs; at most ``CONV_CHUNK`` images it is one call."""
    rng = np.random.default_rng(0)
    x = (torch.from_numpy(rng.random((2 * snn.CONV_CHUNK + 16, 8, 8, 4)))
         < 0.3).float()
    w = _dyadic(rng, 6, 4, 3, 3)
    whole = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w, padding=1)
    calls = []
    conv2d = torch.nn.functional.conv2d

    def counting(inp, *args, **kw):
        calls.append(inp.shape[0])
        return conv2d(inp, *args, **kw)

    monkeypatch.setattr(snn.F, "conv2d", counting)
    got = snn._conv(x, w)
    assert calls == [snn.CONV_CHUNK, snn.CONV_CHUNK, 16]
    assert torch.equal(got, whole.permute(0, 2, 3, 1))
    del calls[:]
    snn._conv(x[:snn.CONV_CHUNK], w)
    assert calls == [snn.CONV_CHUNK]


@pytest.mark.cuda
@pytest.mark.parametrize("layer", ["conv1", "conv2"])
def test_conv_rows_do_not_depend_on_the_slot_count(card, layer):
    """At Table II width with 2**-8 weights, each stream's conv rows in a
    call of 1..32 slots (T=16 images a slot) equal its rows alone."""
    rng = np.random.default_rng(1)
    cfg, t = CONFIG, CONFIG.time_bins
    h, w = cfg.post_pool0
    if layer == "conv1":
        x = (torch.from_numpy(rng.random((32 * t, h, w, cfg.in_channels)))
             < 0.3).float()
        k = _dyadic(rng, cfg.conv1_features, cfg.in_channels, 3, 3)
    else:
        x = torch.from_numpy(rng.integers(
            0, 5, (32 * t, h // 2, w // 2, cfg.conv1_features))
            .astype(np.float32) / 4)
        k = _dyadic(rng, cfg.conv2_features, cfg.conv1_features, 3, 3)
    x, k = x.to(card), k.to(card)
    alone = torch.cat([snn._conv(x[i:i + t].contiguous(), k)
                       for i in range(0, x.shape[0], t)])
    for slots in (1, 3, 8, 9, 16, 32):
        got = snn._conv(x[:slots * t].contiguous(), k)
        assert torch.equal(got, alone[:slots * t]), slots


@pytest.mark.cuda
def test_capture_holds_off_the_collector(card):
    """Dead engines (cyclic garbage holding graphs, staging buffers and
    events) around, a capture runs with the collector off and turns it
    back on; the captured step's replay equals the eager call bit for
    bit. A collector that was off stays off."""
    rng = np.random.default_rng(17)
    params = _snn_params(rng)
    ws = _event_windows(rng, 2)
    key = (2, 2048, 300_000)
    gc.disable()
    try:
        for _ in range(3):
            eng = StreamEngine(params, CFG, EngineConfig(max_streams=2))
            eng.warmup([key])
            for i, win in enumerate(ws):
                eng.open(stream_id=i).submit(win)
            eng.run()
            del eng
    finally:
        gc.enable()
    loop = BatchedClosedLoop(params, CFG)
    run = loop._run
    seen = []

    def recording_run(*args):
        if torch.cuda.is_current_stream_capturing():
            seen.append(gc.isenabled())
        return run(*args)

    loop._run = recording_run
    loop.warmup([key])
    assert seen == [False] and gc.isenabled()
    gc.disable()
    try:
        loop.warmup([(2, 4096, 300_000)])
        assert not gc.isenabled()
    finally:
        gc.enable()
    assert seen == [False, False]
    del loop._run
    batch = loop.prepare(ws, batch_size=2)
    state = loop.init_state(2)
    (_, got), _ = loop.infer_dispatch(batch, state)
    args = loop._mega_args(batch, state)
    args = (args[0].to(loop.device), *args[1:])
    want = loop._build_run(key)(args)
    assert torch.equal(got, want[0])
