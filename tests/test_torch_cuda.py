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
from repro_torch.core._api import EngineConfig  # noqa: E402
from repro_torch.core.lif import LIFParams  # noqa: E402
from repro_torch.core.snn import SNNConfig  # noqa: E402
from repro_torch.kernels import fc_lif_scan as k2  # noqa: E402
from repro_torch.kernels import lif_scan as k1  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.serving import StreamEngine  # noqa: E402

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
def test_k1_matches_plain(card, dtype):
    g = torch.Generator().manual_seed(0)
    cur = (torch.randn(16, 8, 32, 32, 16, generator=g) * 0.6 + 0.3).to(dtype)
    v0 = torch.rand(8, 32, 32, 16, generator=g) * 1.4 - 0.2
    for v in (None, v0):
        want = k1.lif_scan_plain(cur.to(card), P,
                                 None if v is None else v.to(card))
        got = k1.lif_scan_cuda(cur.to(card), P,
                               None if v is None else v.to(card))
        assert _same(want, got)


def test_k2_matches_plain_and_rows_are_batch_invariant(card):
    g = torch.Generator().manual_seed(1)
    s = (torch.randint(0, 5, (16, 8, 256), generator=g) / 4.0).to(card)
    w = (torch.randn(256, 40, generator=g) * 0.1).to(card)
    v0 = torch.rand(8, 40, generator=g).to(card)
    want = k2.fc_lif_scan_plain(s, w, P, v0)
    got = k2.fc_lif_scan_cuda(s, w, P, v0)
    assert _same(want, got)
    one = k2.fc_lif_scan_cuda(s[:, 3:4].contiguous(), w, P, v0[3:4])
    assert torch.equal(one[0][:, 0], got[0][:, 3])
    assert torch.equal(one[1][0], got[1][3])


def test_ops_count_launches_on_the_card(card):
    before = (k1.launches, k2.launches)
    ops.lif_scan(torch.rand(4, 64, device=card), P)
    ops.fc_lif_scan(torch.rand(4, 2, 32, device=card),
                    torch.rand(32, 8, device=card), P)
    assert (k1.launches, k2.launches) == (before[0] + 1, before[1] + 1)


def test_default_stream_engine_launches_both_kernels(card):
    """A StreamEngine built with no device, no config and no kernel
    arguments serves on the card through K1 and K2: two launches of each
    per engine step."""
    cfg = SNNConfig(height=32, width=32, time_bins=4, conv1_features=4,
                    conv2_features=8, hidden=32, num_classes=11)
    rng = np.random.default_rng(0)
    mk = lambda *s: torch.from_numpy(
        (rng.normal(size=s) * 0.5).astype(np.float32))
    params = {"conv1": {"w": mk(4, 2, 3, 3)}, "conv2": {"w": mk(8, 4, 3, 3)},
              "fc1": {"w": mk(cfg.flat_dim, 32)}, "fc2": {"w": mk(32, 11)}}
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
    assert len(out) == 6 and steps >= 1
    assert (k1.launches - before[0], k2.launches - before[1]) == \
        (2 * steps, 2 * steps)
