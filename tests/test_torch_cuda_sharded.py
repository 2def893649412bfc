"""Slot sharding on the card.

Two parts, marked ``cuda`` (each test asks a fixture that skips without
what it needs):

  * a logical mesh over ``cuda:0`` (2 and 4 shards on one card): the
    event and frame lanes served sharded equal the unsharded engine bit
    for bit (rows and carried state, pipeline depths 0 and 1); each shard
    holds exactly one captured graph per shape key the lane served, in a
    pool of its own, and every captured input of a shard's step, its
    weights and its block of the state sit on the shard's device;
  * real placement, skipped below 2 GPUs: a mesh of every visible card
    serves bit for bit the unsharded engine on ``cuda:0``, each shard's
    state block on its own card, and a step queues every shard's replay
    before the first collect.

Run on the GPU machine with ``PYTHONPATH=src python -m pytest -q
--noconftest tests/test_torch_cuda_sharded.py``. This file imports no JAX:
it compares the port with itself.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import TCN_SMOKE  # noqa: E402
from repro_torch.core import events as ev  # noqa: E402
from repro_torch.core import frames as fr  # noqa: E402
from repro_torch.core._api import EngineConfig  # noqa: E402
from repro_torch.core.engine import FrameTCNEngine  # noqa: E402
from repro_torch.core.graphs import CapturedStep  # noqa: E402
from repro_torch.core.pipeline import BatchedClosedLoop  # noqa: E402
from repro_torch.core.snn import SNNConfig  # noqa: E402
from repro_torch.core.tcn import init_tcn  # noqa: E402
from repro_torch.distributed import ShardedTensor, make_mesh  # noqa: E402
from repro_torch.serving import StreamEngine  # noqa: E402

pytestmark = pytest.mark.cuda

CFG = SNNConfig(height=32, width=32, time_bins=4, conv1_features=4,
                conv2_features=8, hidden=32, num_classes=11)
TCFG = TCN_SMOKE


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graphs and kernels run on the "
                    "card)")
    return torch.device("cuda", 0)


@pytest.fixture
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more GPUs (real placement of the shards)")
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def _dyadic(rng, *shape):
    w = rng.normal(size=shape) * 0.2
    return torch.from_numpy((np.round(w * 256) / 256).astype(np.float32))


def _params():
    rng = np.random.default_rng(3)
    return {"conv1": {"w": _dyadic(rng, 4, 2, 3, 3)},
            "conv2": {"w": _dyadic(rng, 8, 4, 3, 3)},
            "fc1": {"w": _dyadic(rng, CFG.flat_dim, 32)},
            "fc2": {"w": _dyadic(rng, 32, 11)}}


def _tparams():
    return init_tcn(torch.Generator().manual_seed(1), TCFG, device="cpu")


def _lanes(device, mesh, slots, depth):
    return StreamEngine(
        engines=[BatchedClosedLoop(_params(), CFG, device=device),
                 FrameTCNEngine(_tparams(), TCFG, device=device)],
        config=EngineConfig(max_streams=slots, pipeline_depth=depth,
                            mesh=mesh))


def _serve(eng, slots, seed=5):
    """slots + 2 event streams (every other one stateful) and slots frame
    streams, 2 windows each: rows by (stream, seq) and the stateful
    streams' exported carries."""
    rng = np.random.default_rng(seed)
    hs = {}
    for i in range(slots + 2):
        hs[f"e{i}"] = eng.open("event", stream_id=f"e{i}",
                               stateful=i % 2 == 0)
    for i in range(slots):
        hs[f"f{i}"] = eng.open("frame", stream_id=f"f{i}")
    for _ in range(2):
        for i in range(slots + 2):
            hs[f"e{i}"].submit(ev.synthetic_gesture_events(
                rng, i % 11, mean_events=1500, height=32, width=32))
        for i in range(slots):
            hs[f"f{i}"].submit(fr.synthetic_gesture_frames(
                rng, i % 11, height=32, width=32))
    rows = {(r.stream_id, r.seq): (r.result.label_pred, r.result.pwm,
                                   r.result.logits) for r in eng.run()}
    carries = {sid: h.checkpoint().state for sid, h in hs.items()
               if h.stateful}
    return rows, carries


def _assert_same(a, b):
    assert set(a[0]) == set(b[0])
    for key in a[0]:
        for x, y in zip(a[0][key], b[0][key]):
            np.testing.assert_array_equal(x, y, err_msg=str(key))
    for sid in a[1]:
        for k in a[1][sid]:
            np.testing.assert_array_equal(a[1][sid][k], b[1][sid][k])


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    return [t for sub in tree for t in _leaves(sub)]


@pytest.mark.parametrize("n", [2, 4])
def test_logical_mesh_matches_unsharded(card, n):
    slots = 8
    mesh = make_mesh(n, devices=[card] * n)
    for depth in (0, 1):
        want = _serve(_lanes(card, None, slots, depth), slots)
        eng = _lanes(card, mesh, slots, depth)
        _assert_same(want, _serve(eng, slots))
        for lane in eng._lanes.values():
            keys = lane.shape_keys
            assert keys and eng.compiled_shapes(lane.modality) == keys
            shards = lane.engine._shards
            assert len(shards) == n
            graphs = set()
            for sh in shards:
                assert sh.device == card
                assert set(sh.graphs.steps) == keys
                for step in sh.graphs.steps.values():
                    assert all(t.device == card for t in
                               _leaves(step.inputs))
                    graphs.add(id(step.graph))
                assert all(t.device == card for t in _leaves(sh.weights))
            assert len(graphs) == n * len(keys)
            assert len({id(sh.graphs) for sh in shards}) == n
        for plane in eng._lanes["event"].state.values():
            assert isinstance(plane, ShardedTensor)
            assert len({b.data_ptr() for b in plane.blocks}) == n


def test_real_placement_queues_every_shard_first(cards):
    n = len(cards)
    slots = 2 * n
    mesh = make_mesh(devices=cards)
    want = _serve(_lanes(cards[0], None, slots, 0), slots)
    eng = _lanes(cards[0], mesh, slots, 0)
    _assert_same(want, _serve(eng, slots))
    loop = eng.engines["event"]
    for sh, dev in zip(loop._shards, cards):
        assert sh.device == dev
        for step in sh.graphs.steps.values():
            assert all(t.device == dev for t in _leaves(step.inputs))
    state = eng._lanes["event"].state
    for plane in state.values():
        assert [b.device for b in plane.blocks] == cards

    order = []
    replay = CapturedStep.__call__

    def logged(self, args):
        order.append(("replay", torch.cuda.current_device()))
        return replay(self, args)

    collect = loop.infer_collect

    def logged_collect(pending):
        order.append(("collect", None))
        return collect(pending)

    CapturedStep.__call__ = logged
    loop.infer_collect = logged_collect
    try:
        rng = np.random.default_rng(9)
        batch = loop.prepare([ev.synthetic_gesture_events(
            rng, i % 11, mean_events=1500, height=32, width=32)
            for i in range(slots)], batch_size=slots)
        loop.infer(batch)
    finally:
        CapturedStep.__call__ = replay
        del loop.infer_collect
    assert order == [("replay", i) for i in range(n)] + [("collect", None)]
