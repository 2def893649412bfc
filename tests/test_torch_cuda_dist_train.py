"""Sharded LM training on the card: the scenarios of
``test_torch_dist_train.py`` (the SMOKE archs of ``torch_dist_workers``,
one of each family, in f32, B=4, S=16, 3 steps) with the ranks' tensors
on CUDA devices, against the port's one-device Trainer on the card, with
that file's tolerances (a), each step's gradient norm before clipping
included (a row counted twice moves it where clipping and AdamW would
hide it from the losses and moments).

Marked ``cuda``: each test asks the ``card`` fixture, which skips without
a GPU (decided inside the fixture, never at import). On the H100 run them
with ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda_dist_train.py``.

  * four ``gloo`` ranks sharing ``cuda:0`` (NCCL refuses two ranks on one
    device), the meshes of ``torch_dist_workers.MESHES`` ((2, 2), (4, 1),
    (1, 4) over ``("data", "model")``, (2, 2, 1) and (2, 1, 2) over
    ``("pod", "data", "model")``) and its batch cases (batches that do
    not divide ``data``, a 1-D ``("data",)`` mesh); K4 and zamba2's SSD
    run on every rank's rows and block of heads;
  * ``nccl`` with one rank a card, over 4 cards (the same meshes and
    cases) or 2 ((2, 1), (1, 2)); skipped below 2 cards.
"""
import json
import math
import pickle

import pytest

torch = pytest.importorskip("torch")

import torch_dist_workers as W  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.distributed import runtime as R  # noqa: E402

pytestmark = pytest.mark.cuda
LOSS_RTOL, M1_TOL, M3_TOL, PARAM1_TOL = 1e-6, 1e-5, 1e-4, 1e-3
GRAD_NORM_RTOL = 1e-5


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run on the card only)")
    from repro_torch.kernels import _build
    from repro_torch.kernels import wkv6_scan as k4
    _build.build_all([k4.KERNEL])     # once, before the ranks load it
    one = {(arch, W.BATCH): W.one_device(arch, device="cuda")
           for arch in W.ARCHS}
    one.update({(arch, b): W.one_device(arch, device="cuda", batch=b)
                for _, b in W.BATCH_MESHES for arch in W.BATCH_ARCHS})
    return one


def _spawn(tmp_path, backend, meshes):
    world = math.prod(meshes[0])
    R.spawn(W.train_rank, world, (R.free_port(), str(tmp_path), "cuda",
                                  backend, meshes))
    cases = [(a, m, W.BATCH) for m in meshes for a in W.ARCHS] + [
        (a, m, b) for m, b in W.BATCH_MESHES if math.prod(m) == world
        for a in W.BATCH_ARCHS]
    out = {}
    for arch, shape, batch in cases:
        case = W.case_name(arch, shape, batch)
        with open(tmp_path / f"{case}.pkl", "rb") as f:
            got = out[(arch, shape, batch)] = pickle.load(f)
        scans = [json.loads((tmp_path / f"wkv_{case}_{r}.json")
                            .read_text()) for r in range(world)]
        for key in ("wkv", "ssd"):
            got[key] = [x[key] for x in scans]
    return out


def _check(cases, one):
    import numpy as np
    for (arch, shape, batch), got in cases.items():
        ref = one[(arch, batch)]
        np.testing.assert_allclose(got["losses"], ref["losses"],
                                   rtol=LOSS_RTOL, err_msg=str(shape))
        np.testing.assert_allclose(got["grad_norms"], ref["grad_norms"],
                                   rtol=GRAD_NORM_RTOL, err_msg=str(shape))
        first = W.compare(got["params1"], got["m1"], ref["params1"],
                          ref["m1"], W.LR)
        last = W.compare(got["params"], got["m"], ref["params"], ref["m"],
                         W.LR)
        assert (first["m_rel"] <= M1_TOL
                and first["param_confident"] <= PARAM1_TOL
                and first["param_bounded"] <= 1.0
                and last["m_rel"] <= M3_TOL
                and last["param_bounded"] <= 1.0), (arch, shape, first, last)
        rows = batch // W.row_blocks(shape, batch)
        tp = W.sizes(shape).get("model", 1)
        if arch == "rwkv6-7b":
            cfg = get_config(arch, smoke=True)
            want = [[rows, W.SEQ, cfg.rwkv_heads // tp,
                     cfg.rwkv_head_dim]] * (cfg.num_layers * W.STEPS)
            assert all(calls == want for calls in got["wkv"]), shape
        if arch == W.MAMBA_ARCH:
            cfg = get_config(arch, smoke=True)
            want = [[rows, W.SEQ, cfg.ssm_heads // tp,
                     cfg.ssm_head_dim]] * (cfg.num_layers * W.STEPS)
            assert all(calls == want for calls in got["ssd"]), shape


def test_gloo_ranks_sharing_one_card(card, tmp_path):
    _check(_spawn(tmp_path, "gloo", W.MESHES), card)


def test_nccl_one_rank_a_card(card, tmp_path):
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("NCCL with one rank a card needs 2 or more cards")
    meshes = W.MESHES if n >= 4 else ((2, 1), (1, 2))
    _check(_spawn(tmp_path, "nccl", meshes), card)
