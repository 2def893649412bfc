"""STBP training on the card, at SMOKE size, against the port's CPU run.

Marked ``cuda``: each test asks the ``card`` fixture, which skips without
a GPU (decided inside the fixture, never at import). On the H100 run them
with ``PYTHONPATH=src python -m pytest -q --noconftest
tests/test_torch_cuda_training.py`` (the suite's conftest imports jax).

  * (a) ``snn_loss`` on the card against the CPU, both modes, weights on
    the 2**-8 grid: loss, logits, output spikes and rates bit for bit
    (every current is exact; the log-softmax runs in float64), the four
    weight gradients within ``GRAD_RTOL`` of their largest magnitudes
    (their sums run in other orders);
  * (b) on the card, layer_serial against time_serial: loss and spikes
    bit for bit, gradients within ``GRAD_RTOL``, and the kernels a step
    launches, exactly;
  * (d) a whole step (forward, backward, ``adamw_update``) raises
    nothing under ``torch.cuda.set_sync_debug_mode("error")``;
  * and inside ``training.deterministic()`` two runs of the same steps
    give the same bits (cuDNN's default weight-gradient algorithms add
    with atomics).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.snn import (SNN_STATE_LAYERS, SNNConfig,  # noqa: E402
                                  init_snn, snn_apply)
from repro_torch.data import dvs_gesture_batch  # noqa: E402
from repro_torch.kernels import fc_lif_scan as k2  # noqa: E402
from repro_torch.kernels import lif_scan as k1  # noqa: E402
from repro_torch.training import (AdamWConfig, adamw_init,  # noqa: E402
                                  snn_grads, stbp_step)
from repro_torch.training.optimizer import tree_leaves  # noqa: E402

pytestmark = pytest.mark.cuda
CFG = SNNConfig(height=32, width=32, time_bins=8, conv1_features=4,
                conv2_features=8, hidden=32, num_classes=11)
DATA = dict(height=32, width=32, time_bins=8, mean_events=1500,
            num_classes=11)
MODES = ["time_serial", "layer_serial"]
# The same formulas with sums in other orders (cuDNN and cuBLAS against
# the CPU, per-step products against one over T): ~1e-6 of a gradient's
# largest magnitude at this size; a wrong term moves it by O(1).
GRAD_RTOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernels run on the card only)")
    return torch.device("cuda")


def _dyadic(params):
    return {k: {"w": torch.round(v["w"] * 256.0) / 256.0}
            for k, v in params.items()}


def _loss_grads(params, vox, labels, mode):
    loss, aux, grads = snn_grads(params, vox, labels, CFG, mode=mode)
    return loss, aux, {k: g["w"] for k, g in grads.items()}


def _close_to_max(want, got):
    for k in want:
        err = float((got[k].cpu() - want[k].cpu()).abs().max())
        assert err <= GRAD_RTOL * float(want[k].abs().max()), (k, err)


@pytest.mark.parametrize("mode", MODES)
def test_card_matches_cpu(card, mode):
    p_cpu = _dyadic(init_snn(0, CFG, device="cpu"))
    p_dev = {k: {"w": v["w"].to(card)} for k, v in p_cpu.items()}
    b_cpu = dvs_gesture_batch(4, 0, device="cpu", **DATA)
    b_dev = dvs_gesture_batch(4, 0, device=card, **DATA)
    assert torch.equal(b_dev.vox.cpu(), b_cpu.vox)
    want = _loss_grads(p_cpu, b_cpu.vox, b_cpu.labels, mode)
    got = _loss_grads(p_dev, b_dev.vox, b_dev.labels, mode)
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1]["logits"].cpu(), want[1]["logits"])
    for k in SNN_STATE_LAYERS:
        assert torch.equal(got[1]["firing_rates"][k].cpu(),
                           want[1]["firing_rates"][k])
    with torch.no_grad():
        s_cpu = snn_apply(p_cpu, b_cpu.vox, CFG, mode=mode)["out_spikes"]
        s_dev = snn_apply(p_dev, b_dev.vox, CFG, mode=mode)["out_spikes"]
    assert torch.equal(s_dev.cpu(), s_cpu)
    _close_to_max(want[2], got[2])
    assert all(float(g.abs().max()) > 0 for g in got[2].values())


def test_modes_agree_and_launch_counts(card):
    params = init_snn(1, CFG, device=card)
    b = dvs_gesture_batch(4, 1, device=card, **DATA)
    runs, counts = {}, {}
    for mode in MODES:
        torch.cuda.synchronize()
        before = (k1.launches, k2.launches, k2.currents_launches)
        runs[mode] = _loss_grads(params, b.vox, b.labels, mode)
        torch.cuda.synchronize()
        counts[mode] = tuple(a - c for a, c in zip(
            (k1.launches, k2.launches, k2.currents_launches), before))
    # time_serial: 2 currents launches a time step forward, none backward
    # (the plain products); layer_serial: K1 and K2 twice forward, the
    # currents entry twice backward (K2's recomputation of fc1 and fc2).
    assert counts == {"time_serial": (0, 0, 2 * CFG.time_bins),
                      "layer_serial": (2, 2, 2)}
    ts, ls = runs["time_serial"], runs["layer_serial"]
    assert torch.equal(ts[0], ls[0])
    assert torch.equal(ts[1]["logits"], ls[1]["logits"])
    with torch.no_grad():
        assert torch.equal(
            snn_apply(params, b.vox, CFG, mode="time_serial")["out_spikes"],
            snn_apply(params, b.vox, CFG, mode="layer_serial")["out_spikes"])
    _close_to_max(ts[2], ls[2])


def _step(params, opt, b, mode, ocfg):
    params, opt, loss, _ = stbp_step(params, opt, b.vox, b.labels, CFG,
                                     ocfg, mode=mode)
    return params, opt, loss


@pytest.mark.parametrize("mode", MODES)
def test_step_does_not_synchronize(card, mode):
    params = init_snn(2, CFG, device=card)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batches = [dvs_gesture_batch(4, s, device=card, **DATA)
               for s in range(2)]
    params, opt, _ = _step(params, opt, batches[0], mode, ocfg)   # warm
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        params, opt, loss = _step(params, opt, batches[1], mode, ocfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert np.isfinite(float(loss)) and int(opt["step"]) == 2


@pytest.mark.parametrize("mode", MODES)
def test_deterministic_steps_repeat_their_bits(card, mode):
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    batches = [dvs_gesture_batch(8, s, device=card, **DATA)
               for s in range(3)]
    runs = []
    for _ in range(2):
        params = init_snn(3, CFG, device=card)
        opt = adamw_init(params)
        for b in batches:
            params, opt, _ = _step(params, opt, b, mode, ocfg)
        runs.append(tree_leaves({"p": params, "o": opt}))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    assert torch.backends.cudnn.deterministic is False   # scoped
