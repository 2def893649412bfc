"""The ColibriES DVS-Gesture spiking CNN (paper Table II), in PyTorch.

Port of ``repro.core.snn``:

    0 Input  128x128x2
    1 Pool   4x4 stride 4        -> 32x32x2
    2 Conv   3x3, 16 features    -> 32x32x16   + LIF
    3 Pool   2x2 stride 2        -> 16x16x16
    4 Conv   3x3, 32 features    -> 16x16x32   + LIF
    5 Pool   2x2 stride 2        -> 8x8x32
    6 Full   2048 -> 512                        + LIF
    7 Full   512  -> 11                         + LIF (spike-count readout)

Layouts. Activations, spikes and the carried state planes stay NHWC as in
the JAX package, so exported carries match JAX's and fc1's weight rows (in
NHWC flatten order) need no permutation. Only the convolution itself runs
NCHW with OIHW kernels (``repro_torch.convert`` turns JAX's HWIO kernels
into OIHW); the activation is permuted in and back around it.

Kernels. ``layer_serial`` is the serving path: conv1 and conv2 scan through
``kernels.ops.lif_scan`` (K1) and fc1 and fc2 through
``kernels.ops.fc_lif_scan`` (K2), each of which launches its kernel on a
CUDA tensor and runs its plain version on a CPU tensor. The JAX package's
unfused fc path (``fuse_fc=False``: currents, then the scan) computes the
same function as K2 here, so the port has the fused path only.
``time_serial`` is the STBP view, the training default, on the card and
the CPU: its fc currents are ``kernels.ops.fc_currents`` (2 launches of
K2's currents entry a time step on the card, the plain loop on the CPU,
and the two plain products backward). Under autograd both modes'
kernels run forward, and the backward recomputes their plain references
(``kernels/ops.py``).

Numerics. Pools are sum/(k*k), exact on spikes. An fc current is the
ascending-k f32 sum of ``repro_torch.kernels.fc_lif_scan.fc_currents`` in
both modes, so ``layer_serial`` and ``time_serial`` give the same bits.
Rates and readouts are sums divided by a count, as ``jnp.mean`` computes
them, the quotient rounded once on the card too (``_div``);
``time_serial`` adds its per-step rates in ascending t, and the mean
over streams is a :func:`~repro_torch.core.ternary.pairwise_sum`, so no
rate depends on a device's reduction order. The loss's
log-softmax runs in float64 and rounds once to float32, so the card and
the CPU, whose float32 ``exp`` and ``log`` differ in the last bit, give
the same loss.

Training. :func:`init_snn` draws He-init weights on a CPU
``torch.Generator`` (conv kernels OIHW) and places them on the device,
so one seed gives the same weights on the card and the CPU; it cannot
repeat ``jax.random``'s draws, so comparisons with the JAX package carry
its weights across with ``repro_torch.convert.snn_params_from_numpy``.
:func:`snn_loss` is the STBP cross-entropy on the spike-count readout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.core.lif import LIFParams, lif_step, spike_surrogate
from repro_torch.core.ternary import pairwise_sum
from repro_torch.kernels import ops

__all__ = ["SNNConfig", "init_snn", "snn_init_state", "snn_apply",
           "snn_logits", "snn_loss", "SNN_STATE_LAYERS"]

Params = Dict[str, Any]

# The LIF layers whose membrane is carried state, in execution order.
SNN_STATE_LAYERS = ("conv1", "conv2", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class SNNConfig:
    """Configuration of the Table II SCNN (reduced variants for tests)."""

    height: int = 128
    width: int = 128
    in_channels: int = 2
    pool0: int = 4           # layer 1: 4x4 stride 4
    conv1_features: int = 16
    conv2_features: int = 32
    hidden: int = 512
    num_classes: int = 11
    time_bins: int = 16
    lif: LIFParams = LIFParams()
    readout: str = "spike_count"   # or "membrane"
    # Init gain keeps deep LIF layers out of the silent regime: 2.0 with
    # v_th=0.5 and surrogate width 2.0 gives 10-30% firing rates at init.
    init_gain: float = 2.0

    @property
    def post_pool0(self) -> Tuple[int, int]:
        return self.height // self.pool0, self.width // self.pool0

    @property
    def flat_dim(self) -> int:
        h, w = self.post_pool0
        return (h // 4) * (w // 4) * self.conv2_features

    def spatial_sizes(self):
        """(H, W, C) after each stage, for the tiling planner / energy model."""
        h0, w0 = self.post_pool0
        return {
            "input": (self.height, self.width, self.in_channels),
            "pool0": (h0, w0, self.in_channels),
            "conv1": (h0, w0, self.conv1_features),
            "pool1": (h0 // 2, w0 // 2, self.conv1_features),
            "conv2": (h0 // 2, w0 // 2, self.conv2_features),
            "pool2": (h0 // 4, w0 // 4, self.conv2_features),
            "fc1": (1, 1, self.hidden),
            "fc2": (1, 1, self.num_classes),
        }


def _he_init(generator, cfg, dtype=torch.float32, device=None) -> Params:
    """:func:`init_snn`'s draws for any ``cfg`` with the four layers'
    widths and ``init_gain`` (the TCN's too: ``tcn.init_tcn``)."""
    dev = resolve_device(device)
    gen = generator
    if not isinstance(gen, torch.Generator):
        gen = torch.Generator().manual_seed(int(generator))
    c_in, f1, f2 = cfg.in_channels, cfg.conv1_features, cfg.conv2_features
    shapes = {"conv1": ((f1, c_in, 3, 3), 9 * c_in),
              "conv2": ((f2, f1, 3, 3), 9 * f1),
              "fc1": ((cfg.flat_dim, cfg.hidden), cfg.flat_dim),
              "fc2": ((cfg.hidden, cfg.num_classes), cfg.hidden)}
    out = {}
    for name, (shape, fan_in) in shapes.items():
        w = torch.randn(shape, generator=gen, dtype=torch.float32)
        w = w * (cfg.init_gain * math.sqrt(2.0 / fan_in))
        out[name] = {"w": w.to(dtype=dtype, device=dev)}
    return out


def init_snn(generator, cfg: SNNConfig, dtype=torch.float32,
             device=None) -> Params:
    """He-init the SCNN parameters: conv kernels OIHW, fc weights (K, N)
    with fc1's rows in NHWC flatten order.

    Normal draws for conv1, conv2, fc1 and fc2 in that order from a CPU
    ``torch.Generator`` (or an int seed), each scaled by ``init_gain *
    sqrt(2 / fan_in)``, then cast to ``dtype`` and placed on
    ``repro_torch.resolve_device(device)`` (the card by default), so one
    seed gives the same weights on every device.
    """
    return _he_init(generator, cfg, dtype, device)


def snn_init_state(cfg: SNNConfig, batch_size: int,
                   dtype=torch.float32,
                   device=None) -> Dict[str, torch.Tensor]:
    """The zero carried state for ``batch_size`` streams: one slot-major
    (B, ...) membrane plane per LIF layer, NHWC for the conv layers.
    Zero membrane is the cold start, so it gives the same bits as
    ``state=None``."""
    h0, w0 = cfg.post_pool0
    z = lambda *shape: torch.zeros((batch_size, *shape), dtype=dtype,
                                   device=device)
    return {
        "conv1": z(h0, w0, cfg.conv1_features),
        "conv2": z(h0 // 2, w0 // 2, cfg.conv2_features),
        "fc1": z(cfg.hidden),
        "fc2": z(cfg.num_classes),
    }


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Average pool (N, H, W, C) by k with stride k: sum / (k*k)."""
    n, h, w, c = x.shape
    x = x[:, :h // k * k, :w // k * k]
    s = x.reshape(n, h // k, k, w // k, k, c).sum(dim=(2, 4))
    return s / float(k * k)


# Images a conv call takes at most. cuDNN picks its algorithm by the
# batch size: on an H100 it gives conv1's rows of 256 images (16 slots of
# T=16) other bits than the same images alone (an algorithm that rounds
# inside the sum, where a GEMM's sum of 2**-8-grid products is exact),
# while every call of 16..128 images gives the same rows. Larger batches
# are convolved in chunks of this many images, so a row's bits do not
# depend on how many slots a lane has.
CONV_CHUNK = 128


def _conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv: NHWC activations x OIHW kernel -> NHWC, at most
    ``CONV_CHUNK`` images a call."""
    pad = w.shape[-1] // 2
    x = x.permute(0, 3, 1, 2)
    if x.shape[0] <= CONV_CHUNK:
        y = F.conv2d(x, w, padding=pad)
    else:
        y = torch.cat([F.conv2d(c, w, padding=pad)
                       for c in x.split(CONV_CHUNK)])
    return y.permute(0, 2, 3, 1).contiguous()


def _pool_flat(s: torch.Tensor) -> torch.Tensor:
    """conv2 spikes (N, h, w, c) -> pooled and flattened (N, flat_dim) in
    NHWC order, the row order of fc1's weights."""
    pooled = _avg_pool(s, 2)
    return pooled.reshape(pooled.shape[0], -1)


def _div(x: torch.Tensor, n: int) -> torch.Tensor:
    """``x / n`` rounded once on every device. CUDA divides by a Python
    scalar as a product with its rounded reciprocal (one rounding more,
    an ulp off the CPU's quotient where ``n`` is not a power of two), so
    ``n`` goes in as a 0-d tensor on ``x``'s device."""
    return x / torch.full((), float(n), dtype=x.dtype, device=x.device)


def _rate(s: torch.Tensor, batch_axis: int) -> torch.Tensor:
    """Per-stream mean firing rate: sum over every other axis, divided by
    the count. Spike sums are exact, so this is batch-size invariant."""
    axes = tuple(a for a in range(s.ndim) if a != batch_axis)
    count = s.numel() // s.shape[batch_axis]
    return _div(s.float().sum(dim=axes), count)


def snn_apply(
    params: Params,
    vox: torch.Tensor,
    cfg: SNNConfig,
    *,
    mode: str = "time_serial",
    state: Dict[str, torch.Tensor] | None = None,
) -> Dict[str, Any]:
    """Run the SCNN on a voxelized spike batch.

    Args:
      params: ``{"conv1": {"w": OIHW}, "conv2": {"w": OIHW},
        "fc1": {"w": (K, N)}, "fc2": {"w": (K, N)}}`` (see
        :func:`repro_torch.convert.snn_params_from_numpy`).
      vox: (B, T, 2, H, W) float spikes (from ``events.voxelize_batch``).
      mode: ``time_serial`` (STBP view; CUDA and CPU tensors) or
        ``layer_serial`` (SNE view: K1 for the conv scans, K2 for fc1/fc2,
        which is the JAX package's ``fuse_fc=True``).
      state: optional per-layer (B, ...) membranes from
        :func:`snn_init_state` or a previous call's ``out["state"]``; the
        initial spikes are implied by the membrane (``s0 = v0 >= v_th``),
        so W chained windows give the bits of one uninterrupted run.

    Returns:
      dict with ``out_spikes`` (B, T, num_classes), ``out_membrane``
      (B, T, num_classes; zeros in layer_serial mode), ``firing_rates``
      (per-layer scalars), ``firing_rates_per_stream`` (per-layer (B,))
      and ``state`` (per-layer (B, ...) final membranes).
    """
    b, t = vox.shape[0], vox.shape[1]
    x = vox.permute(1, 0, 3, 4, 2)  # (T, B, H, W, C)
    lif = cfg.lif
    w1, w2 = params["conv1"]["w"], params["conv2"]["w"]
    wf1, wf2 = params["fc1"]["w"], params["fc2"]["w"]

    def i1(x_t):  # (N, H, W, 2) input spikes -> conv1 currents
        return _conv(_avg_pool(x_t, cfg.pool0), w1)

    def i2(s1):   # conv1 spikes -> conv2 currents
        return _conv(_avg_pool(s1, 2), w2)

    if mode == "time_serial":
        if vox.device.type not in ("cpu", "cuda"):
            raise ValueError(f"mode='time_serial' runs on CUDA or CPU "
                             f"tensors, got {vox.device}")
        if state is None:
            state = snn_init_state(cfg, b, vox.dtype, vox.device)
        carry = []
        for name in SNN_STATE_LAYERS:
            v = state[name].float()
            carry.append((v, spike_surrogate(v, lif.v_th,
                                             lif.surrogate_width
                                             ).to(vox.dtype)))
        (v1, s1), (v2, s2), (v3, s3), (v4, s4) = carry
        out_s, out_v = [], []
        rates = 0.0
        for x_t in x:
            v1, s1 = lif_step(v1, s1, i1(x_t), lif)
            v2, s2 = lif_step(v2, s2, i2(s1), lif)
            v3, s3 = lif_step(v3, s3, ops.fc_currents(_pool_flat(s2), wf1),
                              lif)
            v4, s4 = lif_step(v4, s4, ops.fc_currents(s3, wf2), lif)
            out_s.append(s4)
            out_v.append(v4)
            rates = rates + torch.stack([_rate(s, 0)
                                         for s in (s1, s2, s3, s4)])
        out_spikes = torch.stack(out_s, dim=1)         # (B, T, classes)
        out_membrane = torch.stack(out_v, dim=1)
        r1, r2, r3, r4 = _div(rates, t)
        state_out = {"conv1": v1, "conv2": v2, "fc1": v3, "fc2": v4}
    elif mode == "layer_serial":
        v0 = lambda name: None if state is None else state[name]
        flat = lambda a: a.reshape(t * b, *a.shape[2:])
        unflat = lambda a: a.reshape(t, b, *a.shape[1:])
        # conv1 and conv2: currents for all T at once, then the scan (K1).
        s1, vf1 = ops.lif_scan(unflat(i1(flat(x))), lif, v0("conv1"))
        s2, vf2 = ops.lif_scan(unflat(i2(flat(s1))), lif, v0("conv2"))
        z = unflat(_pool_flat(flat(s2)))                  # (T, B, flat_dim)
        # fc1 and fc2: synapse and scan fused (K2).
        s3, vf3 = ops.fc_lif_scan(z, wf1, lif, v0("fc1"))
        s4, vf4 = ops.fc_lif_scan(s3, wf2, lif, v0("fc2"))
        out_spikes = s4.transpose(0, 1)
        out_membrane = torch.zeros_like(out_spikes)  # not tracked here
        r1, r2, r3, r4 = (_rate(s, 1) for s in (s1, s2, s3, s4))
        state_out = {"conv1": vf1, "conv2": vf2, "fc1": vf3, "fc2": vf4}
    else:
        raise ValueError(f"unknown mode: {mode}")

    per_stream = {"conv1": r1, "conv2": r2, "fc1": r3, "fc2": r4}
    return {
        "out_spikes": out_spikes,
        "out_membrane": out_membrane,
        "firing_rates": dict(zip(per_stream, _div(pairwise_sum(
            torch.stack(list(per_stream.values()))), b))),
        "firing_rates_per_stream": per_stream,
        "state": state_out,
    }


def snn_logits(outputs: Dict[str, torch.Tensor],
               cfg: SNNConfig) -> torch.Tensor:
    """Readout: spike-count (hardware-faithful) or mean-membrane logits,
    the mean over T taken as a sum divided by T."""
    key = "out_spikes" if cfg.readout == "spike_count" else "out_membrane"
    s = outputs[key].float()
    return _div(s.sum(dim=1), s.shape[1])


def snn_loss(
    params: Params,
    vox: torch.Tensor,
    labels: torch.Tensor,
    cfg: SNNConfig,
    *,
    mode: str = "time_serial",
) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """STBP cross-entropy loss on readout logits. Returns (loss, aux).

    The readout (spike counts in [0, 1]) is scaled by 10 for a usable
    softmax temperature, as in the JAX package. The log-softmax, the
    label gather and the batch mean run in float64 and round once to
    float32 (see the module's Numerics). ``aux`` holds ``accuracy``,
    ``firing_rates`` and ``logits``, detached (JAX's ``has_aux``); argmax
    ties go to the first index, as ``jnp.argmax``'s do.
    """
    out = snn_apply(params, vox, cfg, mode=mode)
    logits = snn_logits(out, cfg) * 10.0
    labels = labels.long()
    logp = torch.log_softmax(logits.double(), dim=-1)
    loss = -logp.gather(-1, labels[:, None]).mean().float()
    hits = (logits.argmax(-1) == labels).float().sum()
    acc = _div(hits, labels.shape[0])
    rates = {k: v.detach() for k, v in out["firing_rates"].items()}
    return loss, {"accuracy": acc, "firing_rates": rates,
                  "logits": logits.detach()}
