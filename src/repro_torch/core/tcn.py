"""The CUTIE ternary CNN: ColibriES's frame-wing inference network.

Port of ``repro.core.tcn``. Kraken's second accelerator, CUTIE, runs
fully ternary CNNs: {-1, 0, +1} weights and activations, with the final
classifier kept full precision. The network mirrors the Table II SCNN
layer for layer (pool4 -> conv16 -> pool2 -> conv32 -> pool2 -> fc ->
classifier), frames in instead of spike trains:

  * conv weights ternarized per output channel (:func:`pack_tcn`) and
    dequantized (``q * scale``) into a SAME 3x3 convolution;
  * fc1 stored 2-bit packed and run by kernel K3 through
    ``kernels.ops.ternary_matmul``;
  * activations hard-ternarized between layers, against a per-sample
    threshold;
  * per-stream density of non-zero operands reported beside the logits,
    the activity that drives CUTIE's switching energy per stream.

Layouts. Activations stay NHWC as in the JAX package, so fc1's packed
rows (NHWC flatten order) need no permutation; the convolution itself runs
NCHW with OIHW kernels (``repro_torch.convert.tcn_params_from_numpy``).

Row invariance. A frame's result must not depend on its batch. Every
reduction on the path is therefore written in a fixed order of
elementwise operations rather than left to a reduction kernel whose order
follows its launch shape: the pools add their k*k taps in row-major order,
the per-sample ``mean|x|`` of the activation threshold is a pairwise
halving sum over the row padded with zeros to a power of two, fc1 is K3's
segmented sum (ascending k within 512-k segments, the segments in
ascending order), and fc2 is the ascending-k sum of
``kernels.fc_lif_scan.fc_currents`` (exact products: ``s3`` is ternary),
one launch of K2's currents entry on the card.
The two convolutions are the one library call (cuDNN on the card);
``chip_smoke.py`` reports whether their rows keep the same bits across
batch sizes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

from repro_torch.core.snn import _conv, _he_init
from repro_torch.core.ternary import pairwise_sum, ternarize
from repro_torch.kernels import ops
from repro_torch.kernels.fc_lif_scan import fc_currents

__all__ = ["TCNConfig", "init_tcn", "pack_tcn", "tcn_apply",
           "tcn_layer_macs", "TCN_LAYERS"]

Params = Dict[str, Any]

# The layers whose operand activity is reported, in execution order.
TCN_LAYERS = ("conv1", "conv2", "fc1", "fc2")


@dataclasses.dataclass(frozen=True)
class TCNConfig:
    """Configuration of the CUTIE ternary CNN (reduced variants for tests)."""

    height: int = 128
    width: int = 128
    in_channels: int = 1
    pool0: int = 4            # cluster-side downsampling before conv1
    conv1_features: int = 16
    conv2_features: int = 32
    hidden: int = 512
    num_classes: int = 11
    # Activation ternarization threshold (fraction of each layer's mean
    # absolute pre-activation); CUTIE's inter-layer format is ternary.
    act_threshold: float = 0.7
    init_gain: float = 1.0

    @property
    def post_pool0(self) -> Tuple[int, int]:
        return self.height // self.pool0, self.width // self.pool0

    @property
    def flat_dim(self) -> int:
        h, w = self.post_pool0
        return (h // 4) * (w // 4) * self.conv2_features

    def spatial_sizes(self):
        """(H, W, C) after each stage, for the MAC/energy accounting."""
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


def tcn_layer_macs(cfg: TCNConfig) -> Tuple[float, ...]:
    """Dense MAC count per CUTIE layer (conv1, conv2, fc1, fc2).

    CUTIE executes the full dense schedule every frame, so latency is
    workload-independent; only switching energy varies with activity.
    """
    sizes = cfg.spatial_sizes()
    vol = lambda s: float(sizes[s][0] * sizes[s][1] * sizes[s][2])
    return (
        vol("conv1") * 9.0 * cfg.in_channels,
        vol("conv2") * 9.0 * cfg.conv1_features,
        float(cfg.flat_dim * cfg.hidden),
        float(cfg.hidden * cfg.num_classes),
    )


def init_tcn(generator, cfg: TCNConfig, dtype=torch.float32,
             device=None) -> Params:
    """He-init the float (pre-quantization) TCN parameters, as
    :func:`repro_torch.core.snn.init_snn` does (``snn._he_init``)."""
    return _he_init(generator, cfg, dtype, device)


def pack_tcn(params: Params) -> Params:
    """Quantize float TCN params (the port's layout: OIHW convs, (K, N)
    fc weights) into CUTIE's deployment format.

    Conv kernels become ``{"q": int8 OIHW, "scale": (O, 1, 1, 1)}`` (TWN
    per output channel); fc1 becomes K3's ``{"packed": (K//4, N) uint8,
    "scale": (N,) f32}``; the classifier fc2 stays full precision.
    """
    out: Params = {}
    for name in ("conv1", "conv2"):
        q, scale = ternarize(params[name]["w"], axis=0)
        out[name] = {"q": q, "scale": scale}
    packed, scale = ops.pack_ternary_weights(params["fc1"]["w"])
    out["fc1"] = {"packed": packed, "scale": scale}
    out["fc2"] = {"w": params["fc2"]["w"]}
    return out


def _avg_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """Average pool (N, H, W, C) by k with stride k: the k*k taps added in
    row-major order, then divided by k*k (the same bits on any device and
    at any batch size)."""
    n, h, w, c = x.shape
    x = x[:, :h // k * k, :w // k * k].reshape(n, h // k, k, w // k, k, c)
    acc = x[:, :, 0, :, 0]
    for i in range(k):
        for j in range(k):
            if i or j:
                acc = acc + x[:, :, i, :, j]
    return acc / float(k * k)


def _row_mean_abs(x: torch.Tensor) -> torch.Tensor:
    """Per-sample ``mean|x|`` over every non-batch axis, (B,): a
    :func:`pairwise_sum` of the row, divided by the true count."""
    a = x.abs().reshape(x.shape[0], -1)
    return pairwise_sum(a) / float(a.shape[1])


def _ternarize_act(x: torch.Tensor, threshold: float) -> torch.Tensor:
    """CUTIE inter-layer format: hard-ternarize against ``threshold *
    mean|x|`` per sample, so each batch row is ternarized on its own."""
    delta = (threshold * _row_mean_abs(x)).reshape(-1, *([1] * (x.ndim - 1)))
    return torch.sign(x) * (x.abs() > delta).to(x.dtype)


def _ternary_conv(x: torch.Tensor, layer: Params) -> torch.Tensor:
    """SAME 3x3 conv with dequantized ternary weights (``q * scale``):
    NHWC activations x OIHW kernel -> NHWC, as the SNN's convs."""
    return _conv(x, layer["q"].to(x.dtype) * layer["scale"].to(x.dtype))


def _density(s: torch.Tensor) -> torch.Tensor:
    """Per-stream fraction of non-zero operands, (B,): a count (exact in
    any order) over the row size."""
    dims = tuple(range(1, s.ndim))
    return (s != 0).float().sum(dim=dims) / float(s[0].numel())


def tcn_apply(packed: Params, frames: torch.Tensor, cfg: TCNConfig
              ) -> Dict[str, Any]:
    """Run the CUTIE TCN on normalized frames.

    Args:
      packed: deployment params from :func:`pack_tcn` (or
        :func:`repro_torch.convert.tcn_params_from_numpy` of JAX's
        ``pack_tcn`` output).
      frames: (B, H, W, C) float frames in [-1, 1]
        (see :func:`repro_torch.core.frames.normalize_frames`).

    Returns:
      dict with ``logits`` (B, num_classes), ``activity_per_stream`` --
      per-layer (B,) densities of the non-zero operands entering each
      layer -- and ``activations``, the ternary outputs of conv1, conv2
      and fc1 (for comparing runs).
    """
    thr = cfg.act_threshold
    x0 = _avg_pool(frames, cfg.pool0)
    s1 = _ternarize_act(_ternary_conv(x0, packed["conv1"]), thr)
    s2 = _ternarize_act(_ternary_conv(_avg_pool(s1, 2), packed["conv2"]),
                        thr)
    # NHWC flatten: the row order of fc1's packed weights. Every value is
    # a multiple of 1/4 in [-1, 1], so K3's sums are exact.
    flat = _avg_pool(s2, 2).reshape(frames.shape[0], -1)
    h = ops.ternary_matmul(flat, packed["fc1"]["packed"],
                           packed["fc1"]["scale"])
    s3 = _ternarize_act(h, thr)
    logits = fc_currents(s3, packed["fc2"]["w"])
    return {
        "logits": logits,
        "activity_per_stream": {
            "conv1": _density(x0), "conv2": _density(s1),
            "fc1": _density(s2), "fc2": _density(s3),
        },
        "activations": {"conv1": s1, "conv2": s2, "fc1": s3},
    }
