"""What the PyTorch/CUDA port's examples share: their flags, their sizes
and their weights.

Every ``examples/torch_*.py`` takes ``--device`` (the card by default,
``cpu`` to run without one) and ``--smoke`` (the JAX examples' reduced
networks and event counts, a few seconds on the CPU; without it the
event and frame wings run the paper's full Table II widths). Weights are
drawn from a numpy seed in the JAX package's layout (HWIO convs) and
carried across with :mod:`repro_torch.convert`, so the JAX package can
be handed the same numbers:

  * SNN weights are He-init rounded to multiples of 2**-8: spikes are 0
    or 1, so every conv and fc current is then exact in f32 whatever
    the order of its sum, and the event wing's spikes, logits and labels
    are the same bits on the card, on the CPU and in the JAX package;
  * TCN weights are float He-init: each package ternarizes and packs
    them itself;
  * LM weights follow the model's own parameter declarations (the init
    laws of ``repro_torch.models.params``), drawn with numpy.

The examples import this module by name, so run them from the repository
root as ``python examples/torch_<name>.py`` (the script's directory is
then on the import path).
"""
from __future__ import annotations

import argparse
import math
import time
from typing import Any, Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import CONFIG, SMOKE, TCN_CONFIG, TCN_SMOKE
from repro_torch.convert import (lm_params_from_numpy, snn_params_from_numpy,
                                 tcn_params_from_numpy)
from repro_torch.core import events as ev
from repro_torch.core import frames as fr
from repro_torch.core._api import EngineConfig
from repro_torch.core.engine import FrameTCNEngine
from repro_torch.core.pipeline import BatchedClosedLoop
from repro_torch.models.params import as_dtype, tree_map
from repro_torch.serving import StreamEngine

__all__ = ["parser", "sizes", "np_snn_params", "snn_params",
           "np_tcn_params", "tcn_params", "np_lm_params", "lm_params",
           "clock", "row", "Wings"]


def parser(doc: str) -> argparse.ArgumentParser:
    """The examples' common flags: ``--device`` and ``--smoke``."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' to run "
                         "without one)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced networks and event counts of the "
                         "JAX package's examples (seconds on the CPU)")
    return ap


def sizes(smoke: bool, smoke_events: int) -> Dict[str, Any]:
    """The event network, the frame network and the mean events of a
    window: SMOKE sizes (32x32 sensor crop, ``smoke_events``: the JAX
    example's count) or the paper's Table II widths (128x128, ~60k
    events)."""
    if smoke:
        return {"snn": SMOKE, "tcn": TCN_SMOKE, "events": smoke_events}
    return {"snn": CONFIG, "tcn": TCN_CONFIG, "events": 60_000}


def _he(rng, shape, fan_in, gain, dyadic):
    w = rng.normal(size=shape) * gain * np.sqrt(2.0 / fan_in)
    if dyadic:
        w = np.round(w * 256.0) / 256.0
    return w.astype(np.float32)


def _np_cnn(cfg, seed, dyadic):
    rng = np.random.default_rng(seed)
    g = cfg.init_gain
    return {
        "conv1": {"w": _he(rng, (3, 3, cfg.in_channels, cfg.conv1_features),
                           9 * cfg.in_channels, g, dyadic)},
        "conv2": {"w": _he(rng, (3, 3, cfg.conv1_features,
                                 cfg.conv2_features),
                           9 * cfg.conv1_features, g, dyadic)},
        "fc1": {"w": _he(rng, (cfg.flat_dim, cfg.hidden), cfg.flat_dim, g,
                         dyadic)},
        "fc2": {"w": _he(rng, (cfg.hidden, cfg.num_classes), cfg.hidden, g,
                         dyadic)},
    }


def np_snn_params(cfg, seed: int = 0) -> Dict[str, Dict[str, np.ndarray]]:
    """He-init SNN weights (HWIO convs) rounded to 2**-8, as numpy."""
    return _np_cnn(cfg, seed, dyadic=True)


def snn_params(cfg, seed: int = 0):
    """:func:`np_snn_params` as the port's CPU tensors (OIHW convs)."""
    return snn_params_from_numpy(np_snn_params(cfg, seed))


def np_tcn_params(cfg, seed: int = 1) -> Dict[str, Dict[str, np.ndarray]]:
    """Float He-init TCN weights (HWIO convs), as numpy."""
    return _np_cnn(cfg, seed, dyadic=False)


def tcn_params(cfg, seed: int = 1):
    """:func:`np_tcn_params` as the port's CPU tensors; the frame engine
    ternarizes and packs them."""
    return tcn_params_from_numpy(np_tcn_params(cfg, seed))


def np_lm_params(model, seed: int = 0) -> Dict[str, Any]:
    """An LM's parameters drawn with numpy from its declarations: the
    ``normal`` law is N(0, 1) times ``scale / sqrt(fan_in)``, the others
    fill; float32, in the layout both packages share."""
    rng = np.random.default_rng(seed)

    def draw(d):
        if d.init == "zeros":
            return np.zeros(d.shape, np.float32)
        if d.init == "ones":
            return np.ones(d.shape, np.float32)
        if d.init == "constant":
            return np.full(d.shape, d.constant, np.float32)
        fan_axes = d.fan_in_axes or tuple(range(len(d.shape) - 1))
        fan_in = max(math.prod(d.shape[a] for a in fan_axes), 1)
        return (rng.normal(size=d.shape) * (d.scale / math.sqrt(fan_in))
                ).astype(np.float32)

    return tree_map(draw, model.defs())


def lm_params(model, seed: int = 0, device=None):
    """:func:`np_lm_params` as tensors of the model's dtype on
    ``device``."""
    dev, dtype = resolve_device(device), as_dtype(model.cfg.dtype)
    return tree_map(lambda t: t.to(dev, dtype),
                    lm_params_from_numpy(np_lm_params(model, seed)))


def clock(device) -> float:
    """``time.perf_counter()`` after the card's queued work (nothing to
    wait for on the CPU), so a clock read covers the work."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter()


def row(r) -> Dict[str, Any]:
    """A served ``StreamResult`` as the figures an example returns."""
    return {"stream": r.stream_id, "seq": r.seq, "modality": r.modality,
            "label": int(r.result.label_pred[0]),
            "pwm": r.result.pwm[0].tolist(),
            "latency_ms": r.result.latency_ms,
            "energy_mj": r.result.energy_mj}


class Wings:
    """The two-wing sensor head of the fusion examples: both wings'
    networks, weights and device, fresh engines over them, and the
    paired windows of its ticks (the JAX examples' ``sensor_head``)."""

    def __init__(self, smoke, device):
        sz = sizes(smoke, smoke_events=4000)
        self.scfg, self.tcfg, self.events = sz["snn"], sz["tcn"], \
            sz["events"]
        self.snn, self.tcn = snn_params(self.scfg), tcn_params(self.tcfg)
        self.device = device

    def event(self):
        return BatchedClosedLoop(self.snn, self.scfg, device=self.device)

    def frame(self):
        return FrameTCNEngine(self.tcn, self.tcfg, device=self.device)

    def engine(self, **config):
        """One StreamEngine serving both wings (a fresh 'process')."""
        config.setdefault("max_streams", {"event": 1, "frame": 1})
        return StreamEngine(engines=[self.event(), self.frame()],
                            config=EngineConfig(**config))

    def head(self, rng, k):
        """One control tick's paired windows from the combined head."""
        label = k % self.scfg.num_classes
        return (ev.synthetic_gesture_events(
                    rng, label, mean_events=self.events,
                    height=self.scfg.height, width=self.scfg.width),
                fr.synthetic_gesture_frames(
                    rng, label, height=self.tcfg.height,
                    width=self.tcfg.width))

    def ticks(self, seed, n):
        """``n`` ticks of the head from a numpy generator seeded ``seed``."""
        rng = np.random.default_rng(seed)
        return [self.head(rng, k) for k in range(n)]
