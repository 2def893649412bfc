"""Deterministic synthetic data pipelines (LM tokens + DVS gesture events).

Port of ``repro.data.synthetic``. Both pipelines take an explicit cursor
(the step index) and draw from the JAX package's numpy generators with
its seeds (``1234 + step`` for tokens, ``999 + step`` for gestures), so a
restart reproduces the same batch sequence and the two packages see the
same data. Batches are tensors on ``repro_torch.resolve_device(device)``
(the card by default); tokens, targets and labels are int64, the index
dtype of ``gather`` and embeddings.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import events as ev

__all__ = ["TokenTaskConfig", "token_batch", "token_stream",
           "dvs_gesture_batch", "DVSBatch"]


# ----------------------------------------------------------------------
# LM toy task: second half of each sequence copies the first half through
# a fixed permutation, with a loss floor well below the uniform baseline.
# ----------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TokenTaskConfig:
    vocab_size: int = 256
    seq_len: int = 64
    batch_size: int = 8
    task: str = "copy_map"   # "copy_map" (harder) | "repeat" (trivial)


def token_batch(cfg: TokenTaskConfig, step: int,
                device=None) -> Dict[str, torch.Tensor]:
    """Deterministic batch for a given step index (the cursor):
    ``{"tokens", "targets"}`` (B, S) int64, targets -1 where unscored."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1234 + step)
    if cfg.task == "repeat":
        # One token repeated per sequence: after position 0 the next token
        # is fully determined.
        tok = rng.integers(2, cfg.vocab_size, size=(cfg.batch_size, 1),
                           dtype=np.int64)
        toks = np.repeat(tok, cfg.seq_len, axis=1)
        targets = toks.copy()
        targets[:, 0] = -1
    else:
        half = cfg.seq_len // 2
        first = rng.integers(2, cfg.vocab_size,
                             size=(cfg.batch_size, half), dtype=np.int64)
        perm = (first * 7 + 3) % cfg.vocab_size        # fixed learnable map
        toks = np.concatenate([first, perm], axis=1)
        targets = toks.copy()
        targets[:, :half + 1] = -1                     # score the copy half
    return {"tokens": torch.from_numpy(toks).to(dev),
            "targets": torch.from_numpy(targets).to(dev)}


def token_stream(cfg: TokenTaskConfig, start_step: int = 0, device=None
                 ) -> Iterator[Tuple[int, Dict[str, torch.Tensor]]]:
    dev = resolve_device(device)
    step = start_step
    while True:
        yield step, token_batch(cfg, step, dev)
        step += 1


# ----------------------------------------------------------------------
# DVS-Gesture-like event batches for the SNN (paper wing).
# ----------------------------------------------------------------------


@dataclasses.dataclass
class DVSBatch:
    vox: torch.Tensor       # (B, T, 2, H, W) float32
    labels: torch.Tensor    # (B,) int64
    num_events: np.ndarray  # (B,) raw event counts (energy model driver)


def dvs_gesture_batch(
    batch_size: int, step: int, *,
    height: int = 128, width: int = 128, time_bins: int = 16,
    mean_events: int = 60_000, num_classes: int = 11,
    duration_us: int = 300_000, device=None,
) -> DVSBatch:
    """Deterministic synthetic gesture batch (cursor = step index): the
    windows of ``events.synthetic_gesture_events``, each voxelized by
    ``events.voxelize`` on the device. Voxel counts are integers, so the
    grid equals the JAX package's bit for bit on any device."""
    dev = resolve_device(device)
    rng = np.random.default_rng(999 + step)
    labels = rng.integers(0, num_classes, size=batch_size)
    voxes, counts = [], []
    for lab in labels:
        w = ev.synthetic_gesture_events(
            rng, int(lab), duration_us=duration_us,
            mean_events=mean_events, height=height, width=width,
            num_classes=num_classes)
        x, y, t, p = (torch.from_numpy(a).to(dev)
                      for a in (w.x, w.y, w.t, w.p))
        voxes.append(ev.voxelize(x, y, t, p, duration_us=duration_us,
                                 time_bins=time_bins, height=height,
                                 width=width))
        counts.append(w.num_events)
    return DVSBatch(
        vox=torch.stack(voxes),
        labels=torch.from_numpy(labels.astype(np.int64)).to(dev),
        num_events=np.asarray(counts),
    )
