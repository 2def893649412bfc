"""Event-stream handling: the ColibriES acquisition + preprocessing stages.

Port of ``repro.core.events``. The numpy parts (``EventWindow``,
``PaddedEventBatch``, ``pad_event_windows``, ``next_pow2``,
``synthetic_gesture_events``) are copied verbatim. Voxelization -- binning
events into a dense (T, 2, H, W) spike grid -- is an integer scatter-add
on the tensor's device: counts are int32, clamped to 1 for binary grids,
then cast to float32, so the grid is exact and deterministic on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

__all__ = [
    "EventWindow",
    "PaddedEventBatch",
    "pad_event_windows",
    "next_pow2",
    "voxelize",
    "voxelize_batch",
    "synthetic_gesture_events",
    "DVS_SENSOR_H",
    "DVS_SENSOR_W",
]

# DVS128 sensor geometry (IBM DVS-Gesture dataset).
DVS_SENSOR_H = 128
DVS_SENSOR_W = 128


@dataclasses.dataclass
class EventWindow:
    """A fixed-duration window of DVS events (the acquisition unit).

    Attributes:
      x, y: int32 pixel coordinates, shape (N,).
      t: int32 microsecond timestamps relative to window start, shape (N,).
      p: int32 polarity in {0, 1}, shape (N,).
      duration_us: window length in microseconds (paper: 300 ms windows).
      label: optional int class label (11 classes for DVS-Gesture).
    """

    x: np.ndarray
    y: np.ndarray
    t: np.ndarray
    p: np.ndarray
    duration_us: int
    label: int = -1

    @property
    def num_events(self) -> int:
        return int(self.x.shape[0])


def next_pow2(n: int, floor: int = 1024) -> int:
    """Round up to a power of two (>= floor): the event-count bucketing
    rule shared by the B=1 pipeline wrapper and the streaming engine, so
    both compile one executable per bucket. Padding amount never changes
    results (voxel sums are exact)."""
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass
class PaddedEventBatch:
    """A batch of event windows padded to a common event count.

    The unit the streaming engine feeds to the batched closed loop: ``B``
    fixed batch slots, each holding one window's events left-aligned in a
    ``(B, max_events)`` buffer. Empty slots (``window=None``) carry zero
    valid events and voxelize to an all-zero grid, so a partially filled
    batch runs through the same jit'd computation as a full one.

    Attributes:
      x, y, t, p: int32 arrays, shape (B, max_events); padding is zeros.
      valid: bool array (B, max_events) marking real events.
      num_events: int64 array (B,), true event count per slot.
      occupied: bool array (B,), True where the slot holds a window --
        distinct from ``num_events == 0``: a real window from a quiet
        sensor has zero events but is still occupied and gets a result.
      duration_us: shared window duration (all windows in a batch must
        agree -- they are voxelized with one bin width).
      labels: int array (B,), -1 where unknown/empty.
    """

    x: np.ndarray
    y: np.ndarray
    t: np.ndarray
    p: np.ndarray
    valid: np.ndarray
    num_events: np.ndarray
    occupied: np.ndarray
    duration_us: int
    labels: np.ndarray

    @property
    def batch_size(self) -> int:
        return int(self.x.shape[0])

    @property
    def max_events(self) -> int:
        return int(self.x.shape[1])


def pad_event_windows(
    windows,
    *,
    max_events: int | None = None,
    batch_size: int | None = None,
    duration_us: int | None = None,
) -> PaddedEventBatch:
    """Pack a list of :class:`EventWindow` (or ``None`` for empty slots)
    into a :class:`PaddedEventBatch`.

    Args:
      windows: sequence of windows; ``None`` entries become empty slots.
      max_events: pad target; defaults to the largest window. Must be
        >= every window's event count (no silent truncation).
      batch_size: pad the batch with trailing empty slots up to this size
        (the engine's fixed slot count); defaults to ``len(windows)``.
      duration_us: required if every entry is ``None``; otherwise taken
        from the windows (which must all agree).
    """
    windows = list(windows)
    b = batch_size if batch_size is not None else len(windows)
    if b == 0:
        raise ValueError("empty batch: give at least one window (slot) or "
                         "a batch_size > 0")
    if len(windows) > b:
        raise ValueError(f"{len(windows)} windows > batch_size={b}")
    windows = windows + [None] * (b - len(windows))

    durations = {w.duration_us for w in windows if w is not None}
    if len(durations) > 1:
        raise ValueError(f"mixed window durations in one batch: {durations}")
    if durations:
        duration_us = durations.pop()
    elif duration_us is None:
        raise ValueError("all slots empty: duration_us must be given")

    counts = [0 if w is None else w.num_events for w in windows]
    n = max_events if max_events is not None else max(max(counts), 1)
    if max(counts) > n:
        raise ValueError(f"max_events={n} < largest window ({max(counts)})")
    occupied = np.asarray([w is not None for w in windows])

    mk = lambda: np.zeros((b, n), np.int32)
    x, y, t, p = mk(), mk(), mk(), mk()
    valid = np.zeros((b, n), bool)
    labels = np.full(b, -1, np.int32)
    for i, w in enumerate(windows):
        if w is None:
            continue
        c = counts[i]
        x[i, :c], y[i, :c] = w.x, w.y
        t[i, :c], p[i, :c] = w.t, w.p
        valid[i, :c] = True
        labels[i] = w.label
    return PaddedEventBatch(
        x=x, y=y, t=t, p=p, valid=valid,
        num_events=np.asarray(counts, np.int64), occupied=occupied,
        duration_us=int(duration_us), labels=labels,
    )


def voxelize_batch(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    valid: torch.Tensor,
    *,
    duration_us: int,
    time_bins: int,
    height: int = DVS_SENSOR_H,
    width: int = DVS_SENSOR_W,
    binary: bool = True,
) -> torch.Tensor:
    """Batched voxelization: padded (B, N) event tensors -> (B, T, 2, H, W).

    One scatter-add over ``B * N`` events with per-stream voxel offsets.
    Events outside a stream's own grid are masked per stream before the
    offsets are added: otherwise a malformed event on one sensor would
    land in the NEXT stream's voxels. Padding and out-of-range events get
    weight 0 and are parked in the last voxel. Counts are integers, so the
    grid does not depend on batch size, padding or scatter order.
    """
    b, n = x.shape
    t = t.clamp(0, duration_us - 1)
    bin_width = max(duration_us // time_bins, 1)
    tb = torch.clamp(torch.div(t, bin_width, rounding_mode="floor"),
                     max=time_bins - 1)
    flat = ((tb * 2 + p) * height + y) * width + x
    num_voxels = time_bins * 2 * height * width
    keep = valid & (flat >= 0) & (flat < num_voxels)
    offsets = (torch.arange(b, dtype=torch.int64, device=x.device)[:, None]
               * num_voxels)
    flat = torch.where(keep, flat.long() + offsets, b * num_voxels - 1)
    counts = torch.zeros(b * num_voxels, dtype=torch.int32, device=x.device)
    counts.index_add_(0, flat.reshape(-1), keep.reshape(-1).to(torch.int32))
    if binary:
        counts = counts.clamp(max=1)
    return counts.reshape(b, time_bins, 2, height, width).float()


def voxelize(
    x: torch.Tensor,
    y: torch.Tensor,
    t: torch.Tensor,
    p: torch.Tensor,
    *,
    duration_us: int,
    time_bins: int,
    height: int = DVS_SENSOR_H,
    width: int = DVS_SENSOR_W,
    valid: torch.Tensor | None = None,
    binary: bool = True,
) -> torch.Tensor:
    """Bin one event stream (N,) into a dense (T, 2, H, W) float32 grid.

    Out-of-range events are dropped and ``valid`` (optional bool (N,))
    masks padding, as in the JAX reference. ``binary`` clips counts to
    {0, 1} spikes.
    """
    if valid is None:
        valid = torch.ones(x.shape, dtype=torch.bool, device=x.device)
    return voxelize_batch(
        x[None], y[None], t[None], p[None], valid[None],
        duration_us=duration_us, time_bins=time_bins, height=height,
        width=width, binary=binary)[0]


def synthetic_gesture_events(
    rng: np.random.Generator,
    label: int,
    *,
    duration_us: int = 300_000,
    mean_events: int = 60_000,
    height: int = DVS_SENSOR_H,
    width: int = DVS_SENSOR_W,
    num_classes: int = 11,
) -> EventWindow:
    """Generate a synthetic DVS-Gesture-like event window.

    The DVS-Gesture classes are hand/arm motions (waves, circles, ...); a
    DVS camera reports events along moving edges. We synthesize a class-
    dependent parametric motion (distinct angular frequency / orbit / phase
    per class) of a small edge cluster plus uniform background noise, which
    yields event windows whose spatio-temporal statistics (event rate,
    spatial locality, motion coherence) are DVS-like and which a
    spatio-temporal classifier must integrate over time to separate.
    """
    assert 0 <= label < num_classes
    n = int(rng.poisson(mean_events))
    n = max(n, 1024)
    # Class-dependent motion parameters: deterministic per label.
    w0 = 2.0 * np.pi * (1.0 + 0.7 * label)           # angular frequency
    radius = 20.0 + 3.0 * (label % 4)                 # orbit radius
    cx = width / 2.0 + 12.0 * np.cos(2.0 * np.pi * label / num_classes)
    cy = height / 2.0 + 12.0 * np.sin(2.0 * np.pi * label / num_classes)
    phase = 2.0 * np.pi * label / num_classes
    vertical = label % 2 == 0                          # motion axis flavour

    t = np.sort(rng.integers(0, duration_us, size=n)).astype(np.int64)
    tau = t.astype(np.float64) / duration_us
    ang = w0 * tau + phase
    px = cx + radius * np.cos(ang)
    py = cy + radius * (np.sin(2 * ang) if vertical else np.sin(ang))
    # Events scatter around the moving edge.
    sx = rng.normal(0.0, 3.0, size=n)
    sy = rng.normal(0.0, 3.0, size=n)
    x = np.clip(np.round(px + sx), 0, width - 1).astype(np.int32)
    y = np.clip(np.round(py + sy), 0, height - 1).astype(np.int32)
    # Polarity follows the direction of intensity change along the motion.
    p = ((np.cos(ang) + rng.normal(0, 0.35, size=n)) > 0).astype(np.int32)
    # ~10% uniform background noise events.
    noise = rng.random(n) < 0.10
    x = np.where(noise, rng.integers(0, width, size=n), x).astype(np.int32)
    y = np.where(noise, rng.integers(0, height, size=n), y).astype(np.int32)
    p = np.where(noise, rng.integers(0, 2, size=n), p).astype(np.int32)
    return EventWindow(
        x=x, y=y, t=t.astype(np.int32), p=p,
        duration_us=duration_us, label=label,
    )
