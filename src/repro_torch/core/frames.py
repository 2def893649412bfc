"""Frame-stream handling: the ColibriES frame-camera acquisition wing.

Port of ``repro.core.frames``. The numpy parts (``FrameWindow``,
``PaddedFrameBatch``, ``pad_frame_windows``, ``synthetic_gesture_frames``
and the sensor constants) are copied verbatim; ``normalize_frames`` runs
on tensors. A :class:`FrameWindow` is one camera frame (one control
tick); a :class:`PaddedFrameBatch` is the fixed ``(B, H, W, 1)`` buffer a
:class:`~repro_torch.core.engine.FrameTCNEngine` infers in one call.
Frames are dense, so the batch shape is fixed by the sensor geometry.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "FrameWindow",
    "PaddedFrameBatch",
    "pad_frame_windows",
    "normalize_frames",
    "synthetic_gesture_frames",
    "FRAME_SENSOR_H",
    "FRAME_SENSOR_W",
]

# Frame camera geometry; matched to the DVS128 so both wings of the
# platform observe the same scene at the same resolution.
FRAME_SENSOR_H = 128
FRAME_SENSOR_W = 128


@dataclasses.dataclass
class FrameWindow:
    """One camera frame: the frame-modality acquisition unit.

    Attributes:
      pixels: (H, W) uint8/float grayscale intensities in [0, 255].
      duration_us: frame period in microseconds (the control-tick length
        this frame covers, symmetric to ``EventWindow.duration_us``).
      label: optional int class label, -1 if unknown.
    """

    pixels: np.ndarray
    duration_us: int
    label: int = -1

    @property
    def num_pixels(self) -> int:
        return int(self.pixels.shape[0] * self.pixels.shape[1])

    @property
    def shape(self):
        return tuple(self.pixels.shape)


@dataclasses.dataclass
class PaddedFrameBatch:
    """A batch of frames in the engine's fixed slot buffer.

    Attributes:
      pixels: float32 (B, H, W, 1) raw intensities; empty slots are zeros.
      occupied: bool (B,), True where the slot holds a real frame.
      num_pixels: int64 (B,), true pixel count per slot (0 when empty) --
        drives the acquisition/preprocessing legs of the energy model.
      duration_us: shared frame period (one tick length per engine).
      labels: int32 (B,), -1 where unknown/empty.
    """

    pixels: np.ndarray
    occupied: np.ndarray
    num_pixels: np.ndarray
    duration_us: int
    labels: np.ndarray

    @property
    def batch_size(self) -> int:
        return int(self.pixels.shape[0])

    @property
    def frame_shape(self):
        return int(self.pixels.shape[1]), int(self.pixels.shape[2])


def pad_frame_windows(
    frames,
    *,
    batch_size: int | None = None,
    duration_us: int | None = None,
    height: int | None = None,
    width: int | None = None,
) -> PaddedFrameBatch:
    """Pack :class:`FrameWindow` entries (or ``None`` for empty slots)
    into a :class:`PaddedFrameBatch`.

    All frames must share one geometry and one frame period (the frame
    analogue of the event path's one-bin-width-per-engine contract).
    ``height``/``width`` are required only when every slot is empty.
    """
    frames = list(frames)
    b = batch_size if batch_size is not None else len(frames)
    if b == 0:
        raise ValueError("empty batch: give at least one frame (slot) or "
                         "a batch_size > 0")
    if len(frames) > b:
        raise ValueError(f"{len(frames)} frames > batch_size={b}")
    frames = frames + [None] * (b - len(frames))

    durations = {f.duration_us for f in frames if f is not None}
    if len(durations) > 1:
        raise ValueError(f"mixed frame periods in one batch: {durations}")
    if durations:
        duration_us = durations.pop()
    elif duration_us is None:
        raise ValueError("all slots empty: duration_us must be given")

    shapes = {f.shape for f in frames if f is not None}
    if len(shapes) > 1:
        raise ValueError(f"mixed frame geometries in one batch: {shapes}")
    if shapes:
        height, width = shapes.pop()
    elif height is None or width is None:
        raise ValueError("all slots empty: height/width must be given")

    pixels = np.zeros((b, height, width, 1), np.float32)
    occupied = np.zeros(b, bool)
    num_pixels = np.zeros(b, np.int64)
    labels = np.full(b, -1, np.int32)
    for i, f in enumerate(frames):
        if f is None:
            continue
        pixels[i, :, :, 0] = np.asarray(f.pixels, np.float32)
        occupied[i] = True
        num_pixels[i] = f.num_pixels
        labels[i] = f.label
    return PaddedFrameBatch(
        pixels=pixels, occupied=occupied, num_pixels=num_pixels,
        duration_us=int(duration_us), labels=labels,
    )


def normalize_frames(pixels: torch.Tensor) -> torch.Tensor:
    """Cluster preprocessing: [0, 255] intensities -> [-1, 1] floats.

    Elementwise (one f32 multiply, one f32 subtract), so per-slot results
    never depend on the batch and are the same on every device.
    """
    return pixels.float() * (2.0 / 255.0) - 1.0


def synthetic_gesture_frames(
    rng: np.random.Generator,
    label: int,
    *,
    duration_us: int = 300_000,
    height: int = FRAME_SENSOR_H,
    width: int = FRAME_SENSOR_W,
    num_classes: int = 11,
    exposure_steps: int = 24,
) -> FrameWindow:
    """Render a synthetic frame of the same gesture family as
    :func:`repro_torch.core.events.synthetic_gesture_events`.

    The frame camera integrates light over the frame period, so the moving
    edge cluster that produces DVS events leaves a motion-blurred intensity
    trail. We render the identical class-parametric trajectory (same
    angular frequency / orbit / phase per label) sampled at
    ``exposure_steps`` points, splatted with a Gaussian spread, over a
    noisy background -- frames a spatial classifier can separate by the
    trail's shape.
    """
    assert 0 <= label < num_classes
    # Same per-class motion constants as the event generator.
    w0 = 2.0 * np.pi * (1.0 + 0.7 * label)
    radius = 20.0 + 3.0 * (label % 4)
    cx = width / 2.0 + 12.0 * np.cos(2.0 * np.pi * label / num_classes)
    cy = height / 2.0 + 12.0 * np.sin(2.0 * np.pi * label / num_classes)
    phase = 2.0 * np.pi * label / num_classes
    vertical = label % 2 == 0

    tau = np.linspace(0.0, 1.0, exposure_steps)
    ang = w0 * tau + phase
    px = cx + radius * np.cos(ang)
    py = cy + radius * (np.sin(2 * ang) if vertical else np.sin(ang))

    yy, xx = np.mgrid[0:height, 0:width]
    img = np.zeros((height, width), np.float64)
    for j in range(exposure_steps):
        d2 = (xx - px[j]) ** 2 + (yy - py[j]) ** 2
        img += np.exp(-d2 / (2.0 * 3.0 ** 2))
    img /= img.max() + 1e-9
    img = 40.0 + 180.0 * img + rng.normal(0.0, 6.0, size=img.shape)
    pixels = np.clip(np.round(img), 0, 255).astype(np.uint8)
    return FrameWindow(pixels=pixels, duration_us=duration_us, label=label)
