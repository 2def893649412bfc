"""Bit-reproducible training steps on the card.

cuDNN's default weight-gradient algorithms for the SCNN's convolutions
add partial sums with atomics, so two runs of the same step differ in the
last bits of the conv gradients (seen on the H100), and a run restarted
from a checkpoint drifts from the uninterrupted one. :func:`deterministic`
restricts cuDNN to deterministic algorithms for the block it wraps, a
training step, and restores the previous setting after it. It is not set
package-wide: the flag also steers the forward convolutions' algorithm
choice, which the serving path's gates hold as it is.
"""
from __future__ import annotations

import contextlib
from typing import Iterator

import torch

__all__ = ["deterministic"]


@contextlib.contextmanager
def deterministic() -> Iterator[None]:
    """cuDNN restricted to deterministic algorithms inside the block."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev
