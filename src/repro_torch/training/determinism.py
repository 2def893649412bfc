"""Bit-reproducible training steps on the card.

cuDNN's default weight-gradient algorithms for the SCNN's convolutions
add partial sums with atomics, so two runs of the same step differ in the
last bits of the conv gradients (seen on the H100), and a run restarted
from a checkpoint drifts from the uninterrupted one. :func:`deterministic`
restricts cuDNN to deterministic algorithms for the block it wraps, a
training step, and restores the previous setting after it. It is not set
package-wide: the flag also steers the forward convolutions' algorithm
choice, which the serving path's gates hold as it is.

An LM step needs more: the backward of the embedding gather
(``index_put_`` with accumulation), of the cross-entropy's ``gather``
and of ``cumsum`` (the chunked WKV and SSD forms) may add with atomics
or a scan whose order depends on timing. ``deterministic(all_ops=True)``
also turns on ``torch.use_deterministic_algorithms`` for the block (an op
with no deterministic kernel then raises rather than drifting), with
``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which that mode asks of cuBLAS, and
without filling fresh memory with NaN (the step writes every buffer it
allocates).
"""
from __future__ import annotations

import contextlib
import os
from typing import Iterator

import torch
import torch.utils.deterministic

__all__ = ["deterministic"]

_CUBLAS = "CUBLAS_WORKSPACE_CONFIG"


@contextlib.contextmanager
def deterministic(all_ops: bool = False) -> Iterator[None]:
    """cuDNN restricted to deterministic algorithms inside the block; with
    ``all_ops`` every op that has a choice (``torch.
    use_deterministic_algorithms``)."""
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    if all_ops:
        prev_mode = (torch.are_deterministic_algorithms_enabled(),
                     torch.is_deterministic_algorithms_warn_only_enabled())
        prev_env = os.environ.get(_CUBLAS)
        prev_fill = torch.utils.deterministic.fill_uninitialized_memory
        if prev_env not in (":4096:8", ":16:8"):
            os.environ[_CUBLAS] = ":4096:8"
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev
        if all_ops:
            torch.use_deterministic_algorithms(prev_mode[0],
                                               warn_only=prev_mode[1])
            torch.utils.deterministic.fill_uninitialized_memory = prev_fill
            if prev_env is None:
                os.environ.pop(_CUBLAS, None)
            else:
                os.environ[_CUBLAS] = prev_env
