"""The engine protocol the serving layer drives (port of the
``InferenceEngine`` protocol of ``repro.core.engine``).

An engine declares ``modality`` and ``duration_us`` and implements
``validate``/``prepare``/``init_state``/``infer``/``shape_key``; the
optional ``infer_dispatch``/``infer_collect`` split, ``warmup`` and
``export_state``/``import_state`` are probed with ``getattr``. The event
wing, :class:`~repro_torch.core.pipeline.BatchedClosedLoop`, is the only
engine of this slice; ``FrameTCNEngine`` arrives with the frame wing.
"""
from __future__ import annotations

from typing import Any, Hashable, Optional, Protocol, Sequence, \
    runtime_checkable

__all__ = ["InferenceEngine"]


@runtime_checkable
class InferenceEngine(Protocol):
    """What the serving layer needs from an accelerator wing."""

    modality: str
    duration_us: Optional[int]

    def validate(self, item: Any) -> None:
        """Raise ValueError if ``item`` cannot be served by this engine.
        Must not mutate queue-visible state on failure (latching the
        engine's ``duration_us`` on first success is allowed)."""
        ...

    def prepare(self, items: Sequence[Optional[Any]], *,
                batch_size: int) -> Any:
        """Pad one item per slot (None = empty slot) into a batch."""
        ...

    def init_state(self, batch_size: int) -> Any:
        """Zero carried state, slot-major; empty if stateless."""
        ...

    def infer(self, batch: Any, state: Any = None):
        """Run one batch; one result per slot, None for empty slots.

        Without ``state``: returns the result list. With ``state``:
        returns ``(results, new_state)``."""
        ...

    def shape_key(self, batch: Any) -> Hashable:
        """The shape key of a prepared batch."""
        ...
