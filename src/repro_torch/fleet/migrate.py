"""Live stream migration: checkpoint with windows in flight.

Port of ``repro.fleet.migrate``. ``StreamHandle.checkpoint()`` refuses
while the stream has windows in flight -- their state commits have not
landed. The naive fix is ``engine.flush()``, but that stalls EVERY
lane's pipeline to move one stream. :func:`checkpoint_live` instead
drains only the stream's own lane (``drain_lane``): other lanes'
dispatched graph replays stay in flight, and the lane's collected
results -- this stream's and its lane-mates' -- are handed back to the
caller to route to their consumers as usual.

:func:`migrate_stream` is the whole move: drain, checkpoint (one
device-to-host copy of the stream's carry), close the source, replay
into the target engine (one host-to-device copy a layer; the target
serves the stream through its own graphs, whatever its slot count).
Routed through a :class:`~repro_torch.fleet.store.CheckpointStore` it
inherits the store's guarantees (host-serializability proven at put,
single-use restore); without a store it hands the checkpoint object
across directly. Either way the restored stream's remaining windows are
bitwise-identical to an uninterrupted scan on the source engine -- that
is the serving layer's checkpoint contract, and the fleet soak test pins
it under churn.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Hashable, Optional, Tuple

__all__ = ["MigrationRecord", "checkpoint_live", "migrate_stream"]


@dataclasses.dataclass(frozen=True)
class MigrationRecord:
    """What one migration did: identity, cost, and the side effects the
    caller must handle (``displaced`` results were collected early by
    the lane drain and still belong to their streams' consumers)."""

    stream_id: Hashable
    modality: str
    ckpt_id: Optional[str]           # None when no store was used
    displaced: Tuple                 # StreamResult rows from the drain
    migration_ms: float
    handle: object                   # the stream's new StreamHandle

    def __repr__(self):
        return (f"<MigrationRecord {self.stream_id!r} {self.modality} "
                f"{self.migration_ms:.2f}ms displaced={len(self.displaced)}>")


def checkpoint_live(handle):
    """Checkpoint a stream that may have windows in flight.

    Drains the stream's lane only (other lanes keep their pipelined
    steps), then captures the checkpoint. Returns ``(ckpt, displaced)``
    where ``displaced`` is every result the drain collected -- the
    caller routes them exactly like ``step()`` output.
    """
    displaced = handle.engine.drain_lane(handle.modality)
    return handle.checkpoint(), displaced


def migrate_stream(handle, target, *, store=None,
                   stream_id: Optional[Hashable] = None) -> MigrationRecord:
    """Move one stream from its engine to ``target`` live.

    Drains the source lane, checkpoints, closes the source stream, and
    replays into ``target`` (keeping the stream id unless ``stream_id``
    renames it). With a ``store``, the checkpoint crosses the pickle
    boundary and its id is consumed on restore (double-restore rejected);
    without one, the checkpoint object is handed across in-process.

    Returns a :class:`MigrationRecord`; its ``displaced`` results must
    be routed by the caller, and ``migration_ms`` is the end-to-end host
    cost (drain + checkpoint + close + restore).
    """
    t0 = time.perf_counter()
    ckpt, displaced = checkpoint_live(handle)
    handle.close()
    new_id = ckpt.stream_id if stream_id is None else stream_id
    if store is not None:
        ckpt_id = store.put(ckpt)
        new_handle = store.restore_into(target, ckpt_id,
                                        stream_id=new_id)
    else:
        ckpt_id = None
        new_handle = target.open(
            ckpt.modality, stream_id=new_id,
            stateful=ckpt.stateful, deadline=ckpt.deadline).restore(ckpt)
    return MigrationRecord(
        stream_id=new_id, modality=ckpt.modality, ckpt_id=ckpt_id,
        displaced=tuple(displaced),
        migration_ms=(time.perf_counter() - t0) * 1e3,
        handle=new_handle)
