"""A checkpoint store with single-use restore semantics.

Port of ``repro.fleet.store`` (plain Python and pickle).

The rebalancer moves streams between engines through checkpoints; the
store is the hand-off point. Two properties matter and both are
enforced here rather than hoped for:

  * **Host-serializable or rejected at put.** ``put`` pickles the
    checkpoint to bytes immediately, so a checkpoint that secretly
    holds device buffers (or anything else unpicklable) fails at the
    source engine, not later on whatever machine tries to restore it.
    ``get`` unpickles a *fresh copy* every time -- mutating a restored
    checkpoint can never corrupt the stored blob.
  * **Single-use restore.** A stream must live on exactly one engine;
    replaying the same checkpoint into two engines would fork it (two
    streams claiming the same identity and sequence numbers). The store
    remembers consumed ids and rejects a second restore of the same
    checkpoint outright.

The store is in-process (a dict of pickled blobs). That is deliberate:
the serialization boundary is the contract, and a durable backend
(file, object store) only has to replace ``_blobs``.

``capacity`` bounds the store: auto-checkpointing
(a fleet supervisor putting a fresh blob per
watched stream every K ticks) must not grow it without bound, so a full
store evicts its least-recently-used blob at ``put``. Every eviction
drops an un-restored checkpoint -- consumed blobs are already gone --
and is counted in ``stats["evicted"]``; a supervisor that later needs
an evicted blob fails loudly, so size ``capacity`` to at least the
watched-stream count.
"""
from __future__ import annotations

import pickle
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional

__all__ = ["CheckpointStore"]


class CheckpointStore:
    """Pickled :class:`~repro_torch.serving.session.StreamCheckpoint` blobs
    keyed by checkpoint id, with consumed-id tracking and an optional
    LRU capacity bound."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is not None and capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._blobs: "OrderedDict[str, bytes]" = OrderedDict()
        self._consumed: set = set()
        self._count = 0
        self.stats: Dict[str, int] = {"evicted": 0}

    def __len__(self) -> int:
        return len(self._blobs)

    def __contains__(self, ckpt_id: str) -> bool:
        return ckpt_id in self._blobs

    def ids(self) -> List[str]:
        """Stored (not-yet-consumed) checkpoint ids, insertion order."""
        return list(self._blobs)

    def put(self, ckpt, ckpt_id: Optional[str] = None) -> str:
        """Serialize ``ckpt`` into the store; returns its id.

        Pickling happens here, so an unserializable checkpoint fails at
        put time. Ids are never reused: an explicit ``ckpt_id`` that was
        already stored OR already consumed is rejected (reuse would
        silently defeat the double-restore guard).
        """
        if ckpt_id is None:
            self._count += 1
            ckpt_id = f"ckpt-{self._count}"
        if ckpt_id in self._blobs or ckpt_id in self._consumed:
            raise ValueError(f"checkpoint id {ckpt_id!r} already used")
        self._blobs[ckpt_id] = pickle.dumps(ckpt)
        if self.capacity is not None:
            while len(self._blobs) > self.capacity:
                # LRU victim: least recently put/get blob. It was never
                # restored (consumed blobs are already gone), so the
                # eviction is recorded -- the signal a supervisor sizing
                # its store too small will eventually trip over.
                self._blobs.popitem(last=False)
                self.stats["evicted"] += 1
        return ckpt_id

    def get(self, ckpt_id: str):
        """A fresh deserialized copy of the stored checkpoint (the blob
        stays in the store until ``consume`` or ``delete``)."""
        if ckpt_id in self._consumed:
            raise ValueError(
                f"checkpoint {ckpt_id!r} was already restored once; "
                "checkpoints are single-use (a second restore would fork "
                "the stream)")
        if ckpt_id not in self._blobs:
            raise KeyError(f"no checkpoint {ckpt_id!r} in store")
        self._blobs.move_to_end(ckpt_id)
        return pickle.loads(self._blobs[ckpt_id])

    def delete(self, ckpt_id: str) -> bool:
        """Drop a stored blob without consuming its id (the stream was
        not migrated -- e.g. a periodic backup superseded by a newer
        one). Returns whether anything was deleted."""
        return self._blobs.pop(ckpt_id, None) is not None

    def consume(self, ckpt_id: str) -> None:
        """Mark ``ckpt_id`` restored: the blob is dropped and the id is
        permanently rejected by ``get``/``put``. Called by
        ``restore_into`` after a restore lands; call it directly when
        composing a restore by hand (e.g. through a ``FusionSession``)."""
        if ckpt_id not in self._blobs:
            raise KeyError(f"no checkpoint {ckpt_id!r} in store")
        del self._blobs[ckpt_id]
        self._consumed.add(ckpt_id)

    def restore_into(self, engine, ckpt_id: str, *,
                     stream_id: Optional[Hashable] = None):
        """Open a matching stream on ``engine`` and replay the stored
        checkpoint into it; returns the new
        :class:`~repro_torch.serving.stream.StreamHandle`.

        The id is consumed only after the restore lands, so a failed
        restore (modality mismatch, duration conflict, rejected window)
        leaves the checkpoint in the store and the engine untouched.
        """
        ckpt = self.get(ckpt_id)
        handle = engine.open(
            ckpt.modality,
            stream_id=ckpt.stream_id if stream_id is None else stream_id,
            stateful=ckpt.stateful, deadline=ckpt.deadline)
        try:
            handle.restore(ckpt)
        except Exception:
            handle.close()
            raise
        self.consume(ckpt_id)
        return handle
