"""Supervised lane recovery: auto-checkpoint, rebuild, restore, replay.

Port of ``repro.fleet.supervisor``. The engine-level recovery layer
(``EngineConfig.recovery``) keeps a failing lane *contained* -- retries,
quarantines, fail-fast on a dead lane -- but a dead lane stays dead
until someone installs a new engine. :class:`LaneSupervisor` is that
someone. It closes the loop a flight-critical controller demands: a
supervised stateful stream survives its lane's death with every window
it ever reported successful bitwise-identical to an uninterrupted scan.

Mechanism, in order:

  * **Journal.** Every window enters through :meth:`LaneSupervisor.
    submit`, which records ``(seq, window, deadline)`` per stream before
    queueing it. The journal is the replay source; it is trimmed below
    each checkpoint's ``next_seq`` so it never outgrows one checkpoint
    interval.
  * **Auto-checkpoint.** Every ``recovery.checkpoint_every`` calls to
    :meth:`tick`, each watched stream is checkpointed live
    (:func:`~repro_torch.fleet.migrate.checkpoint_live` -- drains only
    that stream's lane, other lanes keep their pipelined steps) into the
    :class:`~repro_torch.fleet.store.CheckpointStore`; the superseded
    blob is deleted so a supervised stream holds exactly one stored
    checkpoint.
  * **Death detection + recovery.** :meth:`tick` watches
    ``engine.telemetry()`` for a lane with ``dead=True``; recovery is
    ``abort_lane`` (flush the lane's in-flight records back to queues),
    ``replace_lane_engine`` with a fresh engine from the ``rebuild``
    callback, then per watched stream: close, restore the stored
    checkpoint, and replay the journal from ``next_seq`` on -- the
    replayed submits reassign the exact original sequence numbers.
  * **Dedupe.** Replay recomputes windows that were already reported
    successful before the crash (that is what makes the carry advance
    identically); :meth:`tick` drops those duplicate rows so the caller
    sees each successful ``(stream, seq)`` exactly once.

What the supervisor does NOT hide: rows the engine failed (quarantine,
retry exhaustion) pass through ``tick`` -- after recovery the same seq
may later emit a successful row, which is the supervisor making the
failure transient rather than rewriting history.

A checkpoint evicted from a bounded store (LRU) before its stream
needed it makes that stream unrecoverable-bitwise; :meth:`recover`
raises rather than silently restarting the carry cold. Size the store
capacity to the watched-stream count.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Hashable, List, Optional, Set

from repro_torch.core._api import RecoveryConfig
from repro_torch.fleet.migrate import checkpoint_live
from repro_torch.fleet.store import CheckpointStore

__all__ = ["LaneSupervisor"]


class LaneSupervisor:
    """Journal + auto-checkpoint + rebuild/restore/replay for the
    stateful streams of one
    :class:`~repro_torch.serving.stream.StreamEngine`.

    ``rebuild`` is a ``modality -> InferenceEngine`` callback producing
    the replacement engine for a dead lane (same params; on the card a
    fresh graph cache, which captures at its first dispatch or at
    ``warmup``). Without it, dead lanes are reported but not recovered.
    The supervisor keeps no reference to a replaced engine, so the dead
    engine's graphs and staging buffers are freed once the serving
    engine lets go of it.
    """

    def __init__(self, engine, *, store: Optional[CheckpointStore] = None,
                 rebuild: Optional[Callable[[str], Any]] = None,
                 recovery: Optional[RecoveryConfig] = None):
        if recovery is None:
            recovery = getattr(engine, "recovery", None) or RecoveryConfig()
        if not isinstance(recovery, RecoveryConfig):
            raise TypeError(
                f"recovery must be a RecoveryConfig, got "
                f"{type(recovery).__name__}")
        self.engine = engine
        self.store = store if store is not None else CheckpointStore()
        self.rebuild = rebuild
        self.recovery = recovery
        self._handles: Dict[Hashable, Any] = {}
        self._journal: Dict[Hashable, List[tuple]] = {}
        self._ckpts: Dict[Hashable, str] = {}
        self._reported: Dict[Hashable, Set[int]] = {}
        self._ticks = 0
        self.stats: Dict[str, int] = {
            "checkpoints": 0, "restores": 0, "replayed": 0, "deduped": 0}

    # -- registration and journaled submission ---------------------------

    def watch(self, handle) -> Any:
        """Supervise ``handle``'s stream. Submit through
        :meth:`submit` from here on -- windows submitted directly on the
        handle are invisible to the journal and cannot be replayed."""
        sid = handle.stream_id
        if sid in self._handles and not self._handles[sid].closed:
            raise ValueError(f"stream {sid!r} is already supervised")
        self._handles[sid] = handle
        self._journal.setdefault(sid, [])
        self._reported.setdefault(sid, set())
        return handle

    def handle(self, sid: Hashable):
        """The stream's current handle (replaced after a recovery)."""
        return self._handles[sid]

    def watched(self) -> List[Hashable]:
        return list(self._handles)

    def submit(self, sid: Hashable, window: Any, *,
               deadline: Optional[float] = None) -> int:
        """Journal then queue one window on the supervised stream."""
        h = self._handles[sid]
        seq = h.submit(window, deadline=deadline)
        self._journal[sid].append((seq, window, deadline))
        return seq

    # -- the per-step hook ----------------------------------------------

    def tick(self, results) -> List[Any]:
        """Feed one ``step()``'s results through the supervisor.

        Returns the rows the caller should consume: duplicates of
        already-reported successful windows are dropped, and any results
        displaced by an auto-checkpoint's lane drain are appended.
        Auto-checkpoints fire every ``recovery.checkpoint_every`` ticks;
        dead lanes recover (when ``rebuild`` is set) before returning.
        """
        out = self._filter(results)
        self._ticks += 1
        # Recovery runs BEFORE the periodic checkpoint: a checkpoint
        # taken while a lane is dead would advance next_seq past the
        # windows the death quarantined and trim them from the journal
        # -- a permanent hole. Recover first requeues them, so the
        # checkpoint that follows carries them in ``queued``.
        if self.rebuild is not None:
            for modality in list(self.engine.engines):
                if (self.engine.telemetry(modality).dead
                        and self._watched_on(modality)):
                    self.recover(modality)
        if self._ticks % self.recovery.checkpoint_every == 0:
            out.extend(self._filter(self.checkpoint_now()))
        return out

    # -- checkpointing ---------------------------------------------------

    def checkpoint_now(self, sid: Optional[Hashable] = None) -> List[Any]:
        """Checkpoint one watched stream (or all) live; returns the
        results displaced by the lane drains (route them like ``step()``
        output -- :meth:`tick` already does)."""
        displaced: List[Any] = []
        sids = [sid] if sid is not None else list(self._handles)
        for s in sids:
            h = self._handles[s]
            if h.closed:
                continue
            ckpt, shed = checkpoint_live(h)
            displaced.extend(shed)
            old = self._ckpts.get(s)
            self._ckpts[s] = self.store.put(ckpt)
            if old is not None:
                self.store.delete(old)
            self.stats["checkpoints"] += 1
            # The journal only needs to cover windows the checkpoint
            # does not: trim below next_seq (ckpt.queued carries the
            # still-queued ones itself).
            cut = int(ckpt.next_seq)
            self._journal[s] = [e for e in self._journal[s]
                                if e[0] >= cut]
            # The dedupe set must survive for any seq the checkpoint
            # still carries queued: a post-restore replay re-runs those
            # windows, and ones already reported ok would re-emit. Only
            # seqs below every queued entry are settled for good.
            rcut = min([cut] + [q[1] for q in ckpt.queued])
            self._reported[s] = {q for q in self._reported[s] if q >= rcut}
        return displaced

    # -- recovery --------------------------------------------------------

    def recover(self, modality: str) -> int:
        """Rebuild a dead lane and restore+replay its watched streams.

        Returns the number of streams restored. Unwatched streams on
        the lane keep their queued windows through ``abort_lane`` but
        restart from zero carry (documented on
        ``replace_lane_engine``); watched streams resume from their
        last checkpoint with their full journal replayed, reassigning
        the original sequence numbers.
        """
        if self.rebuild is None:
            raise ValueError("no rebuild callback; cannot recover")
        eng = self.engine
        eng.abort_lane(modality)
        eng.replace_lane_engine(modality, engine=self.rebuild(modality))
        restored = 0
        for sid in self._watched_on(modality):
            old = self._handles[sid]
            stateful = old.stateful
            deadline = old.deadline
            if not old.closed:
                old.close()
            ckpt_id = self._ckpts.pop(sid, None)
            if ckpt_id is not None and ckpt_id not in self.store:
                raise RuntimeError(
                    f"checkpoint {ckpt_id!r} for supervised stream "
                    f"{sid!r} was evicted from the store; bitwise "
                    f"recovery is impossible (raise the store capacity "
                    f"above the watched-stream count)")
            if ckpt_id is not None:
                h = self.store.restore_into(eng, ckpt_id)
                replay_from = h.next_seq
            else:
                h = eng.open(modality, stream_id=sid, stateful=stateful,
                             deadline=deadline)
                replay_from = 0
            for seq, window, dl in self._journal[sid]:
                if seq < replay_from:
                    continue
                got = h.submit(window, deadline=dl)
                if got != seq:
                    raise RuntimeError(
                        f"replay of stream {sid!r} assigned seq {got}, "
                        f"journal says {seq}; the journal has a gap "
                        f"(was a window submitted around the "
                        f"supervisor?)")
                self.stats["replayed"] += 1
            self._handles[sid] = h
            restored += 1
            self.stats["restores"] += 1
            # The restore consumed the stored checkpoint; take a fresh
            # one NOW (replayed windows ride its ``queued``) so a second
            # death before the next periodic checkpoint is recoverable.
            self.checkpoint_now(sid)
        return restored

    # -- internals -------------------------------------------------------

    def _watched_on(self, modality: str) -> List[Hashable]:
        return [sid for sid, h in self._handles.items()
                if h.modality == modality]

    def _filter(self, results) -> List[Any]:
        out = []
        for r in results:
            seen = self._reported.get(r.stream_id)
            if seen is None or not getattr(r, "ok", True):
                out.append(r)
                continue
            if r.seq in seen:
                self.stats["deduped"] += 1
                continue
            seen.add(r.seq)
            out.append(r)
        return out
