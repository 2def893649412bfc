"""Cross-modal fusion sessions: one control tick across both wings.

Port of the fusion part of ``repro.serving.session``. ColibriES's headline
scenario is one sensor head driving both Kraken wings: the DVS event
stream through the SNE (spiking CNN) and the frame stream through CUTIE
(ternary CNN), fused into one actuation decision per control tick. A
:class:`FusionSession` binds one event :class:`~repro_torch.serving.
stream.StreamHandle` and one frame handle into a single logical stream.
Each ``submit`` queues one tick's paired windows; each wing is served by
its own engine lane, and the session pairs the per-wing results back up
by tick, applies a fusion rule (:func:`late_logit_fusion` by default: a
convex combination of the wings' logits) and emits ONE fused
:class:`~repro_torch.serving.stream.StreamResult` per tick, with the
combined PWM actuation and a per-wing latency/energy breakdown.

:class:`StreamCheckpoint` is the migration payload behind
``StreamHandle.checkpoint()``/``restore()``: a picklable host snapshot of
one stream (its carry as numpy arrays, its still-queued windows and its
sequence position) that restores into a handle on another engine, after
which the remaining windows complete bitwise as in the uninterrupted run.
``FusionSession.checkpoint()``/``restore()`` (and ``checkpoint_to``/
``restore_from`` through a :class:`~repro_torch.fleet.store.
CheckpointStore`) move a whole session: both wings and its tick cursor.

With fault recovery on the engine, a session whose wing failed a tick
emits a degraded tick (the surviving wing's result, flagged) instead of
stalling; ``wing_health()`` reports each wing's lane health.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.pipeline import ClosedLoopResult, pwm_from_logits
from repro_torch.serving.stream import StreamEngine, StreamHandle, StreamResult

__all__ = ["StreamCheckpoint", "FusionSession", "late_logit_fusion"]


@dataclasses.dataclass(frozen=True)
class StreamCheckpoint:
    """One stream, frozen for migration between engines.

    Everything inside is host-resident and picklable: ``state`` is the
    engine's exported carry (numpy arrays by layer; ``None`` = cold
    start), ``queued`` holds the unserved windows as ``(window, seq,
    deadline)`` tuples, and ``next_seq`` is where numbering resumes.
    ``duration_us`` pins the one-bin-width-per-engine contract across the
    migration. Accounting (``StreamStats``) does not migrate.
    """

    stream_id: Hashable
    modality: str
    stateful: bool
    next_seq: int
    duration_us: Optional[int]
    state: Optional[Any]
    deadline: Optional[float] = None
    queued: Tuple[Tuple[Any, int, Optional[float]], ...] = ()


def late_logit_fusion(event_weight: float = 0.5,
                      frame_weight: float = 0.5) -> Callable:
    """The default fusion rule: a convex combination of the two wings'
    pre-actuation logits (late fusion: each wing runs its full schedule;
    only the classifier outputs meet).

    Returns ``rule(event_result, frame_result) -> fused_logits`` for
    :class:`FusionSession`. Custom rules plug in with the same signature.
    """

    def rule(event_result: ClosedLoopResult,
             frame_result: ClosedLoopResult) -> np.ndarray:
        return (event_weight * np.asarray(event_result.logits)
                + frame_weight * np.asarray(frame_result.logits))

    rule.name = f"late_logit(event={event_weight:g}, frame={frame_weight:g})"
    return rule


def _rule_name(rule: Callable) -> Optional[str]:
    """A rule's identity for checkpoints: its ``name``, else its
    ``__name__``."""
    return getattr(rule, "name", getattr(rule, "__name__", None))


class FusionSession:
    """One logical stream across both accelerator wings.

    Binds one event handle and one frame handle on a shared
    :class:`~repro_torch.serving.stream.StreamEngine` (opened by the
    session, or passed in pre-opened via ``event_handle=`` /
    ``frame_handle=``) and pairs them on the engine, so co-scheduling
    lands both windows of a tick in one engine step.
    ``submit(event_window, frame_window)`` queues one control tick on both
    wings under the same sequence number; ``step()`` / ``run()`` drive the
    engine and return the session's fused results in tick order, each a
    ``StreamResult`` with ``modality="fusion"``.

    The wings need not finish in the same engine step; the session
    buffers whichever lands first and emits a tick when both halves are
    in. Results of OTHER streams on the engine are never swallowed: they
    accumulate on ``unclaimed``. ``stateful=True`` opts both wings into
    carried state (the event wing's LIF membranes chain across ticks; the
    frame wing's carry is empty); ``deadline`` is both wings' default
    per-window deadline.

    With ``EngineConfig.recovery`` set, a wing's quarantined window or
    dead lane surfaces as a ``failed`` wing row, and the tick is emitted
    with ``status="degraded"`` (the surviving wing's result, the downed
    wing named in the breakdown); both wings failing emits a ``failed``
    tick. Every tick emits exactly one row, in order; ``ticks_degraded``,
    ``ticks_failed`` and ``wing_failures`` count the damage.
    """

    def __init__(
        self,
        engine: StreamEngine,
        *,
        session_id: Optional[Hashable] = None,
        stateful: bool = False,
        deadline: Optional[float] = None,
        fusion: Optional[Callable] = None,
        event_handle: Optional[StreamHandle] = None,
        frame_handle: Optional[StreamHandle] = None,
    ):
        self.engine = engine
        if session_id is None:
            taken = engine.handles
            n = 0
            while (f"fusion-{n}:event" in taken
                   or f"fusion-{n}:frame" in taken):
                n += 1
            session_id = f"fusion-{n}"
        self.session_id = session_id
        self.fusion = fusion or late_logit_fusion()
        # Pre-opened handles are checked before anything is opened, so a
        # rejected construction leaves no stream behind on the engine.
        for handle, want in ((event_handle, "event"),
                             (frame_handle, "frame")):
            if handle is not None and handle.modality != want:
                raise ValueError(
                    f"{want}_handle is bound to modality "
                    f"{handle.modality!r}")
        self.event = event_handle or engine.open(
            modality="event", stream_id=f"{session_id}:event",
            stateful=stateful, deadline=deadline)
        self.frame = frame_handle or engine.open(
            modality="frame", stream_id=f"{session_id}:frame",
            stateful=stateful, deadline=deadline)
        engine.pair_streams(self.event.stream_id, self.frame.stream_id)
        self._pending = {"event": {}, "frame": {}}
        self._emit_next = 0
        self.ticks_fused = 0
        self.ticks_degraded = 0
        self.ticks_failed = 0
        self.wing_failures = {"event": 0, "frame": 0}
        self.unclaimed: List[StreamResult] = []

    # -- submission ------------------------------------------------------

    def submit(self, event_window, frame_window, *,
               deadline: Optional[float] = None) -> int:
        """Queue one control tick: the paired event and frame windows
        (``deadline`` overrides the wings' default for this tick). Returns
        the tick's sequence number (shared by both wings).

        Atomic: desynchronized wings are detected and both windows are
        validated before either is queued, so a rejected tick queues
        nothing and cannot mispair later ticks.
        """
        seq_e, seq_f = self.event.next_seq, self.frame.next_seq
        if seq_e != seq_f:
            raise RuntimeError(
                f"fusion session {self.session_id!r} desynchronized: "
                f"event wing is at seq {seq_e}, frame wing at {seq_f} "
                f"(were the wing handles submitted to outside the "
                f"session?)")
        self.event.validate(event_window)
        self.frame.validate(frame_window)
        seq = self.event.submit(event_window, deadline=deadline)
        self.frame.submit(frame_window, deadline=deadline)
        return seq

    # -- completion ------------------------------------------------------

    def absorb(self, results: List[StreamResult]) -> List[StreamResult]:
        """File this session's per-wing rows out of ``results``; returns
        the foreign rows (other streams on the shared engine)."""
        foreign = []
        for r in results:
            if r.stream_id == self.event.stream_id:
                self._pending["event"][r.seq] = r
            elif r.stream_id == self.frame.stream_id:
                self._pending["frame"][r.seq] = r
            else:
                foreign.append(r)
        return foreign

    def drain(self) -> List[StreamResult]:
        """Emit every buffered tick whose two halves have both landed, in
        tick order. ``step()``/``run()`` call this; call it directly when
        routing results between several sessions on one engine
        (``other.absorb(...)`` then ``other.drain()``)."""
        out = []
        while (self._emit_next in self._pending["event"]
               and self._emit_next in self._pending["frame"]):
            e = self._pending["event"].pop(self._emit_next)
            f = self._pending["frame"].pop(self._emit_next)
            out.append(self._emit_tick(e, f))
            self._emit_next += 1
        return out

    def _emit_tick(self, e: StreamResult, f: StreamResult) -> StreamResult:
        """One tick's row: fused, degraded (one wing failed) or failed."""
        seq = self._emit_next
        for wing, row in (("event", e), ("frame", f)):
            if not row.ok:
                self.wing_failures[wing] += 1
        if e.ok and f.ok:
            self.ticks_fused += 1
            return StreamResult(
                stream_id=self.session_id, seq=seq,
                result=self._fuse(e.result, f.result), modality="fusion")
        if e.ok or f.ok:
            ok_wing, ok_row = ("event", e) if e.ok else ("frame", f)
            bad_wing, bad_row = ("frame", f) if e.ok else ("event", e)
            self.ticks_degraded += 1
            degraded = dataclasses.replace(
                ok_row.result,
                breakdown={**ok_row.result.breakdown,
                           "degraded_wing": bad_wing,
                           "surviving_wing": ok_wing,
                           "wing_error": bad_row.error})
            return StreamResult(
                stream_id=self.session_id, seq=seq, result=degraded,
                modality="fusion", status="degraded",
                error=f"{bad_wing} wing failed: {bad_row.error}")
        self.ticks_failed += 1
        return StreamResult(
            stream_id=self.session_id, seq=seq, result=None,
            modality="fusion", status="failed",
            error=(f"both wings failed: event: {e.error}; "
                   f"frame: {f.error}"))

    def _fuse(self, e: ClosedLoopResult,
              f: ClosedLoopResult) -> ClosedLoopResult:
        logits = np.asarray(self.fusion(e, f))
        pwm = pwm_from_logits(torch.from_numpy(
            np.ascontiguousarray(logits, np.float32))).numpy()
        return ClosedLoopResult(
            label_pred=np.argmax(logits, axis=-1),
            pwm=pwm,
            # The wings run concurrently (one engine call per lane per
            # step): the tick completes when the slower wing does.
            latency_ms=max(e.latency_ms, f.latency_ms),
            energy_mj=e.energy_mj + f.energy_mj,
            breakdown={
                "fusion_rule": _rule_name(self.fusion) or repr(self.fusion),
                "per_wing_energy_mj": {"event": e.energy_mj,
                                       "frame": f.energy_mj},
                "per_wing_latency_ms": {"event": e.latency_ms,
                                        "frame": f.latency_ms},
                "event": e.breakdown,
                "frame": f.breakdown,
            },
            realtime=e.realtime and f.realtime,
            sustained_rate_hz=min(e.sustained_rate_hz, f.sustained_rate_hz),
            logits=logits,
        )

    def step(self) -> List[StreamResult]:
        """One engine step; returns any newly complete fused ticks."""
        self.unclaimed.extend(self.absorb(self.engine.step()))
        return self.drain()

    def run(self) -> List[StreamResult]:
        """Drain the engine; returns this session's fused ticks in order
        (foreign results accumulate on ``unclaimed``)."""
        self.unclaimed.extend(self.absorb(self.engine.run()))
        return self.drain()

    # -- lifecycle -------------------------------------------------------

    @property
    def stats(self) -> dict:
        """Per-wing accounting plus the fused/degraded tick counts."""
        return {"event": self.event.stats, "frame": self.frame.stats,
                "ticks_fused": self.ticks_fused,
                "ticks_degraded": self.ticks_degraded,
                "ticks_failed": self.ticks_failed,
                "wing_failures": dict(self.wing_failures)}

    def wing_health(self) -> dict:
        """Per wing: its lane's fault telemetry (dead, retries,
        quarantined, fault rate) and this session's failures seen."""
        out = {}
        for wing, handle in (("event", self.event), ("frame", self.frame)):
            tel = self.engine.telemetry(handle.modality)
            out[wing] = {
                "dead": tel.dead,
                "retries": tel.retries,
                "quarantined": tel.quarantined,
                "fault_rate": tel.fault_rate,
                "failures_seen": self.wing_failures[wing],
            }
        return out

    def reset_state(self) -> None:
        """Gesture boundary across the whole session: zero both wings'
        carries (a no-op for wings opened stateless)."""
        for handle in (self.event, self.frame):
            if handle.stateful:
                handle.reset_state()

    def checkpoint(self) -> dict:
        """Both wings' checkpoints and the session's tick cursor (host
        values; see :meth:`restore`). Raises while half-fused ticks are
        buffered (run or step until drained first)."""
        if self._pending["event"] or self._pending["frame"]:
            raise ValueError(
                f"fusion session {self.session_id!r} has half-fused "
                f"ticks buffered; run()/step() until drained before "
                f"checkpointing")
        return {"session_id": self.session_id,
                "next_tick": self._emit_next,
                "fusion_rule": _rule_name(self.fusion),
                "event": self.event.checkpoint(),
                "frame": self.frame.checkpoint()}

    def checkpoint_to(self, store, ckpt_id: Optional[str] = None) -> str:
        """Put this session's checkpoint into a
        :class:`~repro_torch.fleet.store.CheckpointStore` as ONE blob (both
        wings restore or neither); returns its id."""
        return store.put(self.checkpoint(), ckpt_id)

    @classmethod
    def restore_from(cls, engine: StreamEngine, store, ckpt_id: str, *,
                     fusion: Optional[Callable] = None) -> "FusionSession":
        """Restore a stored session checkpoint into ``engine`` and consume
        its id; a failed restore leaves the checkpoint in the store."""
        session = cls.restore(engine, store.get(ckpt_id), fusion=fusion)
        store.consume(ckpt_id)
        return session

    @classmethod
    def restore(cls, engine: StreamEngine, ckpt: dict, *,
                fusion: Optional[Callable] = None) -> "FusionSession":
        """Rebuild a checkpointed session on ``engine``: both wing handles
        are restored and the tick cursor resumes, so fused ticks continue
        bitwise as in the uninterrupted run. A rule other than the default
        must be passed again as ``fusion`` (rules are code): a name that
        differs from the recorded one raises. A failed restore leaves no
        stream behind on ``engine``."""
        rule = fusion or late_logit_fusion()
        recorded = ckpt.get("fusion_rule")
        supplied = _rule_name(rule)
        if recorded is not None and recorded != supplied:
            raise ValueError(
                f"checkpoint was fused with rule {recorded!r} but "
                f"restore got {supplied!r}; pass fusion= matching the "
                f"original rule (rules are code, not data)")
        event_handle = engine.restore(ckpt["event"])
        try:
            frame_handle = engine.restore(ckpt["frame"])
        except Exception:
            event_handle.close()
            raise
        try:
            session = cls(engine, session_id=ckpt["session_id"],
                          fusion=rule, event_handle=event_handle,
                          frame_handle=frame_handle)
        except Exception:
            event_handle.close()
            frame_handle.close()
            raise
        session._emit_next = int(ckpt["next_tick"])
        return session

    def close(self) -> int:
        """Close both wing handles (which unpairs them); returns the
        discarded windows."""
        return self.event.close() + self.frame.close()
