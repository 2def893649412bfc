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

Not in this slice (see ROADMAP): ``StreamCheckpoint`` and session
checkpoint/restore (with item 7(a)), and ``wing_health`` and degraded
ticks, which need fault recovery (item 7(b)).
"""
from __future__ import annotations

from typing import Callable, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.core.pipeline import ClosedLoopResult, pwm_from_logits
from repro_torch.serving.stream import StreamEngine, StreamHandle, StreamResult

__all__ = ["FusionSession", "late_logit_fusion"]


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
    frame wing's carry is empty).
    """

    def __init__(
        self,
        engine: StreamEngine,
        *,
        session_id: Optional[Hashable] = None,
        stateful: bool = False,
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
            stateful=stateful)
        self.frame = frame_handle or engine.open(
            modality="frame", stream_id=f"{session_id}:frame",
            stateful=stateful)
        engine.pair_streams(self.event.stream_id, self.frame.stream_id)
        self._pending = {"event": {}, "frame": {}}
        self._emit_next = 0
        self.ticks_fused = 0
        self.unclaimed: List[StreamResult] = []

    # -- submission ------------------------------------------------------

    def submit(self, event_window, frame_window) -> int:
        """Queue one control tick: the paired event and frame windows.
        Returns the tick's sequence number (shared by both wings).

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
        seq = self.event.submit(event_window)
        self.frame.submit(frame_window)
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
            out.append(StreamResult(
                stream_id=self.session_id, seq=self._emit_next,
                result=self._fuse(e.result, f.result), modality="fusion"))
            self.ticks_fused += 1
            self._emit_next += 1
        return out

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
        """Per-wing accounting plus the fused tick count."""
        return {"event": self.event.stats, "frame": self.frame.stats,
                "ticks_fused": self.ticks_fused}

    def reset_state(self) -> None:
        """Gesture boundary across the whole session: zero both wings'
        carries (a no-op for wings opened stateless)."""
        for handle in (self.event, self.frame):
            if handle.stateful:
                handle.reset_state()

    def close(self) -> int:
        """Close both wing handles (which unpairs them); returns the
        discarded windows."""
        return self.event.close() + self.frame.close()
