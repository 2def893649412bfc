"""Continuous batching of sensor streams over per-engine batch slots.

Port of ``repro.serving.stream``. A stream is opened on one engine lane
(``StreamEngine.open(modality=...)`` -> :class:`StreamHandle`), windows
are submitted to it, and ``step()`` serves the head window of every
slotted stream in one engine call per lane per step. A lane is one
engine (the event wing, :class:`~repro_torch.core.pipeline.
BatchedClosedLoop`, or the frame wing, :class:`~repro_torch.core.engine.
FrameTCNEngine`, or any engine of the protocol) with its own slots:
``StreamEngine(params, cfg, config)`` builds one event lane,
``StreamEngine(engines=[...], config=...)`` one lane per engine, keyed by
its ``modality``. Slots are assigned by a :class:`SlotPolicy`
(:class:`FairQuantumPolicy` by default: pin a slot while its stream has
work, rotate after ``fair_quantum`` windows when others wait;
:class:`DeadlinePolicy` adds earliest-deadline-first with aging and a
hard wait bound). Windows of one stream are served strictly in order, at
most one per step.

Stateful streams carry the engine's state (the event wing's LIF
membranes; the frame wing carries nothing) from window to window. The
lane keeps a slot-major dict of device tensors beside its slots; state
follows the STREAM, not the slot: when a stream moves, its row is
gathered along (``torch.stack`` per layer, per block on a mesh); when
it loses its slot the row is parked; a slot admitting a new stream
starts from zero. No state tensor is ever written in place: a dispatch
reads the lane's state and returns new tensors, so a row kept aside
(parked, checkpointed, or held for a rollback) keeps its value.

Checkpoints. ``StreamHandle.checkpoint()`` captures a stream as a host
:class:`~repro_torch.serving.session.StreamCheckpoint` (its carry as
numpy arrays, still-queued windows, its sequence position);
``StreamEngine.restore(ckpt)`` replays it into a fresh engine, after
which the stream's results are bitwise those of the uninterrupted run.

Fusion pairs. ``pair_streams(a, b)`` binds two streams on different
lanes as the wings of one control tick (a
:class:`~repro_torch.serving.session.FusionSession` pairs its wings
itself). With ``EngineConfig.coschedule`` on, whenever one wing holds a
slot with work, its partner is pulled into its own lane for the same
step, so both halves of a tick land together; scheduling only, results
are unchanged. ``StreamStats.fusion_ticks``/``fusion_ticks_paired``
count the paired ticks and those whose wings shared one step.

``pipeline_depth >= 1`` dispatches each step without waiting for the
device and returns the results of the step dispatched ``pipeline_depth``
steps earlier: the same results, in the same order and bit for bit, as
the synchronous engine, with host packing of step k+1 overlapping the
device's work on step k. Carried state chains from dispatch to dispatch
on the device.

The cross-wing megastep. With ``EngineConfig.megastep`` (exactly one
event and one frame lane), a step in which both lanes have work runs both
wings' steps in one fused call: on the card one CUDA graph per ``(event
key, frame key)`` pair, captured next to the engines' own graphs and
replayed once per step; on the CPU the two run functions back to back.
Results are bitwise those of the two per-lane calls; a step with work on
one lane only takes the per-lane path.

Fleet hooks. Every completed window feeds a sliding-horizon sample on
its :class:`StreamStats` (``snapshot()`` derives windows/s, queue-depth
p95 and deadline-miss rate); ``telemetry(modality)`` aggregates a lane
into a :class:`LaneTelemetry` row. A finite deadline is an instant on
``StreamEngine.deadline_clock`` (``time.perf_counter`` by default): a
window collected after it counts as missed. ``resize_lane`` changes a
lane's slot count live (carries are parked, evicted streams rejoin the
front of the waiting line, and the new batch size's graphs are captured
at once through the engine's ``warmup``); ``drain_lane`` collects one
lane's in-flight steps; ``abort_lane`` drops them and re-queues their
windows; ``replace_lane_engine`` installs a rebuilt engine.

Fault recovery (``EngineConfig.recovery``, a
:class:`~repro_torch.core._api.RecoveryConfig`): a failed lane step is
retried after ``backoff_steps`` steps of cooldown (synchronous steps
leave the queues untouched; a pipelined collect failure re-queues the
record's windows with each stream's carry rolled back to its pre-window
value); a window failing ``max_retries`` times, or returning non-finite
logits, is quarantined to the lane's dead letters and emitted with
``status="failed"``, its stream kept alive from the pre-window carry;
``dead_after`` consecutive failed steps declare the lane dead, and it
fails queued windows fast until ``replace_lane_engine``. Each transition
is appended to ``StreamEngine.fault_log``. A failed fused megastep falls
back to the per-lane graphs for that step. Recovery retries and
quarantines windows; it never moves work off the card. With
``recovery=None`` an engine exception propagates.

Legacy forms. As in the JAX package, the pre-config construction kwargs
(``max_streams=``, ``policy=``, ``pipeline_depth=``, ...) build the same
``EngineConfig`` and warn once, and the id-keyed calls
(``submit(stream_id, window)``, ``stateful_of``, ``reset_state``,
``retire``) forward to the stream's handle, the first submit of an id
opening it; ``submit`` warns once per engine. ``handle(stream_id)`` and
``has_stream`` are the id lookups the fleet's rebalancer uses.

Slot sharding. ``EngineConfig.mesh`` (a :class:`~repro_torch.
distributed.mesh.Mesh` from ``make_mesh``) shards every lane's slot axis
over the mesh's slot axis: each engine runs a step as one shard per block
of slots, each on its own device (see ``core/pipeline.py``), bit for bit
the unsharded engine's rows. Slot gathers, parking and reassignment stay
row splices as on one device; a sharded lane's state planes are
:class:`~repro_torch.distributed.sharding.ShardedTensor` values, and a
gather builds each block on its own device. Every lane's slot count must
divide over the mesh's slot axis; exported carries are host numpy, so a
checkpoint crosses device counts.
"""
from __future__ import annotations

import dataclasses
import math
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, Hashable, List, Mapping,
                    Optional, Sequence, Union)

import numpy as np
import torch

from repro_torch.core._api import (EngineConfig, RecoveryConfig,
                                   warn_deprecated_call)
from repro_torch.core.energy import KrakenModel
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.graphs import GraphCache
from repro_torch.core.pipeline import (BatchedClosedLoop, ClosedLoopResult,
                                       _check_slot_divisible,
                                       export_state_slot, import_state_slot)
from repro_torch.core.snn import SNNConfig
from repro_torch.distributed.sharding import ShardedTensor

__all__ = ["StreamResult", "StreamStats", "StreamStatsSnapshot",
           "LaneTelemetry", "DeadLetter", "EngineLane", "SlotPolicy",
           "FairQuantumPolicy", "DeadlinePolicy", "StreamHandle",
           "StreamEngine", "EngineConfig", "RecoveryConfig"]

# Tells "kwarg not passed" from an explicit None in the legacy
# construction form (a legacy kwarg that is passed both warns and wins
# over the EngineConfig default).
_UNSET_KW = object()


@dataclasses.dataclass
class StreamResult:
    """One served window: which stream, which window index (the
    submission-time sequence number), and the closed-loop outcome.

    ``status`` is ``"ok"`` for a served window. Under fault recovery a
    quarantined or dead-lane window is still emitted, with
    ``status="failed"``, ``result=None`` and the reason in ``error``; a
    :class:`~repro_torch.serving.session.FusionSession` emits
    ``status="degraded"`` ticks when one wing failed."""

    stream_id: Hashable
    seq: int
    result: Optional[ClosedLoopResult]
    modality: str = "event"
    status: str = "ok"            # "ok" | "failed" | "degraded"
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass(frozen=True)
class DeadLetter:
    """One quarantined window on its lane's dead-letter queue: the window,
    its stream and sequence position, and why it was poisoned."""

    stream_id: Hashable
    seq: int
    modality: str
    item: Any
    deadline: Optional[float]
    error: str


@dataclasses.dataclass(frozen=True)
class StreamStatsSnapshot:
    """A frozen host view of one stream's accounting. Cumulative fields
    mirror :class:`StreamStats`; the ``horizon_*`` fields and the derived
    rates cover only the last ``horizon`` completions."""

    windows: int
    queued: int
    energy_mj: float
    mean_latency_ms: float
    realtime_fraction: float
    deadline_windows: int         # completed windows that carried a deadline
    deadline_missed: int          # ... collected after their deadline
    horizon: int                  # completions the sliding fields cover (max)
    horizon_windows: int          # completions actually in the window
    horizon_deadline_windows: int
    horizon_missed: int
    windows_per_s: float          # completion rate over the sliding window
    queue_depth_p95: float        # p95 of at-completion queue depths
    deadline_miss_rate: float     # horizon_missed / horizon_deadline_windows
    retries: int = 0              # failed dispatch/collect attempts
    quarantined: int = 0          # windows moved to the dead-letter queue
    fusion_ticks: int = 0         # paired-stream ticks observed at dispatch
    fusion_ticks_paired: int = 0  # ... whose wings shared one engine step
    paired_tick_rate: float = 1.0  # paired / observed (1.0 when unpaired)


@dataclasses.dataclass
class StreamStats:
    """Per-stream accounting, accumulated as windows complete.

    Besides the cumulative counters, every completion is sampled into a
    sliding window of the ``horizon`` most recent completions (wall time,
    queue depth left behind, deadline outcome), from which
    :meth:`snapshot` derives the recent rates."""

    windows: int = 0
    energy_mj: float = 0.0
    latency_ms_sum: float = 0.0
    realtime_windows: int = 0
    queued: int = 0               # still waiting in this stream's queue
    deadline_windows: int = 0     # completed windows that had a deadline
    deadline_missed: int = 0      # ... that completed past it
    retries: int = 0              # failed attempts charged to this stream
    quarantined: int = 0          # windows dead-lettered
    fusion_ticks: int = 0         # ticks of a paired (fusion) stream seen
    fusion_ticks_paired: int = 0  # ... both wings dispatched the same step
    horizon: int = 64             # sliding-window length (completions)
    samples: Deque = dataclasses.field(default_factory=deque, repr=False)

    def __post_init__(self):
        self.samples = deque(self.samples, maxlen=self.horizon)

    def note_completion(self, wall_t: float, queue_depth: int,
                        missed: Optional[bool]) -> None:
        """Record one completed window: wall-clock instant, the queue depth
        it left behind, and its deadline outcome (``None`` = the window
        carried no deadline)."""
        if missed is not None:
            self.deadline_windows += 1
            if missed:
                self.deadline_missed += 1
        self.samples.append((wall_t, queue_depth, missed))

    @property
    def paired_tick_rate(self) -> float:
        """Fraction of this stream's fusion ticks whose two wings shared
        one engine step (1.0 when it saw none)."""
        return (self.fusion_ticks_paired / self.fusion_ticks
                if self.fusion_ticks else 1.0)

    @property
    def mean_latency_ms(self) -> float:
        return self.latency_ms_sum / self.windows if self.windows else 0.0

    @property
    def realtime_fraction(self) -> float:
        return self.realtime_windows / self.windows if self.windows else 0.0

    @property
    def mean_power_mw(self) -> float:
        """Average power while processing (energy over busy time)."""
        return (self.energy_mj / (self.latency_ms_sum * 1e-3)
                if self.latency_ms_sum else 0.0)

    def snapshot(self) -> StreamStatsSnapshot:
        """Freeze a consistent view with derived sliding-horizon rates."""
        samples = list(self.samples)
        n = len(samples)
        span = samples[-1][0] - samples[0][0] if n >= 2 else 0.0
        wps = (n - 1) / span if span > 0.0 else 0.0
        depths = sorted(s[1] for s in samples)
        p95 = (float(depths[max(0, math.ceil(0.95 * n) - 1)])
               if depths else 0.0)
        dated = [s[2] for s in samples if s[2] is not None]
        missed = sum(1 for m in dated if m)
        return StreamStatsSnapshot(
            windows=self.windows, queued=self.queued,
            energy_mj=self.energy_mj,
            mean_latency_ms=self.mean_latency_ms,
            realtime_fraction=self.realtime_fraction,
            deadline_windows=self.deadline_windows,
            deadline_missed=self.deadline_missed,
            horizon=self.horizon, horizon_windows=n,
            horizon_deadline_windows=len(dated), horizon_missed=missed,
            windows_per_s=wps, queue_depth_p95=p95,
            deadline_miss_rate=missed / len(dated) if dated else 0.0,
            retries=self.retries, quarantined=self.quarantined,
            fusion_ticks=self.fusion_ticks,
            fusion_ticks_paired=self.fusion_ticks_paired,
            paired_tick_rate=self.paired_tick_rate)


@dataclasses.dataclass(frozen=True)
class LaneTelemetry:
    """One engine lane, aggregated for the fleet control plane.

    ``backlog_per_slot`` is the autoscaler's grow signal;
    ``deadline_miss_rate`` pools every stream's sliding horizon;
    ``streams`` holds the per-stream snapshots the aggregate was computed
    from."""

    modality: str
    slots: int
    occupied: int                 # slots currently pinned to a stream
    waiting: int                  # streams in the waiting line
    queued: int                   # windows queued across the lane
    in_flight: int                # dispatched-but-uncollected windows
    windows: int                  # completed windows (cumulative)
    windows_per_s: float          # summed sliding-horizon completion rate
    deadline_miss_rate: float     # pooled over the streams' horizons
    streams: Dict[Hashable, StreamStatsSnapshot] = dataclasses.field(
        default_factory=dict)
    retries: int = 0              # cumulative failed attempts on the lane
    quarantined: int = 0          # cumulative dead-lettered windows
    dead: bool = False            # lane declared dead (fail-fast mode)
    paired_tick_rate: float = 1.0  # fusion ticks co-scheduled, pooled

    @property
    def fault_rate(self) -> float:
        """Retries + quarantines per completed-or-quarantined window."""
        denom = self.windows + self.quarantined
        return ((self.retries + self.quarantined) / denom
                if denom else 0.0)

    @property
    def backlog_per_slot(self) -> float:
        return self.queued / self.slots if self.slots else 0.0

    @property
    def occupancy(self) -> float:
        return self.occupied / self.slots if self.slots else 0.0


class _FreeSlot:
    """Sentinel for an unassigned batch slot (distinct from any stream id,
    including ``None``)."""

    def __repr__(self):
        return "<free slot>"


_FREE = _FreeSlot()


@dataclasses.dataclass
class _Queued:
    """One queued submission: the item, its sequence number and its
    deadline."""

    item: Any
    seq: int
    deadline: Optional[float] = None


@dataclasses.dataclass
class _InflightLane:
    """One lane's share of a dispatched, not yet collected step.

    ``entries`` is slot-aligned: ``(stream_id, seq, deadline)`` per served
    slot, ``None`` per empty one. ``kind`` is ``"results"`` (synchronous
    mode: finished results), ``"handle"`` (the engine's pending handle) or
    ``"batch"`` (a prepared batch of an engine without the
    dispatch/collect split, inferred at collect). ``items`` keeps the
    popped :class:`_Queued` entries slot-aligned, so a failed record can
    re-queue its windows; with recovery on, ``prev_carry`` maps each
    dispatched stateful stream to its pre-window carry (rows of the state
    the dispatch read, which nothing writes), the value a quarantine or a
    retry rolls back to."""

    lane: "EngineLane"
    key: Hashable
    entries: List[Optional[tuple]]
    kind: str
    pending: Any
    items: Optional[List[Optional[_Queued]]] = None
    prev_carry: Optional[Dict[Hashable, Any]] = None


@dataclasses.dataclass
class EngineLane:
    """One engine's scheduling state: its slots, queues and waiting line.

    ``state`` is the slot-major dict of device tensors fed to the next
    dispatch; ``state_streams`` says, per row, which stateful stream's
    carry the row holds (rows of stateless or free slots are dead);
    ``parked`` holds the carries of stateful streams without a slot.
    A stateful stream's carry lives in exactly one of a state row or
    ``parked`` (or nowhere: cold start). The fault fields move only under
    a :class:`~repro_torch.core._api.RecoveryConfig`.
    """

    modality: str
    engine: InferenceEngine
    slots: List[Hashable]
    slot_runs: List[int]
    waiting: Deque[Hashable]
    queues: Dict[Hashable, Deque[_Queued]]
    shape_keys: set
    supports_state: bool = False
    stateful: set = dataclasses.field(default_factory=set)
    state: Any = None
    state_streams: List[Hashable] = dataclasses.field(default_factory=list)
    parked: Dict[Hashable, Any] = dataclasses.field(default_factory=dict)
    zero_state: Any = None
    dead: bool = False            # fail-fast mode until engine replaced
    fail_streak: int = 0          # consecutive failed lane steps
    cooldown: int = 0             # backoff steps left before redispatch
    retries: Dict[tuple, int] = dataclasses.field(default_factory=dict)
    dead_letter: Deque = dataclasses.field(default_factory=deque)
    n_retries: int = 0            # cumulative, for telemetry
    n_quarantined: int = 0

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())


class SlotPolicy:
    """Decides which streams hold an engine's batch slots each step.

    ``assign(lane)`` runs once per step before the batch is gathered: it
    frees slots and fills free slots from the waiting line, keeping every
    schedulable stream in exactly one of a held slot or the waiting line.
    A policy with per-stream bookkeeping implements ``forget(stream_id)``,
    which the engine calls when a stream closes.
    """

    def assign(self, lane: EngineLane) -> None:
        raise NotImplementedError


class FairQuantumPolicy(SlotPolicy):
    """The default: pin-until-drained with a fairness quantum.

    A slot stays pinned to its stream while the stream has queued windows;
    it goes to the next waiting stream when the stream drains, or after
    ``fair_quantum`` consecutive windows when others wait (the pinned
    stream moves to the back of the line). Free slots fill in arrival
    order. No stream starves under continuous submission.
    """

    def __init__(self, fair_quantum: int = 4):
        if fair_quantum < 1:
            raise ValueError(
                f"fair_quantum must be >= 1, got {fair_quantum}")
        self.fair_quantum = fair_quantum

    def assign(self, lane: EngineLane) -> None:
        contended = any(lane.queues[s] for s in lane.waiting)
        for i, sid in enumerate(lane.slots):
            if sid is _FREE:
                continue
            if not lane.queues[sid]:
                lane.slots[i] = _FREE
                lane.slot_runs[i] = 0
            elif contended and lane.slot_runs[i] >= self.fair_quantum:
                lane.waiting.append(sid)
                lane.slots[i] = _FREE
                lane.slot_runs[i] = 0
        self._note_round(lane)
        for i, sid in enumerate(lane.slots):
            if sid is _FREE:
                cand = self._take(lane)
                if cand is None:
                    break
                lane.slots[i] = cand
                lane.slot_runs[i] = 0

    def _note_round(self, lane: EngineLane) -> None:
        """Hook: once per round, after rotation, before any slot fills."""

    def _take(self, lane: EngineLane) -> Optional[Hashable]:
        """Pop the next waiting stream with queued work; drained entries
        are dropped (they re-enter on their next submit)."""
        while lane.waiting:
            cand = lane.waiting.popleft()
            if lane.queues[cand]:
                return cand
        return None


class DeadlinePolicy(FairQuantumPolicy):
    """Earliest-deadline-first slot assignment with aging and a wait bound.

    Windows carry an optional ``deadline`` (any consistent unit; smaller =
    more urgent; ``None`` = slack). Free slots go to the waiting stream
    whose head window has the earliest effective deadline, ``deadline -
    aging * rounds_passed_over`` (``None`` after every finite deadline).
    A live waiting stream passed over ``max_wait`` times is served next
    whatever the deadlines, so with the inherited fairness quantum every
    stream gets a slot within ``O(max_wait * fair_quantum)`` steps.
    """

    _NO_DEADLINE = math.inf

    def __init__(self, fair_quantum: int = 4, *, aging: float = 1.0,
                 max_wait: int = 16):
        super().__init__(fair_quantum)
        if aging < 0:
            raise ValueError(f"aging must be >= 0, got {aging}")
        if max_wait < 1:
            raise ValueError(f"max_wait must be >= 1, got {max_wait}")
        self.aging = aging
        self.max_wait = max_wait
        self._waited: Dict[Hashable, int] = {}

    def _note_round(self, lane: EngineLane) -> None:
        """Drop drained waiting entries and age every live waiting stream
        by one round, however many slots the round fills."""
        live = [sid for sid in lane.waiting if lane.queues[sid]]
        if len(live) != len(lane.waiting):
            dropped = set(lane.waiting) - set(live)
            lane.waiting.clear()
            lane.waiting.extend(live)
            for sid in dropped:
                self._waited.pop(sid, None)
        for sid in live:
            self._waited[sid] = self._waited.get(sid, 0) + 1

    def _take(self, lane: EngineLane) -> Optional[Hashable]:
        best = None
        best_key = None
        for pos, sid in enumerate(lane.waiting):
            if not lane.queues[sid]:
                continue        # submitted mid-round; picked next round
            waited = self._waited.get(sid, 0)
            if waited >= self.max_wait:
                key = (-1, -waited, pos)
            else:
                head = lane.queues[sid][0].deadline
                base = self._NO_DEADLINE if head is None else head
                key = (0, base - self.aging * waited, pos)
            if best is None or key < best_key:
                best, best_key = sid, key
        if best is None:
            return None
        lane.waiting.remove(best)
        self._waited.pop(best, None)
        return best

    def forget(self, stream_id: Hashable) -> None:
        """Drop the stream's aging counter (called on close, so a reused
        id starts fresh)."""
        self._waited.pop(stream_id, None)


def _stack_rows(rows: List[torch.Tensor], like):
    """Per-slot rows stacked into a new slot-major plane laid out as
    ``like``: a sharded plane's blocks are each stacked on their own
    device, from rows that may sit on any device."""
    if isinstance(like, ShardedTensor):
        return ShardedTensor.from_rows(rows, like.sharding)
    return torch.stack(rows)


def _engine_devices(engine) -> tuple:
    """The devices an engine runs on (every shard's on a mesh)."""
    devices = getattr(engine, "devices", None)
    if devices is not None:
        return tuple(devices)
    device = getattr(engine, "device", None)
    return () if device is None else (torch.device(device),)


def _export_carry(engine: InferenceEngine, state, slot: int):
    """One slot's carry as host numpy arrays, through the engine's
    ``export_state`` (a device-to-host copy that waits for the device)."""
    export = getattr(engine, "export_state", export_state_slot)
    return export(state, slot)


def _import_carry(engine: InferenceEngine, payload):
    """An exported carry back on the engine's device, in the parked form
    (per stream, no slot axis): ``import_state`` into a 1-slot zero
    state, then row 0."""
    import_ = getattr(engine, "import_state", import_state_slot)
    lifted = import_(engine.init_state(1), 0, payload)
    return {k: a[0] for k, a in lifted.items()}


class StreamHandle:
    """One stream's lifecycle: what ``StreamEngine.open`` returns.

    ``submit(window[, deadline=])`` queues a window and returns its
    sequence number; ``reset_state()`` zeroes a stateful stream's carry;
    ``checkpoint()`` captures the stream as a host
    :class:`~repro_torch.serving.session.StreamCheckpoint` and
    ``restore(ckpt)`` replays one into this (fresh) handle; ``close()``
    retires the stream. Results come from the engine's
    ``step``/``run``/``flush``.
    """

    def __init__(self, engine: "StreamEngine", lane: EngineLane,
                 stream_id: Hashable, stateful: bool,
                 deadline: Optional[float] = None):
        self._engine = engine
        self._lane = lane
        self.stream_id = stream_id
        self.stateful = bool(stateful)
        self.deadline = deadline
        self.closed = False

    def __repr__(self):
        state = "closed" if self.closed else "open"
        return (f"<StreamHandle {self.stream_id!r} {self._lane.modality} "
                f"stateful={self.stateful} {state}>")

    @property
    def modality(self) -> str:
        """The lane (engine modality) serving this stream."""
        return self._lane.modality

    @property
    def engine(self) -> "StreamEngine":
        """The owning engine (completion and lane-control surface)."""
        return self._engine

    @property
    def stats(self) -> StreamStats:
        return self._engine.stream_stats[self.stream_id]

    @property
    def queued(self) -> int:
        return 0 if self.closed else len(self._lane.queues[self.stream_id])

    @property
    def next_seq(self) -> int:
        """The sequence number the next ``submit`` will return."""
        self._check_open()
        return self._engine._seq[self.stream_id]

    def _check_open(self) -> None:
        if self.closed:
            raise ValueError(
                f"handle for stream {self.stream_id!r} is closed")

    def _check_not_inflight(self, verb: str) -> None:
        for step_recs in self._engine._inflight:
            for rec in step_recs:
                for entry in rec.entries:
                    if entry is not None and entry[0] == self.stream_id:
                        raise ValueError(
                            f"stream {self.stream_id!r} has in-flight "
                            f"windows; flush() before {verb}")

    def validate(self, window: Any) -> None:
        """Check ``window`` against this stream's engine without queueing
        it (raises what ``submit`` would), so a caller submitting to
        several handles can validate every window before queueing any."""
        self._check_open()
        self._lane.engine.validate(window)

    def submit(self, window: Any, *,
               deadline: Optional[float] = None) -> int:
        """Queue one window; returns its per-stream sequence number.
        ``deadline`` overrides the handle's default for this window. The
        engine validates the window before any queue state moves, so a
        rejected submit burns no sequence number."""
        self._check_open()
        lane, sid, eng = self._lane, self.stream_id, self._engine
        lane.engine.validate(window)
        seq = eng._seq[sid]
        eng._seq[sid] = seq + 1
        lane.queues[sid].append(_Queued(
            window, seq, self.deadline if deadline is None else deadline))
        if sid not in lane.slots and sid not in lane.waiting:
            lane.waiting.append(sid)
        eng.stream_stats[sid].queued += 1
        return seq

    def reset_state(self) -> None:
        """Zero the carried state (a gesture boundary). Applies from the
        next dispatch; windows already in flight keep the old carry."""
        self._check_open()
        lane, sid = self._lane, self.stream_id
        if not self.stateful:
            raise ValueError(f"stream {sid!r} is not stateful")
        lane.parked.pop(sid, None)
        for j, owner in enumerate(lane.state_streams):
            if owner is not _FREE and owner == sid:
                lane.state_streams[j] = _FREE

    def checkpoint(self):
        """Capture this stream for migration: its carry (host numpy, from
        its state row or its parked carry; ``None`` for a cold start), the
        still-queued windows and the sequence position. The engine keeps
        serving the stream: a checkpoint is a copy. Raises while the
        stream has windows in flight (``flush()`` or ``drain_lane()``
        first)."""
        self._check_open()
        self._check_not_inflight("checkpointing")
        from repro_torch.serving.session import StreamCheckpoint
        lane, sid = self._lane, self.stream_id
        payload = None
        if self.stateful:
            row = next((j for j, owner in enumerate(lane.state_streams)
                        if owner is not _FREE and owner == sid), None)
            if row is not None:
                payload = _export_carry(lane.engine, lane.state, row)
            elif sid in lane.parked:
                lifted = {k: a[None] for k, a in lane.parked[sid].items()}
                payload = _export_carry(lane.engine, lifted, 0)
        return StreamCheckpoint(
            stream_id=sid, modality=lane.modality, stateful=self.stateful,
            next_seq=self._engine._seq[sid],
            duration_us=lane.engine.duration_us, state=payload,
            deadline=self.deadline,
            queued=tuple((q.item, q.seq, q.deadline)
                         for q in lane.queues[sid]))

    def restore(self, ckpt) -> "StreamHandle":
        """Replay ``ckpt`` into this handle; returns the handle.

        The handle must be fresh (nothing submitted, no carry) and match
        the checkpoint's modality and statefulness; the lane's engine must
        agree on ``duration_us`` (an unlatched engine latches the
        checkpoint's). The carry is imported and parked until the stream
        wins a slot, and the queued windows are re-queued under their
        sequence numbers. A rejected restore leaves the engine as it was.
        """
        self._check_open()
        lane, sid, eng = self._lane, self.stream_id, self._engine
        if (eng._seq[sid] != 0 or lane.queues[sid] or sid in lane.parked
                or any(o is not _FREE and o == sid
                       for o in lane.state_streams)):
            raise ValueError(
                f"restore needs a fresh handle; stream {sid!r} already "
                f"has submitted windows or a carry")
        if ckpt.modality != lane.modality:
            raise ValueError(
                f"checkpoint is {ckpt.modality!r}, handle is bound to "
                f"{lane.modality!r}")
        if bool(ckpt.stateful) != self.stateful:
            raise ValueError(
                f"checkpoint stateful={ckpt.stateful} != handle "
                f"stateful={self.stateful}; open the handle to match")
        prev_duration = lane.engine.duration_us
        try:
            if ckpt.duration_us is not None:
                if lane.engine.duration_us is None:
                    lane.engine.duration_us = ckpt.duration_us
                elif lane.engine.duration_us != ckpt.duration_us:
                    raise ValueError(
                        f"checkpoint duration_us={ckpt.duration_us} != "
                        f"engine duration_us={lane.engine.duration_us}")
            for item, _seq, _deadline in ckpt.queued:
                lane.engine.validate(item)
        except Exception:
            lane.engine.duration_us = prev_duration
            raise
        if ckpt.state is not None:
            lane.parked[sid] = _import_carry(lane.engine, ckpt.state)
        eng._seq[sid] = int(ckpt.next_seq)
        if self.deadline is None:
            self.deadline = ckpt.deadline
        for item, seq, deadline in ckpt.queued:
            lane.queues[sid].append(_Queued(item, seq, deadline))
            eng.stream_stats[sid].queued += 1
        if lane.queues[sid] and sid not in lane.slots \
                and sid not in lane.waiting:
            lane.waiting.append(sid)
        return self

    def close(self) -> int:
        """Retire the stream: queue, slot, waiting entry and carry. Returns
        the number of windows discarded, in-flight ones included (their
        results are never emitted; lane-mates in the same steps are
        untouched). Closing a closed handle returns 0."""
        if self.closed:
            return 0
        lane, sid, eng = self._lane, self.stream_id, self._engine
        dropped = 0
        for step_recs in eng._inflight:
            for rec in step_recs:
                if rec.lane is not lane:
                    continue
                for i, entry in enumerate(rec.entries):
                    if entry is not None and entry[0] == sid:
                        rec.entries[i] = None
                        if rec.items is not None:
                            rec.items[i] = None
                        dropped += 1
        queued_dropped = len(lane.queues.pop(sid))
        dropped += queued_dropped
        if sid in lane.waiting:
            lane.waiting.remove(sid)
        for i, owner in enumerate(lane.slots):
            if owner is not _FREE and owner == sid:
                lane.slots[i] = _FREE
                lane.slot_runs[i] = 0
        for j, owner in enumerate(lane.state_streams):
            if owner is not _FREE and owner == sid:
                lane.state_streams[j] = _FREE
        lane.parked.pop(sid, None)
        lane.stateful.discard(sid)
        for key in [k for k in lane.retries if k[0] == sid]:
            del lane.retries[key]
        eng.unpair_streams(sid)
        del eng._stream_lane[sid]
        eng._seq.pop(sid, None)
        eng._handles.pop(sid, None)
        eng.stream_stats[sid].queued -= queued_dropped
        forget = getattr(eng.policy, "forget", None)
        if forget is not None:
            forget(sid)
        self.closed = True
        return dropped


class StreamEngine:
    """Continuous batching of sensor windows over per-engine batch slots.

    Two construction forms, both configured by one
    :class:`~repro_torch.core._api.EngineConfig`:

      * ``StreamEngine(params, cfg, config, device=None)`` builds one
        :class:`~repro_torch.core.pipeline.BatchedClosedLoop` on
        ``device`` (``None`` = ``cuda``; without a card only
        ``device="cpu"`` works);
      * ``StreamEngine(engines=[event_engine, frame_engine],
        config=...)`` serves any set of engines, one lane (slots and one
        engine call per step) per engine, keyed by its ``modality``; the
        engines carry their own device.

    ``EngineConfig`` supplies ``max_streams`` (slots per lane, or a
    ``{modality: count}`` mapping whose missing lanes get 8),
    ``duration_us``, ``policy``/``fair_quantum``, ``pipeline_depth``,
    ``window_ms``, ``recovery``, ``coschedule`` and ``megastep`` (see the
    module docstring); ``fuse_fc`` selects nothing for the built event
    engine (fc1/fc2 always run through kernel K2, which is what either
    value computes) and, as in the JAX package, is refused with
    ``engines=``.

    The pre-config kwargs (``max_streams=``, ``fair_quantum=``,
    ``policy=``, ``duration_us=``, ``window_ms=``, ``fuse_fc=``,
    ``pipeline_depth=``) still work: without ``config=`` they build the
    same ``EngineConfig`` (bitwise-identical engines) and warn once per
    engine; with ``config=`` they raise ``ValueError``. ``device=`` and
    ``model=`` go with either form.

    ``config.mesh`` shards every lane's slot axis over the mesh (see the
    module docstring): the built event engine is built on it, and
    caller-provided engines are attached through their ``attach_mesh``
    (an engine without one, or attached to a different mesh, is
    refused). Every lane's slot count must divide over the mesh's slot
    axis.
    """

    def __init__(
        self,
        params=None,
        cfg: Optional[SNNConfig] = None,
        config: Optional[EngineConfig] = None,
        *,
        engines: Union[None, InferenceEngine, Sequence[InferenceEngine],
                       Mapping[str, InferenceEngine]] = None,
        model: Optional[KrakenModel] = None,
        device=None,
        max_streams=_UNSET_KW,
        fair_quantum=_UNSET_KW,
        policy=_UNSET_KW,
        duration_us=_UNSET_KW,
        window_ms=_UNSET_KW,
        fuse_fc=_UNSET_KW,
        pipeline_depth=_UNSET_KW,
    ):
        legacy = {k: v for k, v in dict(
            max_streams=max_streams, fair_quantum=fair_quantum,
            policy=policy, duration_us=duration_us, window_ms=window_ms,
            fuse_fc=fuse_fc, pipeline_depth=pipeline_depth,
        ).items() if v is not _UNSET_KW}
        if config is not None:
            if not isinstance(config, EngineConfig):
                raise TypeError(f"config must be an EngineConfig, got "
                                f"{type(config).__name__}")
            if legacy:
                raise ValueError(
                    f"config= and legacy construction kwargs are "
                    f"mutually exclusive (got both config= and "
                    f"{sorted(legacy)}); fold the kwargs into the "
                    f"EngineConfig")
        else:
            if legacy:
                warn_deprecated_call(
                    self, "kwargs-construction",
                    "StreamEngine construction kwargs (max_streams=, "
                    "policy=, pipeline_depth=, ...) are a legacy "
                    "spelling; pass one EngineConfig instead: "
                    "StreamEngine(params, cfg, EngineConfig(...)) / "
                    "StreamEngine(engines=..., config=EngineConfig(...))")
            config = EngineConfig(**legacy)
        if engines is None:
            if params is None or cfg is None:
                raise ValueError("give (params, cfg) or engines=")
            engines = [BatchedClosedLoop.from_config(
                params, cfg, config, model=model, device=device)]
        else:
            if params is not None or cfg is not None:
                raise ValueError("(params, cfg) and engines= are mutually "
                                 "exclusive")
            if device is not None or model is not None:
                raise ValueError("device= and model= configure the built "
                                 "event engine; engines= carry their own")
            if config.fuse_fc:
                raise ValueError(
                    "fuse_fc configures the internally-built event "
                    "engine; with engines= build the BatchedClosedLoop "
                    "yourself")
            if isinstance(engines, Mapping):
                engines = list(engines.values())
            elif not isinstance(engines, Sequence):
                engines = [engines]
            for e in engines:
                if config.duration_us is None:
                    continue
                if e.duration_us is None:
                    e.duration_us = config.duration_us
                elif e.duration_us != config.duration_us:
                    raise ValueError(
                        f"engine {e.modality!r} duration {e.duration_us} != "
                        f"duration_us={config.duration_us}")
            if config.mesh is not None:
                for e in engines:
                    self._attach_mesh(e, config.mesh)
        if not engines:
            raise ValueError("engines= must name at least one engine")
        max_streams = config.max_streams
        if isinstance(max_streams, Mapping):
            unknown = set(max_streams) - {e.modality for e in engines}
            if unknown:
                raise ValueError(
                    f"max_streams keys {sorted(unknown)} match no engine "
                    f"modality (have "
                    f"{sorted(e.modality for e in engines)})")
        self.config = config
        self.mesh = config.mesh
        self.pipeline_depth = config.pipeline_depth
        self.recovery: Optional[RecoveryConfig] = config.recovery
        # Every recovery transition, in order: {"step", "kind": "retry" |
        # "quarantine" | "lane_dead" | "requeue" | "lane_replaced",
        # "modality", "stream", "seq", "error"}.
        self.fault_log: List[dict] = []
        # Failed results made during dispatch (synchronous retry
        # exhaustion, dead-lane fail-fast), emitted by the next step().
        self._pending_failures: List[StreamResult] = []
        self.policy = config.policy or FairQuantumPolicy(
            4 if config.fair_quantum is None else config.fair_quantum)
        self._lanes: Dict[str, EngineLane] = {}
        for e in engines:
            if e.modality in self._lanes:
                raise ValueError(f"duplicate engine modality {e.modality!r}")
            slots = (max_streams.get(e.modality, 8)
                     if isinstance(max_streams, Mapping) else max_streams)
            if slots < 1:
                raise ValueError(f"max_streams must be >= 1, got {slots}")
            if self.mesh is not None:
                _check_slot_divisible(slots, self.mesh,
                                      f"lane '{e.modality}'")
            self._lanes[e.modality] = EngineLane(
                modality=e.modality, engine=e,
                slots=[_FREE] * slots, slot_runs=[0] * slots,
                waiting=deque(), queues={}, shape_keys=set(),
                supports_state=hasattr(e, "init_state"),
                state_streams=[_FREE] * slots)
        # Fusion pairing: ``_pairs`` maps each paired stream to its
        # partner (both directions); ``_pair_dispatch`` holds the step a
        # paired window was dispatched at until its partner's same-seq
        # window dispatches.
        self.coschedule = bool(config.coschedule)
        self._pairs: Dict[Hashable, Hashable] = {}
        self._pair_dispatch: Dict[tuple, int] = {}
        self._dispatch_no = 0
        # The fused cross-wing megastep: one captured step serving both
        # wings' kernels, cached per (event shape key, frame shape key)
        # apart from the engines' own graphs.
        self.megastep = bool(config.megastep)
        self._mega_graphs: Optional[GraphCache] = None
        if self.megastep:
            if sorted(self._lanes) != ["event", "frame"]:
                raise ValueError(
                    f"EngineConfig.megastep needs exactly one event and "
                    f"one frame lane; this engine has "
                    f"{sorted(self._lanes)}")
            for lane in self._lanes.values():
                if not hasattr(lane.engine, "_mega_parts"):
                    raise ValueError(
                        f"engine for modality {lane.modality!r} "
                        f"({type(lane.engine).__name__}) does not "
                        f"support the fused megastep")
                if getattr(lane.engine, "mesh", None) is not None:
                    raise ValueError(
                        f"engine for modality {lane.modality!r} is "
                        f"attached to a mesh; the fused megastep is "
                        f"single-device")
            devices = {str(lane.engine.device)
                       for lane in self._lanes.values()}
            if len(devices) != 1:
                raise ValueError(
                    f"EngineConfig.megastep needs both engines on one "
                    f"device; they are on {sorted(devices)}")
            self._mega_graphs = GraphCache(
                self._lanes["event"].engine.device)
        self._inflight: Deque[List[_InflightLane]] = deque()
        self._stream_lane: Dict[Hashable, str] = {}
        self._seq: Dict[Hashable, int] = {}
        self._handles: Dict[Hashable, StreamHandle] = {}
        self._auto_id = 0
        self.stream_stats: Dict[Hashable, StreamStats] = {}
        self.stats: Dict[str, float] = {
            "steps": 0, "windows": 0, "wall_s": 0.0,
        }
        # The clock finite deadlines are read against for miss telemetry
        # (policies order by deadline value only); a fleet control plane
        # or a test may install a logical clock.
        self.deadline_clock: Callable[[], float] = time.perf_counter

    @staticmethod
    def _attach_mesh(engine: InferenceEngine, mesh) -> None:
        """Thread the serving mesh onto an engine: ``attach_mesh`` is a
        no-op for the same mesh and refuses a different one."""
        attach = getattr(engine, "attach_mesh", None)
        if attach is None:
            raise ValueError(
                f"engine {engine.modality!r} has no attach_mesh; a sharded "
                f"StreamEngine needs every lane engine to support "
                f"slot-axis sharding")
        attach(mesh)

    # -- introspection ---------------------------------------------------

    @property
    def engines(self) -> Dict[str, InferenceEngine]:
        """Engines by modality."""
        return {m: lane.engine for m, lane in self._lanes.items()}

    @property
    def loop(self) -> InferenceEngine:
        """The single engine of a one-lane StreamEngine; raises with
        several (use ``engines[modality]``)."""
        if len(self._lanes) != 1:
            raise AttributeError(
                "StreamEngine.loop is ambiguous with multiple engines; "
                "use .engines[modality]")
        return next(iter(self._lanes.values())).engine

    def modality_of(self, stream_id: Hashable) -> str:
        return self._stream_lane[stream_id]

    def _lane_named(self, modality: Optional[str]) -> EngineLane:
        """A lane by modality (optional when there is only one)."""
        if modality is None:
            if len(self._lanes) != 1:
                raise ValueError(
                    f"modality required with multiple engines; have "
                    f"{sorted(self._lanes)}")
            return next(iter(self._lanes.values()))
        if modality not in self._lanes:
            raise ValueError(f"no engine for modality {modality!r}; "
                             f"have {sorted(self._lanes)}")
        return self._lanes[modality]

    def compiled_shapes(self, modality: Optional[str] = None) -> set:
        """Distinct shape keys a lane has been stepped with."""
        return set(self._lane_named(modality).shape_keys)

    def warmup(self, shape_keys, modality: Optional[str] = None) -> None:
        """Run a lane's engine once per shape key before serving (see
        :meth:`BatchedClosedLoop.warmup` and
        :meth:`~repro_torch.core.engine.FrameTCNEngine.warmup`)."""
        engine = self._lane_named(modality).engine
        warm = getattr(engine, "warmup", None)
        if warm is None:
            raise ValueError(
                f"engine {type(engine).__name__} does not implement "
                f"warmup()")
        warm(shape_keys)

    def warmup_megastep(self, key_pairs) -> None:
        """Prepare fused megastep steps before serving (on the card,
        capture each pair's graph).

        ``key_pairs`` is an iterable of ``(event_shape_key,
        frame_shape_key)`` pairs -- each wing's full shape-key tuple
        (``(batch, max_events, duration_us)`` / ``(batch, height, width,
        duration_us)``). The megastep keeps its own cache, separate from
        the per-engine ones, so warm it explicitly before serving a fused
        workload.
        """
        if not self.megastep:
            raise ValueError(
                "warmup_megastep on an engine without "
                "EngineConfig.megastep=True")
        ev_lane, fr_lane = self._lanes["event"], self._lanes["frame"]
        for ev_key, fr_key in key_pairs:
            self._mega_executable(ev_lane, fr_lane, tuple(ev_key),
                                  tuple(fr_key))

    def compiled_megastep_keys(self) -> set:
        """``(event_key, frame_key)`` pairs with a captured fused graph on
        the card (stepped or warmed); on the CPU, the pairs stepped or
        warmed."""
        return set() if self._mega_graphs is None \
            else self._mega_graphs.keys()

    @property
    def handles(self) -> Dict[Hashable, StreamHandle]:
        """Open handles by stream id (a copy; close via the handle)."""
        return dict(self._handles)

    # -- fusion pairing ----------------------------------------------------

    def pair_streams(self, a: Hashable, b: Hashable) -> None:
        """Declare two open streams on different lanes the wings of one
        fusion tick: with ``coschedule`` on, both land in the same engine
        step whenever either wins a slot. Idempotent for the same pair;
        re-pairing a stream to another partner needs
        :meth:`unpair_streams` first."""
        for sid in (a, b):
            if sid not in self._stream_lane:
                raise KeyError(f"unknown stream {sid!r}")
        if self._stream_lane[a] == self._stream_lane[b]:
            raise ValueError(
                f"paired streams must live on different lanes; both "
                f"{a!r} and {b!r} are {self._stream_lane[a]!r}")
        if self._pairs.get(a) == b:
            return
        for sid in (a, b):
            if sid in self._pairs:
                raise ValueError(
                    f"stream {sid!r} is already paired with "
                    f"{self._pairs[sid]!r}; unpair_streams() first")
        self._pairs[a] = b
        self._pairs[b] = a

    def unpair_streams(self, stream_id: Hashable) -> None:
        """Dissolve a stream's pairing (a no-op for unpaired streams);
        closing either wing calls it."""
        partner = self._pairs.pop(stream_id, None)
        if partner is not None:
            self._pairs.pop(partner, None)
        for key in [k for k in self._pair_dispatch
                    if k[0] == stream_id or k[0] == partner]:
            del self._pair_dispatch[key]

    # -- fleet control-plane hooks -----------------------------------------

    def telemetry(self, modality: Optional[str] = None) -> LaneTelemetry:
        """A consistent view of one lane: queue depth, in-flight windows,
        pooled sliding-horizon rates, fault counters, and every stream's
        :class:`StreamStatsSnapshot`."""
        lane = self._lane_named(modality)
        snaps = {sid: self.stream_stats[sid].snapshot()
                 for sid in lane.queues}
        in_flight = sum(
            1
            for step_recs in self._inflight
            for rec in step_recs if rec.lane is lane
            for entry in rec.entries if entry is not None)
        h_dated = sum(s.horizon_deadline_windows for s in snaps.values())
        h_missed = sum(s.horizon_missed for s in snaps.values())
        f_ticks = sum(s.fusion_ticks for s in snaps.values())
        f_paired = sum(s.fusion_ticks_paired for s in snaps.values())
        return LaneTelemetry(
            modality=lane.modality,
            slots=len(lane.slots),
            occupied=sum(1 for s in lane.slots if s is not _FREE),
            waiting=len(lane.waiting),
            queued=lane.pending(),
            in_flight=in_flight,
            windows=sum(s.windows for s in snaps.values()),
            windows_per_s=sum(s.windows_per_s for s in snaps.values()),
            deadline_miss_rate=h_missed / h_dated if h_dated else 0.0,
            streams=snaps,
            retries=lane.n_retries,
            quarantined=lane.n_quarantined,
            dead=lane.dead,
            paired_tick_rate=f_paired / f_ticks if f_ticks else 1.0)

    def dead_letters(self, modality: Optional[str] = None
                     ) -> List[DeadLetter]:
        """The lane's quarantined windows, oldest first (a copy)."""
        return list(self._lane_named(modality).dead_letter)

    def resize_lane(self, modality: Optional[str] = None, *,
                    slots: int, warm: bool = True) -> List[Hashable]:
        """Change one lane's batch-slot count live; returns the streams
        evicted from their slots (shrink only; they rejoin the FRONT of
        the waiting line in slot order).

        Safe between steps, in-flight pipelined steps included (they
        collect positionally from the batch they were dispatched with).
        Every live carry is parked and re-attached at the stream's next
        dispatch, so stateful streams stay bitwise those of the
        uninterrupted run. Policy bookkeeping is left as it is.

        ``warm=True``: for every shape key the engine holds at the old
        slot count, the same key at the new count is prepared through the
        engine's ``warmup`` (on the card, its CUDA graph is captured here),
        so no step after the resize pays for a capture. A key already
        held is not captured again, so grow/shrink cycles between the same
        counts add no graphs. On a sharded engine the new count must still
        divide over the mesh's slot axis (``ValueError`` otherwise, with
        the lane untouched).
        """
        lane = self._lane_named(modality)
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if self.mesh is not None:
            _check_slot_divisible(slots, self.mesh,
                                  f"resize of lane '{lane.modality}'")
        old = len(lane.slots)
        if slots == old:
            return []
        if lane.state is not None:
            for j, owner in enumerate(lane.state_streams):
                if owner is not _FREE and owner in lane.stateful:
                    lane.parked[owner] = {k: a[j]
                                          for k, a in lane.state.items()}
            lane.state = None
            lane.zero_state = None
        lane.state_streams = [_FREE] * slots
        evicted: List[Hashable] = []
        if slots > old:
            lane.slots.extend([_FREE] * (slots - old))
            lane.slot_runs.extend([0] * (slots - old))
        else:
            held = [(sid, run) for sid, run in
                    zip(lane.slots, lane.slot_runs) if sid is not _FREE]
            kept, dropped = held[:slots], held[slots:]
            lane.slots = ([sid for sid, _ in kept]
                          + [_FREE] * (slots - len(kept)))
            lane.slot_runs = ([run for _, run in kept]
                              + [0] * (slots - len(kept)))
            evicted = [sid for sid, _ in dropped]
            lane.waiting.extendleft(reversed(evicted))
        if warm:
            warmer = getattr(lane.engine, "warmup", None)
            compiled = getattr(lane.engine, "compiled_shape_keys", None)
            if warmer is not None:
                have = (set(compiled()) if compiled is not None
                        else set(lane.shape_keys))
                # Shape keys lead with the batch size (both wings'
                # contract): re-key the old count's keys at the new one.
                want = {(slots,) + tuple(k[1:])
                        for k in have if k and k[0] == old}
                fresh = sorted(want - have)
                if fresh:
                    warmer(fresh)
        return evicted

    def drain_lane(self, modality: Optional[str] = None
                   ) -> List[StreamResult]:
        """Collect every in-flight pipelined step of ONE lane (oldest
        first), leaving other lanes' dispatched work in flight (in order;
        steps left empty are dropped). A collect failure without recovery
        leaves exactly the uncollected records in flight."""
        lane = self._lane_named(modality)
        out: List[StreamResult] = []
        done: Deque[List[_InflightLane]] = deque()
        try:
            while self._inflight:
                step_recs = self._inflight[0]
                i = 0
                while i < len(step_recs):
                    rec = step_recs[i]
                    if rec.lane is lane:
                        out.extend(self._collect_one(rec))
                        step_recs.pop(i)
                    else:
                        i += 1
                self._inflight.popleft()
                if step_recs:
                    done.append(step_recs)
        finally:
            self._inflight.extendleft(reversed(done))
        return out

    def abort_lane(self, modality: Optional[str] = None) -> int:
        """Drop one lane's in-flight records without collecting them (the
        lane's engine is presumed broken) and re-queue their windows at
        their sequence positions; returns the re-queued count. Other
        lanes' steps stay in flight. The lane's carried state is dropped
        (it lived on the broken engine): restore stateful streams from
        checkpoints, or they restart cold. The dropped records' device
        work still runs; their staging buffers keep their guards (the
        buffers belong to the engine's cache, not to the records)."""
        lane = self._lane_named(modality)
        requeue: List[tuple] = []
        remaining: Deque[List[_InflightLane]] = deque()
        while self._inflight:
            step_recs = self._inflight.popleft()
            rest = [r for r in step_recs if r.lane is not lane]
            for rec in step_recs:
                if rec.lane is not lane:
                    continue
                for i, entry in enumerate(rec.entries):
                    if entry is None:
                        continue
                    if rec.items is not None and rec.items[i] is not None:
                        requeue.append((entry[0], rec.items[i]))
            if rest:
                remaining.append(rest)
        self._inflight = remaining
        lane.state = None
        lane.zero_state = None
        lane.state_streams = [_FREE] * len(lane.slots)
        lane.parked.clear()
        self._requeue(lane, requeue)
        return len(requeue)

    def replace_lane_engine(self, modality: Optional[str] = None, *,
                            engine: InferenceEngine) -> None:
        """Swap one lane's engine for a rebuilt one, clearing the lane's
        fault state (dead flag, fail streak, cooldown, retry counters; the
        dead letters are history and stay). Streams, queues, slots and
        policy bookkeeping survive; carried state does not (restore
        stateful streams from checkpoints afterwards).

        The lane must have no windows in flight (``abort_lane`` or
        ``drain_lane`` first). The replacement must serve the same
        modality, agree on the latched ``duration_us`` (an unlatched
        replacement inherits it) and support carried state if the lane
        has stateful streams; under the megastep it must support the fused
        step on the other wing's device. On a sharded engine the
        replacement is attached to the serving mesh (``attach_mesh``; one
        attached to another mesh is refused). On the card the old engine's
        queued device work is waited for on each of its devices, and the
        megastep's graphs are dropped, so the old engine's graphs and
        buffers are freed once the caller lets go of it.
        """
        lane = self._lane_named(modality)
        for step_recs in self._inflight:
            for rec in step_recs:
                if rec.lane is lane and any(
                        e is not None for e in rec.entries):
                    raise ValueError(
                        f"lane {lane.modality!r} has in-flight windows; "
                        f"abort_lane() or drain_lane() before replacing "
                        f"its engine")
        if engine.modality != lane.modality:
            raise ValueError(
                f"replacement engine serves modality "
                f"{engine.modality!r}, lane is {lane.modality!r}")
        if lane.stateful and not hasattr(engine, "init_state"):
            raise ValueError(
                f"lane {lane.modality!r} has stateful streams but the "
                f"replacement engine has no carried-state support")
        if lane.engine.duration_us is not None:
            if engine.duration_us is None:
                engine.duration_us = lane.engine.duration_us
            elif engine.duration_us != lane.engine.duration_us:
                raise ValueError(
                    f"replacement duration_us={engine.duration_us} != "
                    f"lane duration_us={lane.engine.duration_us}")
        if self.mesh is not None:
            self._attach_mesh(engine, self.mesh)
        if self.megastep:
            if not hasattr(engine, "_mega_parts"):
                raise ValueError(
                    f"replacement engine for lane {lane.modality!r} "
                    f"({type(engine).__name__}) does not support the "
                    f"fused megastep this engine is configured for")
            if getattr(engine, "mesh", None) is not None:
                raise ValueError(
                    "replacement engine is attached to a mesh; the fused "
                    "megastep is single-device")
            if str(engine.device) != str(self._mega_graphs.device):
                raise ValueError(
                    f"replacement engine is on {engine.device}; the "
                    f"megastep runs on {self._mega_graphs.device}")
        for old_device in set(_engine_devices(lane.engine)):
            if old_device.type == "cuda":
                # Aborted records may still be running the old engine's
                # graphs: let them finish before anything of it is freed.
                torch.cuda.synchronize(old_device)
        if self.megastep:
            # The fused graphs were captured from the old engine's run
            # function and buffers; the next fused step captures anew.
            self._mega_graphs = GraphCache(self._mega_graphs.device)
        lane.engine = engine
        lane.supports_state = hasattr(engine, "init_state")
        lane.shape_keys = set()
        lane.state = None
        lane.zero_state = None
        lane.state_streams = [_FREE] * len(lane.slots)
        lane.parked.clear()
        lane.dead = False
        lane.fail_streak = 0
        lane.cooldown = 0
        lane.retries.clear()
        self._log_fault("lane_replaced", lane, None, None, None)

    # -- streams -----------------------------------------------------------

    def open(self, modality: Optional[str] = None, *,
             stream_id: Optional[Hashable] = None,
             stateful: bool = False,
             deadline: Optional[float] = None) -> StreamHandle:
        """Open a new stream and return its :class:`StreamHandle`.

        ``modality`` selects the lane (optional when there is one).
        ``stateful=True`` carries the engine state (the event wing's LIF
        membranes) across the stream's windows until ``reset_state`` or
        ``close``. ``deadline`` is the handle's default per-window
        deadline. ``stream_id`` names the stream (``"<modality>-<n>"``
        when omitted); an id that is already open raises.
        """
        lane = self._lane_named(modality)
        if stateful and not lane.supports_state:
            raise ValueError(
                f"engine for modality {lane.modality!r} "
                f"({type(lane.engine).__name__}) has no carried-state "
                f"support (no init_state); open it stateless")
        if stream_id is None:
            while True:
                stream_id = f"{lane.modality}-{self._auto_id}"
                self._auto_id += 1
                if stream_id not in self._stream_lane:
                    break
        elif stream_id in self._stream_lane:
            raise ValueError(
                f"stream {stream_id!r} is already open (bound to modality "
                f"{self._stream_lane[stream_id]!r}); close() it before "
                f"reopening the id")
        lane.queues[stream_id] = deque()
        self._stream_lane[stream_id] = lane.modality
        self._seq[stream_id] = 0
        self.stream_stats[stream_id] = StreamStats()
        if stateful:
            lane.stateful.add(stream_id)
        handle = StreamHandle(self, lane, stream_id, stateful, deadline)
        self._handles[stream_id] = handle
        return handle

    def restore(self, ckpt, *,
                stream_id: Optional[Hashable] = None) -> StreamHandle:
        """Open a stream from a :class:`~repro_torch.serving.session.
        StreamCheckpoint`: ``open`` + :meth:`StreamHandle.restore`. The
        stream keeps the checkpoint's id (unless ``stream_id`` renames it)
        and its default deadline; a failed restore closes the handle."""
        handle = self.open(modality=ckpt.modality,
                           stream_id=ckpt.stream_id
                           if stream_id is None else stream_id,
                           stateful=ckpt.stateful,
                           deadline=ckpt.deadline)
        try:
            return handle.restore(ckpt)
        except Exception:
            handle.close()
            raise

    # -- submission (legacy id-keyed form) ---------------------------------

    def submit(self, stream_id: Hashable, window: Any, *,
               modality: Optional[str] = None,
               deadline: Optional[float] = None,
               stateful: Optional[bool] = None) -> int:
        """Queue one window on an id-keyed stream (the legacy form).

        The first submit of a new id opens a handle, later ones forward to
        it: scheduling and results are those of driving the handle. Prefer
        ``open(...)`` + ``handle.submit(...)``; this form warns once per
        engine.

        ``modality`` selects the lane of a NEW stream (optional with one
        lane); a known stream is bound to its lane. ``deadline`` is the
        window's deadline. ``stateful=True`` opts a NEW stream into carried
        state; like the lane it is latched for the stream's life (``None``
        leaves a known stream's binding alone).
        """
        warn_deprecated_call(
            self, "id-keyed-submit",
            "StreamEngine.submit(stream_id, window, ...) is a legacy "
            "call form; use the session-handle API instead: handle = "
            "engine.open(modality=..., stateful=...); handle.submit("
            "window)")
        lane = self._resolve_lane(stream_id, modality)
        # Validation comes before any queue or sequence state moves, so a
        # rejected submit burns no sequence number.
        if stateful and not lane.supports_state:
            raise ValueError(
                f"engine for modality {lane.modality!r} "
                f"({type(lane.engine).__name__}) has no carried-state "
                f"support (no init_state); submit stateless")
        handle = self._handles.get(stream_id)
        if (handle is not None and stateful is not None
                and bool(stateful) != handle.stateful):
            raise ValueError(
                f"stream {stream_id!r} is bound to stateful="
                f"{handle.stateful}; statefulness is latched "
                f"at the stream's first submit")
        if handle is None:
            # Validate BEFORE open, so a rejected first submit registers
            # no stream at all (no handle, no stats entry).
            lane.engine.validate(window)
            handle = self.open(modality=lane.modality, stream_id=stream_id,
                               stateful=bool(stateful))
        return handle.submit(window, deadline=deadline)

    def _resolve_lane(self, stream_id: Hashable,
                      modality: Optional[str]) -> EngineLane:
        bound = self._stream_lane.get(stream_id)
        if bound is not None:
            if modality is not None and modality != bound:
                raise ValueError(
                    f"stream {stream_id!r} is bound to modality "
                    f"{bound!r}, got {modality!r}")
            return self._lanes[bound]
        if modality is None:
            if len(self._lanes) == 1:
                return next(iter(self._lanes.values()))
            raise ValueError(
                f"modality required for new stream {stream_id!r} with "
                f"engines {sorted(self._lanes)}")
        if modality not in self._lanes:
            raise ValueError(f"no engine for modality {modality!r}; "
                             f"have {sorted(self._lanes)}")
        return self._lanes[modality]

    # -- id-keyed lookups ----------------------------------------------------

    def stateful_of(self, stream_id: Hashable) -> bool:
        """Whether a known stream carries state across its windows."""
        return self._handle_of(stream_id).stateful

    def _handle_of(self, stream_id: Hashable) -> StreamHandle:
        handle = self._handles.get(stream_id)
        if handle is None:
            raise KeyError(f"unknown stream {stream_id!r}")
        return handle

    def handle(self, stream_id: Hashable) -> StreamHandle:
        """The open :class:`StreamHandle` of a known stream id (the lookup
        a fleet rebalancer uses to pick a migration victim from telemetry
        rows). Raises ``KeyError`` for unknown ids."""
        return self._handle_of(stream_id)

    def has_stream(self, stream_id: Hashable) -> bool:
        """Whether ``stream_id`` is currently open on this engine."""
        return stream_id in self._handles

    def reset_state(self, stream_id: Hashable) -> None:
        """Zero a stateful stream's carried state without retiring it;
        forwards to :meth:`StreamHandle.reset_state`."""
        self._handle_of(stream_id).reset_state()

    def retire(self, stream_id: Hashable) -> int:
        """Remove a stream entirely; forwards to :meth:`StreamHandle.close`
        (see there). Returns the number of windows discarded."""
        return self._handle_of(stream_id).close()

    def pending(self) -> int:
        """Windows queued across all streams."""
        return sum(lane.pending() for lane in self._lanes.values())

    @property
    def in_flight(self) -> int:
        """Dispatched-but-uncollected pipeline steps."""
        return len(self._inflight)

    # -- carried state ---------------------------------------------------

    def _lane_state_in(self, lane: EngineLane):
        """Plan one lane's state for a dispatch.

        Returns ``(state_in, commit)``: the slot-major state to dispatch
        with (``None`` when no stream of the lane is stateful, which
        serves the lane from the engine's zero state) and a
        ``commit(new_state)`` thunk that advances the lane's tracking once
        every lane's dispatch succeeded.
        """
        if not lane.supports_state or not lane.stateful:
            return None, None
        if lane.state is None:       # first stateful dispatch: zero state
            lane.zero_state = lane.engine.init_state(len(lane.slots))
            lane.state = lane.zero_state

        slots = list(lane.slots)
        pos = {owner: j for j, owner in enumerate(lane.state_streams)
               if owner is not _FREE}
        # Per slot: ("row", j) = carry already in the buffer at row j;
        # ("parked", sid) = carry parked off-buffer; None = zero row.
        src: List[Any] = []
        for sid in slots:
            if sid is _FREE or sid not in lane.stateful:
                src.append(None)
            elif sid in pos:
                src.append(("row", pos[sid]))
            elif sid in lane.parked:
                src.append(("parked", sid))
            else:
                src.append(None)
        # Fast path: every occupied slot's carry already sits in its row
        # (free slots' rows are dead and never force a rebuild).
        if all(sid is _FREE or s == ("row", i)
               for i, (sid, s) in enumerate(zip(slots, src))):
            state_in = lane.state
        else:
            state_in = {}
            for name, plane in lane.state.items():
                rows = []
                for s in src:
                    if s is None:
                        rows.append(lane.zero_state[name][0])
                    elif s[0] == "row":
                        rows.append(plane[s[1]])
                    else:
                        rows.append(lane.parked[s[1]][name])
                state_in[name] = _stack_rows(rows, plane)

        old_state = lane.state
        old_owners = list(lane.state_streams)
        scheduled = {sid for sid in slots if sid is not _FREE}

        def commit(new_state):
            for j, owner in enumerate(old_owners):
                if owner is _FREE or owner in scheduled:
                    continue
                # The stream lost its slot this step: park its carry (from
                # the pre-dispatch buffer) so it follows the stream.
                lane.parked[owner] = {k: a[j] for k, a in old_state.items()}
            for sid in scheduled:
                lane.parked.pop(sid, None)
            lane.state = new_state
            lane.state_streams = [
                sid if (sid is not _FREE and sid in lane.stateful)
                else _FREE
                for sid in slots]

        return state_in, commit

    # -- scheduling ------------------------------------------------------

    def step(self) -> List[StreamResult]:
        """Serve one batch: the head window of every slotted stream.

        Synchronous (``pipeline_depth == 0``): returns this step's
        results; queues are only peeked until every engine has returned,
        so a failed step consumes nothing and can be retried. Pipelined:
        dispatches without waiting and returns the results of the step
        dispatched ``pipeline_depth`` steps ago.
        """
        t0 = time.perf_counter()
        if self.pipeline_depth == 0:
            ran = self._dispatch(eager=True)
            failed = self._take_failures()
            if not ran and not failed:
                return []
            out = failed + self._collect(ran)
        else:
            ran = self._dispatch(eager=False)
            if ran:
                self._inflight.append(ran)
            out = self._take_failures()
            while len(self._inflight) > self.pipeline_depth:
                out.extend(self._collect_step(self._inflight[0]))
                self._inflight.popleft()
            if not ran and self._inflight:
                # No new work: drain one in-flight step so a caller
                # looping on step() always makes progress.
                out.extend(self._collect_step(self._inflight[0]))
                self._inflight.popleft()
            if not ran and not out:
                return []
        self.stats["steps"] += 1
        self.stats["wall_s"] += time.perf_counter() - t0
        return out

    def _dispatch(self, *, eager: bool) -> List[_InflightLane]:
        """Assign every servable lane's slots (then, with fusion pairs,
        seat paired wings together), run (``eager``) or queue every lane's
        batch -- with ``megastep``, both wings through one fused call when
        both have work -- and pop the served heads only after every lane's
        dispatch returned. Under recovery a dead lane fails its queue fast
        and a cooling lane sits the step out; a failing lane is charged a
        retry and skipped, the others still served."""
        self._dispatch_no += 1
        active: List[EngineLane] = []
        for lane in self._lanes.values():
            if self.recovery is not None:
                if lane.dead:
                    self._fail_fast_lane(lane)
                    continue
                if lane.cooldown > 0:
                    lane.cooldown -= 1
                    continue
            self.policy.assign(lane)
            active.append(lane)
        if self._pairs and self.coschedule:
            self._coschedule(active)
        work = []
        for lane in active:
            heads = [lane.queues[sid][0].item if sid is not _FREE else None
                     for sid in lane.slots]
            if any(w is not None for w in heads):
                work.append((lane, heads))
        ran: List[_InflightLane] = []
        commits = []
        if self.megastep and len(work) == 2:
            # Both wings have work (the megastep has exactly the event and
            # frame lanes): one fused call serves the step. A step with
            # work on one lane takes the per-lane path below.
            try:
                recs, mega_commits = self._mega_dispatch(work, eager)
            except Exception:
                if self.recovery is None:
                    raise
                # A fault in either wing aborts the fused call with every
                # queue and carry untouched: serve this step through the
                # per-lane graphs, where the fault lands on its own lane.
                recs = None
            if recs is not None:
                ran.extend(recs)
                commits.extend(mega_commits)
                work = []
        for lane, heads in work:
            try:
                rec, commit = self._dispatch_lane(lane, heads, eager)
            except Exception as exc:
                if self.recovery is None:
                    raise
                self._note_lane_failure(lane, heads, exc)
                continue
            ran.append(rec)
            if commit is not None:
                commits.append(commit)
        for commit, new_state in commits:
            commit(new_state)
        for rec in ran:
            lane = rec.lane
            rec.items = [None] * len(rec.entries)
            for i, slot in enumerate(rec.entries):
                if slot is None:
                    continue
                sid = lane.slots[slot]
                entry = lane.queues[sid].popleft()
                lane.slot_runs[slot] += 1
                self.stream_stats[sid].queued -= 1
                rec.entries[i] = (sid, entry.seq, entry.deadline)
                rec.items[i] = entry
                if self._pairs:
                    self._note_pair_dispatch(sid, entry.seq)
        return ran

    def _coschedule(self, lanes: List[EngineLane]) -> None:
        """After slot assignment: for every paired stream holding a slot
        with queued work, pull its partner into the partner's lane for
        this same step -- into a free slot, else by evicting a seated
        stream that is not itself half of a seated pair (the evictee goes
        to the front of its waiting line). Dead, cooling or idle partner
        lanes are left alone. Scheduling only: which step serves a window
        moves, its result does not."""
        by_mod = {lane.modality: lane for lane in lanes}
        for lane in lanes:
            for sid in lane.slots:
                if sid is _FREE or not lane.queues.get(sid):
                    continue
                partner = self._pairs.get(sid)
                if partner is None:
                    continue
                plane = by_mod.get(self._stream_lane.get(partner))
                if (plane is None or partner in plane.slots
                        or not plane.queues.get(partner)):
                    continue
                self._seat_partner(plane, partner)

    def _seat_partner(self, lane: EngineLane, sid: Hashable) -> bool:
        """Seat ``sid`` in ``lane`` for this step; returns whether a slot
        was won."""
        free = next((i for i, cur in enumerate(lane.slots)
                     if cur is _FREE), None)
        if free is None:
            for i, cur in enumerate(lane.slots):
                p = self._pairs.get(cur)
                if p is None:
                    free = i
                    break
                plane = self._lanes.get(self._stream_lane.get(p, ""))
                if plane is None or p not in plane.slots:
                    free = i
                    break
            if free is None:
                return False
            evicted = lane.slots[free]
            lane.slot_runs[free] = 0
            if lane.queues.get(evicted):
                lane.waiting.appendleft(evicted)
        lane.slots[free] = sid
        lane.slot_runs[free] = 0
        if sid in lane.waiting:
            lane.waiting.remove(sid)
        # As if the policy had taken it: a seated stream's aging restarts.
        forget = getattr(self.policy, "forget", None)
        if forget is not None:
            forget(sid)
        return True

    def _note_pair_dispatch(self, sid: Hashable, seq: int) -> None:
        """When both wings of a paired tick have dispatched, credit a
        fusion tick to both streams (paired when they shared a step)."""
        partner = self._pairs.get(sid)
        if partner is None:
            return
        other_step = self._pair_dispatch.pop((partner, seq), None)
        if other_step is None:
            self._pair_dispatch[(sid, seq)] = self._dispatch_no
            return
        paired = int(other_step == self._dispatch_no)
        for s in (sid, partner):
            st = self.stream_stats.get(s)
            if st is not None:
                st.fusion_ticks += 1
                st.fusion_ticks_paired += paired

    def _dispatch_lane(self, lane: EngineLane, heads: List, eager: bool):
        """One lane's dispatch: ``(record, (commit, new_state) or None)``;
        raises with the lane's queues untouched."""
        engine = lane.engine
        batch = engine.prepare(heads, batch_size=len(lane.slots))
        key = engine.shape_key(batch)
        state_in, state_commit = self._lane_state_in(lane)
        dispatch = getattr(engine, "infer_dispatch", None)
        has_split = (dispatch is not None
                     and getattr(engine, "infer_collect", None) is not None)
        new_state = None
        if eager or (state_in is not None and not has_split):
            # Synchronous infer; a stateful engine without the split also
            # lands here when pipelined, so its carry advances in order.
            if state_in is None:
                kind, pending = "results", engine.infer(batch)
            else:
                results, new_state = engine.infer(batch, state_in)
                kind, pending = "results", results
        elif has_split:
            if state_in is None:
                kind, pending = "handle", dispatch(batch)
            else:
                # new_state is device tensors still being computed; the
                # next dispatch consumes them in stream order.
                pending, new_state = dispatch(batch, state_in)
                kind = "handle"
        else:
            kind, pending = "batch", batch
        rec = _InflightLane(
            lane=lane, key=key,
            entries=[None if w is None else slot
                     for slot, w in enumerate(heads)],
            kind=kind, pending=pending,
            prev_carry=self._prev_carry(lane, heads, state_in))
        commit = ((state_commit, new_state)
                  if state_commit is not None else None)
        return rec, commit

    def _prev_carry(self, lane: EngineLane, heads: List, state_in):
        """Under recovery, each dispatched stateful stream's pre-window
        carry: rows (views) of ``state_in``, which is the lane's state or
        a fresh stack of rows, never a graph's static input, a staging
        buffer or a replay's own memory, and which nothing writes."""
        if self.recovery is None or state_in is None:
            return None
        return {sid: {k: a[slot] for k, a in state_in.items()}
                for slot, sid in enumerate(lane.slots)
                if (sid is not _FREE and sid in lane.stateful
                    and heads[slot] is not None)}

    def _mega_executable(self, ev_lane: EngineLane, fr_lane: EngineLane,
                         ev_key, fr_key) -> Callable:
        """The fused two-wing step for a pair of per-wing shape keys:
        ``exe(ev_args, fr_args)`` -> ``(ev_out, fr_out)``. On the card it
        replays one CUDA graph that holds the wings' OWN run functions side
        by side (captured once per pair), so each wing's half keeps the
        bits of that wing's own graph; on the CPU it calls the two run
        functions."""
        ev_eng, fr_eng = ev_lane.engine, fr_lane.engine

        def parts():
            ev_run, ev_in = ev_eng._mega_parts(ev_key)
            fr_run, fr_in = fr_eng._mega_parts(fr_key)
            return (lambda inputs: (ev_run(inputs[0]), fr_run(inputs[1])),
                    (ev_in, fr_in))

        step = self._mega_graphs.get((ev_key, fr_key), parts)
        if step is not None:
            return lambda ev_args, fr_args: step((ev_args, fr_args))
        ev_run, fr_run = ev_eng._build_run(ev_key), fr_eng._build_run(fr_key)
        return lambda ev_args, fr_args: (ev_run(ev_args), fr_run(fr_args))

    def _mega_dispatch(self, work: List[tuple], eager: bool) -> tuple:
        """Both wings' dispatch through one fused call; returns
        ``(records, state_commits)`` shaped exactly as two ordinary
        per-lane dispatches, so collection, recovery and pipelining
        downstream are unchanged. Raises with every queue untouched."""
        by_mod = {lane.modality: (lane, heads) for lane, heads in work}
        ev_lane, ev_heads = by_mod["event"]
        fr_lane, fr_heads = by_mod["frame"]
        ev_batch = ev_lane.engine.prepare(
            ev_heads, batch_size=len(ev_lane.slots))
        ev_key = ev_lane.engine.shape_key(ev_batch)
        fr_batch = fr_lane.engine.prepare(
            fr_heads, batch_size=len(fr_lane.slots))
        fr_key = fr_lane.engine.shape_key(fr_batch)
        ev_state, ev_commit = self._lane_state_in(ev_lane)
        fr_state, fr_commit = self._lane_state_in(fr_lane)
        exe = self._mega_executable(ev_lane, fr_lane, ev_key, fr_key)
        ev_out, fr_out = exe(
            ev_lane.engine._mega_args(ev_batch, ev_state),
            fr_lane.engine._mega_args(fr_batch, fr_state))
        ev_pending, ev_new = ev_lane.engine._mega_split(
            ev_out, ev_batch, ev_state)
        fr_pending, fr_new = fr_lane.engine._mega_split(
            fr_out, fr_batch, fr_state)
        if eager:
            # Synchronous mode stays retry-safe: materialize BOTH wings'
            # results before any queue state moves.
            ev_kind, ev_pending = "results", ev_lane.engine.infer_collect(
                ev_pending)
            fr_kind, fr_pending = "results", fr_lane.engine.infer_collect(
                fr_pending)
        else:
            ev_kind = fr_kind = "handle"
        recs: List[_InflightLane] = []
        commits: List[tuple] = []
        for lane, heads, key, kind, pending, state_in, commit, new in (
                (ev_lane, ev_heads, ev_key, ev_kind, ev_pending, ev_state,
                 ev_commit, ev_new),
                (fr_lane, fr_heads, fr_key, fr_kind, fr_pending, fr_state,
                 fr_commit, fr_new)):
            recs.append(_InflightLane(
                lane=lane, key=key,
                entries=[None if w is None else slot
                         for slot, w in enumerate(heads)],
                kind=kind, pending=pending,
                prev_carry=self._prev_carry(lane, heads, state_in)))
            if commit is not None:
                commits.append((commit, new))
        # Records in lane declaration order, exactly as the per-lane path
        # emits them, so result ordering is unchanged.
        order = {m: i for i, m in enumerate(self._lanes)}
        recs.sort(key=lambda r: order[r.lane.modality])
        return recs, commits

    def _collect(self, ran: List[_InflightLane]) -> List[StreamResult]:
        """Wait for a dispatched step's results and emit them."""
        out: List[StreamResult] = []
        for rec in ran:
            out.extend(self._collect_one(rec))
        return out

    def _collect_step(self, step_recs: List[_InflightLane]
                      ) -> List[StreamResult]:
        """Collect one in-flight step's records, removing each from the
        (still queued) step as it lands, so an exception without recovery
        leaves exactly the uncollected records in flight."""
        out: List[StreamResult] = []
        while step_recs:
            out.extend(self._collect_one(step_recs[0]))
            step_recs.pop(0)
        return out

    def _collect_one(self, rec: _InflightLane) -> List[StreamResult]:
        """Collect one lane's record of one dispatched step."""
        lane = rec.lane
        try:
            if rec.kind == "results":
                results = rec.pending
            elif rec.kind == "handle":
                results = lane.engine.infer_collect(rec.pending)
            else:
                results = lane.engine.infer(rec.pending)
        except Exception as exc:
            if self.recovery is None:
                raise
            return self._recover_record(rec, exc)
        lane.shape_keys.add(rec.key)
        lane.fail_streak = 0
        out: List[StreamResult] = []
        wall_t = time.perf_counter()
        rcfg = self.recovery
        for slot, entry in enumerate(rec.entries):
            if entry is None:
                continue
            sid, seq, deadline = entry
            res = results[slot]
            if (rcfg is not None and rcfg.quarantine_nonfinite
                    and res.logits is not None
                    and not np.all(np.isfinite(np.asarray(res.logits)))):
                # NaNs are deterministic (a retry would recompute them):
                # quarantine at once, roll the carry back.
                out.append(self._quarantine_entry(
                    rec, slot, "non-finite logits"))
                continue
            lane.retries.pop((sid, seq), None)
            st = self.stream_stats[sid]
            st.windows += 1
            st.energy_mj += res.energy_mj
            st.latency_ms_sum += res.latency_ms
            st.realtime_windows += int(res.realtime)
            missed = (None if deadline is None
                      else self.deadline_clock() > deadline)
            st.note_completion(wall_t, st.queued, missed)
            out.append(StreamResult(stream_id=sid, seq=seq, result=res,
                                    modality=lane.modality))
            self.stats["windows"] += 1
        return out

    # -- fault recovery --------------------------------------------------

    def _log_fault(self, kind: str, lane: EngineLane,
                   sid: Optional[Hashable], seq: Optional[int],
                   error: Optional[str]) -> None:
        self.fault_log.append({
            "step": int(self.stats["steps"]), "kind": kind,
            "modality": lane.modality, "stream": sid, "seq": seq,
            "error": error})

    def _take_failures(self) -> List[StreamResult]:
        out, self._pending_failures = self._pending_failures, []
        return out

    def _rollback_carry(self, rec: _InflightLane, sid: Hashable) -> None:
        """Park a stream's pre-window carry (captured at this record's
        dispatch) and orphan any state row it owns."""
        lane = rec.lane
        if rec.prev_carry is None or sid not in rec.prev_carry:
            return
        lane.parked[sid] = rec.prev_carry[sid]
        for j, owner in enumerate(lane.state_streams):
            if owner is not _FREE and owner == sid:
                lane.state_streams[j] = _FREE

    def _scrub_stream_inflight(self, lane: EngineLane, sid: Hashable,
                               skip: Optional[_InflightLane] = None
                               ) -> List[tuple]:
        """Remove a stream's windows from the lane's still-in-flight
        records (they chained on a rolled-back carry); returns ``(sid,
        _Queued)`` rows to re-queue."""
        requeue: List[tuple] = []
        for step_recs in self._inflight:
            for r in step_recs:
                if r is skip or r.lane is not lane:
                    continue
                for i, entry in enumerate(r.entries):
                    if entry is not None and entry[0] == sid:
                        r.entries[i] = None
                        if r.items is not None and r.items[i] is not None:
                            requeue.append((sid, r.items[i]))
                            r.items[i] = None
        return requeue

    def _requeue(self, lane: EngineLane, entries: List[tuple]) -> None:
        """Put failed windows back on their streams' queues at their
        sequence positions (a stable merge by seq)."""
        by_sid: Dict[Hashable, List[_Queued]] = {}
        for sid, q in entries:
            by_sid.setdefault(sid, []).append(q)
        for sid, qs in by_sid.items():
            if sid not in lane.queues:
                continue             # stream closed while in flight
            lane.queues[sid] = deque(sorted(
                list(lane.queues[sid]) + qs, key=lambda e: e.seq))
            self.stream_stats[sid].queued += len(qs)
            if sid not in lane.slots and sid not in lane.waiting:
                lane.waiting.append(sid)
            for q in qs:
                self._log_fault("requeue", lane, sid, q.seq, None)

    def _quarantine_entry(self, rec: _InflightLane, slot: int,
                          error: str) -> StreamResult:
        """Dead-letter one window of a collected record: emit its failed
        result, roll the stream's carry back, and pull the stream's
        still-in-flight successors (chained on the poisoned carry) back
        onto its queue."""
        lane = rec.lane
        sid, seq, deadline = rec.entries[slot]
        item = None
        if rec.items is not None and rec.items[slot] is not None:
            item = rec.items[slot].item
        lane.retries.pop((sid, seq), None)
        lane.dead_letter.append(DeadLetter(
            stream_id=sid, seq=seq, modality=lane.modality, item=item,
            deadline=deadline, error=error))
        lane.n_quarantined += 1
        self.stream_stats[sid].quarantined += 1
        self._log_fault("quarantine", lane, sid, seq, error)
        if sid in lane.stateful:
            self._rollback_carry(rec, sid)
            self._requeue(lane,
                          self._scrub_stream_inflight(lane, sid, skip=rec))
        return StreamResult(
            stream_id=sid, seq=seq, result=None, modality=lane.modality,
            status="failed", error=error)

    def _recover_record(self, rec: _InflightLane,
                        exc: Exception) -> List[StreamResult]:
        """A record failed at collect (pipelined): re-queue its windows
        (carries rolled back) for a retry, or quarantine those past
        ``max_retries``; back the lane off and maybe declare it dead."""
        lane = rec.lane
        rcfg = self.recovery
        err = f"{type(exc).__name__}: {exc}"
        out: List[StreamResult] = []
        requeue: List[tuple] = []
        for slot, entry in enumerate(rec.entries):
            if entry is None:
                continue
            sid, seq, _deadline = entry
            count = lane.retries.get((sid, seq), 0) + 1
            if count > rcfg.max_retries:
                out.append(self._quarantine_entry(rec, slot, err))
                continue
            lane.retries[(sid, seq)] = count
            lane.n_retries += 1
            self.stream_stats[sid].retries += 1
            self._log_fault("retry", lane, sid, seq, err)
            if sid in lane.stateful:
                self._rollback_carry(rec, sid)
                requeue.extend(
                    self._scrub_stream_inflight(lane, sid, skip=rec))
            if rec.items is not None and rec.items[slot] is not None:
                requeue.append((sid, rec.items[slot]))
        self._requeue(lane, requeue)
        lane.fail_streak += 1
        lane.cooldown = max(lane.cooldown, rcfg.backoff_steps)
        if lane.fail_streak >= rcfg.dead_after and not lane.dead:
            lane.dead = True
            self._log_fault("lane_dead", lane, None, None, err)
        return out

    def _note_lane_failure(self, lane: EngineLane, heads: List,
                           exc: Exception) -> None:
        """A lane's synchronous dispatch failed with its queues untouched:
        charge a retry to each window of the attempted batch, quarantine
        those over budget, back the lane off."""
        rcfg = self.recovery
        err = f"{type(exc).__name__}: {exc}"
        for slot, sid in enumerate(lane.slots):
            if sid is _FREE or heads[slot] is None:
                continue
            entry = lane.queues[sid][0]
            count = lane.retries.get((sid, entry.seq), 0) + 1
            if count > rcfg.max_retries:
                lane.queues[sid].popleft()
                self.stream_stats[sid].queued -= 1
                lane.retries.pop((sid, entry.seq), None)
                lane.dead_letter.append(DeadLetter(
                    stream_id=sid, seq=entry.seq, modality=lane.modality,
                    item=entry.item, deadline=entry.deadline, error=err))
                lane.n_quarantined += 1
                self.stream_stats[sid].quarantined += 1
                self._log_fault("quarantine", lane, sid, entry.seq, err)
                self._pending_failures.append(StreamResult(
                    stream_id=sid, seq=entry.seq, result=None,
                    modality=lane.modality, status="failed", error=err))
                continue
            lane.retries[(sid, entry.seq)] = count
            lane.n_retries += 1
            self.stream_stats[sid].retries += 1
            self._log_fault("retry", lane, sid, entry.seq, err)
        lane.fail_streak += 1
        lane.cooldown = max(lane.cooldown, rcfg.backoff_steps)
        if lane.fail_streak >= rcfg.dead_after and not lane.dead:
            lane.dead = True
            self._log_fault("lane_dead", lane, None, None, err)

    def _fail_fast_lane(self, lane: EngineLane) -> None:
        """Dead-lane mode: dead-letter everything queued without touching
        the engine, emitting failed results at once so callers (and
        fusion pairing) keep ticking."""
        for sid in list(lane.queues):
            q = lane.queues[sid]
            while q:
                entry = q.popleft()
                self.stream_stats[sid].queued -= 1
                lane.dead_letter.append(DeadLetter(
                    stream_id=sid, seq=entry.seq, modality=lane.modality,
                    item=entry.item, deadline=entry.deadline,
                    error="lane dead"))
                lane.n_quarantined += 1
                self.stream_stats[sid].quarantined += 1
                self._log_fault("quarantine", lane, sid, entry.seq,
                                "lane dead")
                self._pending_failures.append(StreamResult(
                    stream_id=sid, seq=entry.seq, result=None,
                    modality=lane.modality, status="failed",
                    error="lane dead"))

    def flush(self) -> List[StreamResult]:
        """Collect every in-flight pipelined step (oldest first)."""
        out: List[StreamResult] = []
        while self._inflight:
            out.extend(self._collect_step(self._inflight[0]))
            self._inflight.popleft()
        return out

    def run(self) -> List[StreamResult]:
        """Drain every queue and the pipeline; results in completion
        order, the same for any ``pipeline_depth``."""
        out: List[StreamResult] = []
        while self.pending() or self._inflight:
            out.extend(self.step())
        return out

    @property
    def mean_occupancy(self) -> float:
        """Average served windows per step (batching efficiency)."""
        return (self.stats["windows"] / self.stats["steps"]
                if self.stats["steps"] else 0.0)
