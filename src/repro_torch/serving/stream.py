"""Continuous batching of sensor streams over per-engine batch slots.

Port of ``repro.serving.stream``. A stream is opened on one engine lane
(``StreamEngine.open(modality=...)`` -> :class:`StreamHandle`), windows
are submitted to it, and ``step()`` serves the head window of every
slotted stream in one engine call per lane per step. A lane is one
engine (the event wing, :class:`~repro_torch.core.pipeline.
BatchedClosedLoop`, or the frame wing, :class:`~repro_torch.core.engine.
FrameTCNEngine`) with its own slots: ``StreamEngine(params, cfg,
config)`` builds one event lane, ``StreamEngine(engines=[...],
config=...)`` one lane per engine, keyed by its ``modality``. Slots are
assigned by a :class:`SlotPolicy` (:class:`FairQuantumPolicy` by default:
pin a slot while its stream has work, rotate after ``fair_quantum``
windows when others wait). Windows of one stream are served strictly in
order, at most one per step.

Stateful streams carry the engine's state (the event wing's LIF
membranes; the frame wing carries nothing) from window to window. The
lane keeps a slot-major dict of device tensors beside its slots; state
follows the STREAM, not the slot: when a stream moves, its row is
gathered along (``torch.stack`` per layer); when it loses its slot the
row is parked; a slot admitting a new stream starts from zero.

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

Not in this slice (see ROADMAP): checkpoint/restore, ``DeadlinePolicy``
and per-window deadlines, telemetry, ``resize_lane``/``drain_lane``,
fault recovery, the mesh, and the legacy id-keyed call forms. The
``EngineConfig`` fields that select them are refused at construction.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import (Any, Callable, Deque, Dict, Hashable, List, Mapping,
                    Optional, Sequence, Union)

import torch

from repro_torch.core._api import EngineConfig
from repro_torch.core.energy import KrakenModel
from repro_torch.core.engine import InferenceEngine
from repro_torch.core.graphs import GraphCache
from repro_torch.core.pipeline import (BatchedClosedLoop, ClosedLoopResult,
                                       _refuse_unported)
from repro_torch.core.snn import SNNConfig

__all__ = ["StreamResult", "StreamStats", "EngineLane", "SlotPolicy",
           "FairQuantumPolicy", "StreamHandle", "StreamEngine",
           "EngineConfig"]


@dataclasses.dataclass
class StreamResult:
    """One served window: which stream, which window index (the
    submission-time sequence number), and the closed-loop outcome."""

    stream_id: Hashable
    seq: int
    result: Optional[ClosedLoopResult]
    modality: str = "event"


@dataclasses.dataclass
class StreamStats:
    """Per-stream accounting, accumulated as windows complete."""

    windows: int = 0
    energy_mj: float = 0.0
    latency_ms_sum: float = 0.0
    realtime_windows: int = 0
    queued: int = 0               # still waiting in this stream's queue
    fusion_ticks: int = 0         # ticks of a paired (fusion) stream seen
    fusion_ticks_paired: int = 0  # ... both wings dispatched the same step

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


class _FreeSlot:
    """Sentinel for an unassigned batch slot (distinct from any stream id,
    including ``None``)."""

    def __repr__(self):
        return "<free slot>"


_FREE = _FreeSlot()


@dataclasses.dataclass
class _Queued:
    """One queued submission: the item plus its sequence number."""

    item: Any
    seq: int


@dataclasses.dataclass
class _InflightLane:
    """One lane's share of a dispatched, not yet collected step.

    ``entries`` is slot-aligned: ``(stream_id, seq)`` per served slot,
    ``None`` per empty one. ``kind`` is ``"results"`` (synchronous mode:
    finished results) or ``"handle"`` (the engine's pending handle)."""

    lane: "EngineLane"
    key: Hashable
    entries: List[Optional[tuple]]
    kind: str
    pending: Any


@dataclasses.dataclass
class EngineLane:
    """One engine's scheduling state: its slots, queues and waiting line.

    ``state`` is the slot-major dict of device tensors fed to the next
    dispatch; ``state_streams`` says, per row, which stateful stream's
    carry the row holds (rows of stateless or free slots are dead);
    ``parked`` holds the carries of stateful streams without a slot.
    A stateful stream's carry lives in exactly one of a state row or
    ``parked`` (or nowhere: cold start).
    """

    modality: str
    engine: InferenceEngine
    slots: List[Hashable]
    slot_runs: List[int]
    waiting: Deque[Hashable]
    queues: Dict[Hashable, Deque[_Queued]]
    shape_keys: set
    stateful: set = dataclasses.field(default_factory=set)
    state: Any = None
    state_streams: List[Hashable] = dataclasses.field(default_factory=list)
    parked: Dict[Hashable, Any] = dataclasses.field(default_factory=dict)
    zero_state: Any = None

    def pending(self) -> int:
        return sum(len(q) for q in self.queues.values())


class SlotPolicy:
    """Decides which streams hold an engine's batch slots each step.

    ``assign(lane)`` runs once per step before the batch is gathered: it
    frees slots and fills free slots from the waiting line, keeping every
    schedulable stream in exactly one of a held slot or the waiting line.
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
        for i, sid in enumerate(lane.slots):
            if sid is _FREE:
                cand = self._take(lane)
                if cand is None:
                    break
                lane.slots[i] = cand
                lane.slot_runs[i] = 0

    def _take(self, lane: EngineLane) -> Optional[Hashable]:
        """Pop the next waiting stream with queued work; drained entries
        are dropped (they re-enter on their next submit)."""
        while lane.waiting:
            cand = lane.waiting.popleft()
            if lane.queues[cand]:
                return cand
        return None


class StreamHandle:
    """One stream's lifecycle: what ``StreamEngine.open`` returns.

    ``submit(window)`` queues a window and returns its sequence number;
    ``reset_state()`` zeroes a stateful stream's carry; ``close()``
    retires the stream. Results come from the engine's ``step``/``run``/
    ``flush``.
    """

    def __init__(self, engine: "StreamEngine", lane: EngineLane,
                 stream_id: Hashable, stateful: bool):
        self._engine = engine
        self._lane = lane
        self.stream_id = stream_id
        self.stateful = bool(stateful)
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

    def validate(self, window: Any) -> None:
        """Check ``window`` against this stream's engine without queueing
        it (raises what ``submit`` would), so a caller submitting to
        several handles can validate every window before queueing any."""
        self._check_open()
        self._lane.engine.validate(window)

    def submit(self, window: Any) -> int:
        """Queue one window; returns its per-stream sequence number. The
        engine validates the window before any queue state moves, so a
        rejected submit burns no sequence number."""
        self._check_open()
        lane, sid, eng = self._lane, self.stream_id, self._engine
        lane.engine.validate(window)
        seq = eng._seq[sid]
        eng._seq[sid] = seq + 1
        lane.queues[sid].append(_Queued(window, seq))
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

    def close(self) -> int:
        """Retire the stream: queue, slot, waiting entry and carry. Returns
        the number of windows discarded, in-flight ones included (their
        results are never emitted). Closing a closed handle returns 0."""
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
        eng.unpair_streams(sid)
        del eng._stream_lane[sid]
        eng._seq.pop(sid, None)
        eng._handles.pop(sid, None)
        eng.stream_stats[sid].queued -= queued_dropped
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
    ``window_ms``, ``coschedule`` and ``megastep`` (see the module
    docstring); ``fuse_fc`` selects nothing for the built event engine
    (fc1/fc2 always run through kernel K2, which is what either value
    computes) and, as in the JAX package, is refused with ``engines=``.
    ``mesh``, ``recovery`` and a policy that is not a port
    :class:`SlotPolicy` raise ``NotImplementedError``.
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
    ):
        config = EngineConfig() if config is None else config
        if not isinstance(config, EngineConfig):
            raise TypeError(f"config must be an EngineConfig, got "
                            f"{type(config).__name__}")
        _refuse_unported(config)
        if config.recovery is not None:
            raise NotImplementedError(
                "EngineConfig.recovery: fault recovery is not ported yet "
                "(ROADMAP queue 1, item 7(b))")
        if config.policy is not None and not isinstance(config.policy,
                                                        SlotPolicy):
            raise NotImplementedError(
                f"policy {type(config.policy).__name__}: only the port's "
                f"SlotPolicy subclasses are served; DeadlinePolicy is not "
                f"ported yet (ROADMAP queue 1, item 7(a))")
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
        self.pipeline_depth = config.pipeline_depth
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
            self._lanes[e.modality] = EngineLane(
                modality=e.modality, engine=e,
                slots=[_FREE] * slots, slot_runs=[0] * slots,
                waiting=deque(), queues={}, shape_keys=set(),
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

    # -- streams -----------------------------------------------------------

    def open(self, modality: Optional[str] = None, *,
             stream_id: Optional[Hashable] = None,
             stateful: bool = False) -> StreamHandle:
        """Open a new stream and return its :class:`StreamHandle`.

        ``modality`` selects the lane (optional when there is one).
        ``stateful=True`` carries the engine state (the event wing's LIF
        membranes) across the stream's windows until ``reset_state`` or
        ``close``. ``stream_id`` names the stream (``"<modality>-<n>"``
        when omitted); an id that is already open raises.
        """
        lane = self._lane_named(modality)
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
        handle = StreamHandle(self, lane, stream_id, stateful)
        self._handles[stream_id] = handle
        return handle

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
        the dispatch succeeded.
        """
        if not lane.stateful:
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
                state_in[name] = torch.stack(rows)

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
        results; queues are only peeked until the engine has returned, so
        a failed step consumes nothing and can be retried. Pipelined:
        dispatches without waiting and returns the results of the step
        dispatched ``pipeline_depth`` steps ago.
        """
        t0 = time.perf_counter()
        if self.pipeline_depth == 0:
            ran = self._dispatch(eager=True)
            if not ran:
                return []
            out = self._collect(ran)
        else:
            ran = self._dispatch(eager=False)
            if ran:
                self._inflight.append(ran)
            out = []
            while len(self._inflight) > self.pipeline_depth:
                out.extend(self._collect(self._inflight.popleft()))
            if not ran and self._inflight:
                # No new work: drain one in-flight step so a caller
                # looping on step() always makes progress.
                out.extend(self._collect(self._inflight.popleft()))
            if not ran and not out:
                return []
        self.stats["steps"] += 1
        self.stats["wall_s"] += time.perf_counter() - t0
        return out

    def _dispatch(self, *, eager: bool) -> List[_InflightLane]:
        """Assign every lane's slots (then, with fusion pairs, seat paired
        wings together), run (``eager``) or queue every lane's batch --
        with ``megastep``, both wings through one fused call when both
        have work -- and pop the served heads only after every lane
        succeeded."""
        self._dispatch_no += 1
        for lane in self._lanes.values():
            self.policy.assign(lane)
        if self._pairs and self.coschedule:
            self._coschedule()
        work = []
        for lane in self._lanes.values():
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
            ran, commits = self._mega_dispatch(work, eager)
            work = []
        for lane, heads in work:
            rec, commit = self._dispatch_lane(lane, heads, eager)
            ran.append(rec)
            if commit is not None:
                commits.append(commit)
        for commit, new_state in commits:
            commit(new_state)
        for rec in ran:
            lane = rec.lane
            for i, slot in enumerate(rec.entries):
                if slot is None:
                    continue
                sid = lane.slots[slot]
                entry = lane.queues[sid].popleft()
                lane.slot_runs[slot] += 1
                self.stream_stats[sid].queued -= 1
                rec.entries[i] = (sid, entry.seq)
                if self._pairs:
                    self._note_pair_dispatch(sid, entry.seq)
        return ran

    def _coschedule(self) -> None:
        """After slot assignment: for every paired stream holding a slot
        with queued work, pull its partner into the partner's lane for
        this same step -- into a free slot, else by evicting a seated
        stream that is not itself half of a seated pair (the evictee goes
        to the front of its waiting line). Scheduling only: which step
        serves a window moves, its result does not."""
        for lane in self._lanes.values():
            for sid in lane.slots:
                if sid is _FREE or not lane.queues.get(sid):
                    continue
                partner = self._pairs.get(sid)
                if partner is None:
                    continue
                plane = self._lanes[self._stream_lane[partner]]
                if partner in plane.slots or not plane.queues.get(partner):
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
                if p is None or p not in self._lanes[
                        self._stream_lane[p]].slots:
                    free = i
                    break
            if free is None:
                return False
            evicted = lane.slots[free]
            if lane.queues.get(evicted):
                lane.waiting.appendleft(evicted)
        lane.slots[free] = sid
        lane.slot_runs[free] = 0
        if sid in lane.waiting:
            lane.waiting.remove(sid)
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
            st = self.stream_stats[s]
            st.fusion_ticks += 1
            st.fusion_ticks_paired += paired

    def _dispatch_lane(self, lane: EngineLane, heads: List, eager: bool):
        """One lane's dispatch: ``(record, (commit, new_state) or None)``;
        raises with the lane's queues untouched."""
        engine = lane.engine
        batch = engine.prepare(heads, batch_size=len(lane.slots))
        key = engine.shape_key(batch)
        state_in, state_commit = self._lane_state_in(lane)
        new_state = None
        if eager:
            if state_in is None:
                kind, pending = "results", engine.infer(batch)
            else:
                results, new_state = engine.infer(batch, state_in)
                kind, pending = "results", results
        elif state_in is None:
            kind, pending = "handle", engine.infer_dispatch(batch)
        else:
            # new_state is device tensors still being computed; the next
            # dispatch consumes them in stream order, with no host wait.
            pending, new_state = engine.infer_dispatch(batch, state_in)
            kind = "handle"
        rec = _InflightLane(
            lane=lane, key=key,
            entries=[None if w is None else slot
                     for slot, w in enumerate(heads)],
            kind=kind, pending=pending)
        commit = ((state_commit, new_state)
                  if state_commit is not None else None)
        return rec, commit

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
        per-lane dispatches, so collection and pipelining downstream are
        unchanged. Raises with every queue untouched."""
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
        for lane, heads, key, kind, pending, commit, new in (
                (ev_lane, ev_heads, ev_key, ev_kind, ev_pending, ev_commit,
                 ev_new),
                (fr_lane, fr_heads, fr_key, fr_kind, fr_pending, fr_commit,
                 fr_new)):
            recs.append(_InflightLane(
                lane=lane, key=key,
                entries=[None if w is None else slot
                         for slot, w in enumerate(heads)],
                kind=kind, pending=pending))
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
            lane = rec.lane
            results = (rec.pending if rec.kind == "results"
                       else lane.engine.infer_collect(rec.pending))
            lane.shape_keys.add(rec.key)
            for slot, entry in enumerate(rec.entries):
                if entry is None:
                    continue
                sid, seq = entry
                res = results[slot]
                st = self.stream_stats[sid]
                st.windows += 1
                st.energy_mj += res.energy_mj
                st.latency_ms_sum += res.latency_ms
                st.realtime_windows += int(res.realtime)
                out.append(StreamResult(stream_id=sid, seq=seq, result=res,
                                        modality=lane.modality))
                self.stats["windows"] += 1
        return out

    def flush(self) -> List[StreamResult]:
        """Collect every in-flight pipelined step (oldest first)."""
        out: List[StreamResult] = []
        while self._inflight:
            out.extend(self._collect(self._inflight.popleft()))
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
