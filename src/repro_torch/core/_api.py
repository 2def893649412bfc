"""The unified engine-construction surface + one-shot API deprecations.

:class:`EngineConfig` is the one construction surface for the serving
engines. ``StreamEngine`` construction once took keyword arguments
(``max_streams``, ``duration_us``, ``policy``/``fair_quantum``,
``fuse_fc``, ``pipeline_depth``, ``mesh``); they are all fields of
this single frozen dataclass, passed as ``StreamEngine(params, cfg,
config)`` / ``StreamEngine(engines=..., config=config)`` and forwarded
to the wing engines via ``BatchedClosedLoop.from_config`` /
``FrameTCNEngine.from_config``. The legacy kwarg form still works as a
shim (bitwise-identical engines) that announces the replacement once.

Deprecation machinery: the session-handle redesign keeps every legacy
call form working -- ``StreamEngine.submit(stream_id, ...)``, the
engines' stateless ``infer(batch)``, and now kwarg construction -- but
each announces its replacement exactly once per owning instance via
:class:`DeprecationWarning`. The serving stack itself still drives the
legacy forms internally (the submit shim, the stateless lane fast path,
the B=1 ``ClosedLoopPipeline`` wrapper); those calls are wrapped in
:func:`suppress_api_deprecations` so only *user* code sees the warning.
"""
from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Mapping, Optional, Union

__all__ = ["EngineConfig", "FleetConfig", "FaultConfig", "RecoveryConfig",
           "suppress_api_deprecations", "warn_deprecated_call"]


@dataclasses.dataclass(frozen=True)
class RecoveryConfig:
    """Fault-recovery policy for a serving engine, in one frozen value.

    Attached as ``EngineConfig.recovery``; with the default ``None`` the
    engine keeps its pre-recovery semantics bitwise (an engine exception
    propagates, non-finite outputs are served as-is). With a config set:

      * ``max_retries`` -- how many times one window may fail an engine
        step before it is quarantined to the lane's dead-letter queue
        (its ``StreamResult`` is emitted with ``status="failed"`` and
        the stream's carry rolls back to its pre-window value).
      * ``backoff_steps`` -- engine steps a lane sits out after a failed
        step before it is dispatched again. Measured in steps, not wall
        time, so recovery schedules are deterministic and replayable.
      * ``dead_after`` -- consecutive failed lane steps after which the
        lane is declared dead: it stops calling its engine and fails
        queued windows fast (keeping paired fusion ticks completing,
        degraded) until ``replace_lane_engine`` swaps a rebuilt engine
        in.
      * ``checkpoint_every`` -- the :class:`~repro_torch.fleet.supervisor.
        LaneSupervisor` auto-checkpoint cadence, in supervisor ticks.
      * ``quarantine_nonfinite`` -- treat non-finite logits as poison:
        the window is quarantined immediately (no retry -- NaNs are
        deterministic, a retry would just recompute them).
    """

    max_retries: int = 2
    backoff_steps: int = 1
    dead_after: int = 4
    checkpoint_every: int = 4
    quarantine_nonfinite: bool = True

    def __post_init__(self):
        if self.max_retries < 0:
            raise ValueError(
                f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_steps < 0:
            raise ValueError(
                f"backoff_steps must be >= 0, got {self.backoff_steps}")
        if self.dead_after < 1:
            raise ValueError(
                f"dead_after must be >= 1, got {self.dead_after}")
        if self.checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got "
                f"{self.checkpoint_every}")


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """A deterministic fault schedule for the
    :class:`~repro_torch.fleet.faults.FaultInjector`.

    Rates are per *injection site visit* (one engine call), drawn from a
    ``numpy`` generator seeded with ``seed`` in call order -- the same
    seed over the same workload replays the same faults, which is what
    makes the chaos soak assertable.

      * ``step_error_rate`` -- probability an engine call raises
        :class:`~repro_torch.fleet.faults.InjectedFault` (surfacing at
        dispatch in synchronous mode, at collect in pipelined mode).
      * ``nan_rate`` -- probability a returned batch has one slot's
        logits poisoned with NaN (the quarantine path).
      * ``stall_rate`` / ``stall_ms`` -- probability an engine call
        stalls for ``stall_ms`` wall milliseconds (a straggler, not an
        error: surfaces as deadline misses, never as an exception).
      * ``modalities`` -- restrict injection to these modalities
        (``None`` = every wrapped engine).
    """

    seed: int = 0
    step_error_rate: float = 0.0
    nan_rate: float = 0.0
    stall_rate: float = 0.0
    stall_ms: float = 1.0
    modalities: Optional[tuple] = None

    def __post_init__(self):
        for name in ("step_error_rate", "nan_rate", "stall_rate"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} must be in [0, 1], got {v}")
        if self.stall_ms < 0.0:
            raise ValueError(
                f"stall_ms must be >= 0, got {self.stall_ms}")
        if self.modalities is not None:
            object.__setattr__(self, "modalities",
                               tuple(self.modalities))


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Everything that shapes a serving engine, in one frozen value.

    Fields (each previously its own ``StreamEngine`` kwarg):

      * ``max_streams`` -- batch slots per engine lane (or a
        ``{modality: count}`` mapping). With a ``mesh``, every lane's
        slot count must divide by the mesh's slot-axis size.
      * ``duration_us`` -- pin the one-bin-width-per-engine contract up
        front; ``None`` latches each engine's first submitted duration.
      * ``policy`` / ``fair_quantum`` -- slot assignment: a
        ``SlotPolicy`` instance, or just a quantum for the default
        ``FairQuantumPolicy`` (mutually exclusive, as before).
      * ``pipeline_depth`` -- ``>= 1`` dispatches steps asynchronously
        and returns results ``pipeline_depth`` steps late (bitwise
        order/value parity with the synchronous engine).
      * ``fuse_fc`` -- route the event wing's fc1/fc2 through the fused
        synapse+LIF Pallas kernel.
      * ``window_ms`` -- the control-tick window length for the
        real-time accounting.
      * ``mesh`` -- slot sharding: a :class:`~repro_torch.distributed.
        mesh.Mesh` (``repro_torch.distributed.make_mesh``) over whose slot
        axis (its ``data`` axis) every engine shards its batch slots. Each
        engine runs a step as one shard per block of slots, on that
        block's device with its own CUDA graphs, staging buffers and copy
        of the weights; nothing in a shard's step reads another shard's
        data, and every row is bit for bit the single-device engine's. A
        mesh that names one device n times runs n shards there (a logical
        mesh: how the tests and a one-card run exercise it).
      * ``recovery`` -- a :class:`RecoveryConfig` opting the engine
        into fault recovery (bounded retry with deterministic backoff,
        poison-window quarantine, dead-lane fail-fast). ``None`` (the
        default) keeps the pre-recovery failure semantics bitwise: an
        engine exception propagates to the caller.
      * ``coschedule`` -- fusion-aware co-scheduling (default on): after
        the slot policy assigns a lane, streams paired via
        ``StreamEngine.pair_streams`` (a :class:`~repro_torch.serving.session.
        FusionSession` pairs its wings automatically) pull their partner
        into the partner's lane for the SAME step, so both wings of a
        tick land together instead of drifting across independently
        contended lanes. Scheduling-only: per-window results are bitwise
        unchanged.
      * ``megastep`` -- serve both wings' steps (the event wing's K1/K2
        SNN and the frame wing's ternary CNN with K3) as ONE call per
        step when both lanes have work (default off): on the card one
        captured CUDA graph per ``(event key, frame key)`` pair, replayed
        once a step; on the CPU the two run functions back to back.
        Requires exactly one event and one frame lane, both on one
        device, and is single-device only (incompatible with ``mesh``).
        Results stay bitwise-identical to the two separate per-engine
        calls; a lane without work this step falls back to the ordinary
        per-lane dispatch, so single-wing ticks keep their semantics.

    Frozen: a config is a value, shareable between engines and safe to
    put in tests' parametrize tables. ``replace`` derives variants
    (``dataclasses.replace(cfg, pipeline_depth=2)``).
    """

    max_streams: Union[int, Mapping[str, int]] = 8
    duration_us: Optional[int] = None
    policy: Optional[Any] = None           # SlotPolicy (kept Any: no
    fair_quantum: Optional[int] = None     # serving import from _api)
    pipeline_depth: int = 0
    fuse_fc: bool = False
    window_ms: float = 300.0
    mesh: Optional[Any] = None             # a distributed.Mesh
    recovery: Optional["RecoveryConfig"] = None
    coschedule: bool = True
    megastep: bool = False

    def __post_init__(self):
        if self.recovery is not None and not isinstance(
                self.recovery, RecoveryConfig):
            raise TypeError(
                f"recovery must be a RecoveryConfig, got "
                f"{type(self.recovery).__name__}")
        if self.pipeline_depth < 0:
            raise ValueError(
                f"pipeline_depth must be >= 0, got {self.pipeline_depth}")
        if self.policy is not None and self.fair_quantum is not None:
            raise ValueError(
                "fair_quantum configures the DEFAULT policy only; set "
                "the quantum on your policy instance instead")
        if self.megastep and self.mesh is not None:
            raise ValueError(
                "megastep is single-device: the fused cross-wing "
                "dispatch lowers both wings into one program and does "
                "not compose with mesh slot-sharding; drop mesh= or "
                "megastep=")


@dataclasses.dataclass(frozen=True)
class FleetConfig:
    """Every control-plane policy knob, in one frozen value.

    Read by ``repro_torch.fleet``'s
    :class:`~repro_torch.fleet.autoscale.LaneAutoscaler` and
    :class:`~repro_torch.fleet.rebalance.FleetRebalancer`; the serving
    layer itself never consults it (mechanism lives in ``StreamEngine``,
    policy lives here).

    Autoscaler knobs:

      * ``grow_backlog`` -- queued windows per slot above which a lane
        counts as backlogged; ``grow_patience`` consecutive backlogged
        observations trigger a grow (sustained pressure, not a blip).
      * ``shrink_occupancy`` -- occupied-slot fraction below which a lane
        counts as idle; ``shrink_patience`` consecutive idle observations
        trigger a shrink. Shrink patience should exceed grow patience so
        capacity is easy to gain and slow to give back.
      * ``min_slots`` / ``max_slots`` -- hard slot-count bounds. On a
        sharded engine ``min_slots`` must divide over the mesh's slot
        axis, so that every doubling and halving stays divisible.
      * ``scale_step`` -- multiplicative resize factor (2 doubles/halves,
        keeping the population of per-``shape_key`` CUDA graphs
        logarithmic in the slot range).

    Rebalancer knobs:

      * ``miss_weight`` -- how many queued-windows-per-slot one unit of
        deadline-miss rate is worth in the load score
        (``queued/slots + miss_weight * miss_rate``).
      * ``imbalance`` -- minimum hottest-minus-coldest score gap before a
        migration is considered (the hysteresis dead-band; migrations
        cost a lane drain, so small gaps are left alone).
      * ``cooldown`` -- observation ticks after a migration during which
        the rebalancer holds still, letting the moved load register in
        both engines' telemetry before it re-evaluates (anti-thrash).
      * ``fault_weight`` -- how many queued-windows-per-slot one unit of
        fault rate (retries + quarantines per completed window) is worth
        in the load score; a dead lane additionally scores a flat
        ``fault_weight`` penalty, so the rebalancer evacuates it.
    """

    grow_backlog: float = 2.0
    grow_patience: int = 2
    shrink_occupancy: float = 0.25
    shrink_patience: int = 4
    min_slots: int = 1
    max_slots: int = 64
    scale_step: int = 2
    miss_weight: float = 10.0
    imbalance: float = 1.0
    cooldown: int = 4
    fault_weight: float = 5.0

    def __post_init__(self):
        if self.min_slots < 1:
            raise ValueError(f"min_slots must be >= 1, got {self.min_slots}")
        if self.max_slots < self.min_slots:
            raise ValueError(
                f"max_slots ({self.max_slots}) must be >= min_slots "
                f"({self.min_slots})")
        if self.scale_step < 2:
            raise ValueError(
                f"scale_step must be >= 2, got {self.scale_step}")
        if self.grow_patience < 1 or self.shrink_patience < 1:
            raise ValueError("patience values must be >= 1")
        if self.grow_backlog <= 0.0:
            raise ValueError(
                f"grow_backlog must be > 0, got {self.grow_backlog}")
        if not 0.0 <= self.shrink_occupancy <= 1.0:
            raise ValueError(
                "shrink_occupancy must be in [0, 1], got "
                f"{self.shrink_occupancy}")
        if self.imbalance < 0.0 or self.miss_weight < 0.0:
            raise ValueError("imbalance and miss_weight must be >= 0")
        if self.fault_weight < 0.0:
            raise ValueError(
                f"fault_weight must be >= 0, got {self.fault_weight}")
        if self.cooldown < 0:
            raise ValueError(f"cooldown must be >= 0, got {self.cooldown}")


_suppressed = 0


@contextlib.contextmanager
def suppress_api_deprecations():
    """Silence :func:`warn_deprecated_call` for the duration of the block
    (re-entrant; used by the shims' internal legacy-form calls)."""
    global _suppressed
    _suppressed += 1
    try:
        yield
    finally:
        _suppressed -= 1


def warn_deprecated_call(owner, key: str, message: str) -> None:
    """Emit ``message`` as a one-shot DeprecationWarning.

    One-shot per ``(owner instance, key)``: the first offending call on
    an object warns, repeats stay quiet -- a migration nudge, not log
    spam. No-op inside :func:`suppress_api_deprecations`.
    """
    if _suppressed:
        return
    seen = owner.__dict__.setdefault("_api_warned", set())
    if key in seen:
        return
    seen.add(key)
    warnings.warn(message, DeprecationWarning, stacklevel=3)
