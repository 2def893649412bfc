"""Lane autoscaling from queue-depth and deadline-miss telemetry.

Port of ``repro.fleet.autoscale``. A lane's slot count is its
provisioned capacity: too few slots and the waiting line grows while
deadlines slip; too many and every step pays for dead batch rows.
:class:`LaneAutoscaler` closes that loop: each ``observe()`` tick reads
one consistent :class:`~repro_torch.serving.stream.LaneTelemetry`
snapshot and either grows the lane (sustained backlog), shrinks it
(sustained idleness), or holds.

Resizes are deliberately rare and cheap. Rare: both directions require
*patience* -- ``grow_patience`` / ``shrink_patience`` consecutive
over/under-threshold observations -- so a single bursty tick never
triggers a capture, and shrink patience is the longer of the two
(capacity is easy to gain, slow to give back). Cheap: ``resize_lane``
captures the new slot count's CUDA graph for every shape key the lane
holds (the per-key graphs of ``core/graphs.py``) inside the call, so the
first post-resize step replays a captured graph instead of capturing
mid-serve; a slot count visited before keeps its graph, and with
``scale_step=2`` the slot counts visited over the whole ``[min_slots,
max_slots]`` range stay logarithmic, bounding the graph population.

With a device mesh attached (``EngineConfig.mesh``), ``min_slots`` must
divide over the mesh's slot axis: doubling and halving then keep every
slot count divisible and ``resize_lane``'s mesh check never fires. The
autoscaler checks it at construction.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core._api import FleetConfig
from repro_torch.distributed.mesh import slot_axis

__all__ = ["LaneAutoscaler", "ScaleDecision"]


@dataclasses.dataclass(frozen=True)
class ScaleDecision:
    """One ``observe()`` tick's outcome (also the audit-log row)."""

    modality: str
    action: str                      # "grow" | "shrink" | "hold"
    old_slots: int
    new_slots: int
    evicted: Tuple = ()              # streams bumped to the waiting line
    reason: str = ""

    @property
    def resized(self) -> bool:
        return self.action != "hold"


class LaneAutoscaler:
    """Grow/shrink one engine lane's slot count from its telemetry.

    Drives only the public lane surface -- ``engine.telemetry()`` and
    ``engine.resize_lane()`` -- so it composes with any engine the
    serving layer accepts. One autoscaler watches one lane; run one per
    lane (they share nothing).

    ``observe()`` is meant to be called on the serving loop's tick (e.g.
    once per scheduling round); it reads host counters only and never
    waits for the device (a resize captures, which does).
    """

    def __init__(self, engine, modality: Optional[str] = None,
                 config: Optional[FleetConfig] = None):
        self.engine = engine
        self.modality = modality
        self.config = config if config is not None else FleetConfig()
        mesh = getattr(engine, "mesh", None)
        if mesh is not None:
            ax = slot_axis(mesh)
            if self.config.min_slots % mesh.shape[ax]:
                raise ValueError(
                    f"min_slots={self.config.min_slots} does not divide "
                    f"over the mesh slot axis '{ax}' ({mesh.shape[ax]} "
                    f"devices); doubling and halving would reach "
                    f"indivisible slot counts")
        self._grow_streak = 0
        self._shrink_streak = 0
        self.decisions = []          # every non-hold decision, in order

    def observe(self) -> ScaleDecision:
        """Take one telemetry reading and maybe resize; returns what
        happened (holds included, so callers can log every tick)."""
        cfg = self.config
        t = self.engine.telemetry(self.modality)
        old = t.slots
        # A lane is backlogged when queued work per slot exceeds the
        # threshold; idle when occupancy is low AND nothing is queued or
        # in flight (a drained-but-about-to-refill lane is not idle).
        backlogged = t.backlog_per_slot >= cfg.grow_backlog
        idle = (t.occupancy <= cfg.shrink_occupancy
                and t.queued == 0 and t.in_flight == 0)
        self._grow_streak = self._grow_streak + 1 if backlogged else 0
        self._shrink_streak = self._shrink_streak + 1 if idle else 0

        if (self._grow_streak >= cfg.grow_patience
                and old < cfg.max_slots):
            new = min(old * cfg.scale_step, cfg.max_slots)
            evicted = self.engine.resize_lane(self.modality, slots=new)
            self._grow_streak = self._shrink_streak = 0
            decision = ScaleDecision(
                t.modality, "grow", old, new, tuple(evicted),
                reason=(f"backlog {t.backlog_per_slot:.2f} windows/slot "
                        f">= {cfg.grow_backlog} for "
                        f"{cfg.grow_patience} ticks"))
            self.decisions.append(decision)
            return decision

        if (self._shrink_streak >= cfg.shrink_patience
                and old > cfg.min_slots):
            new = max(old // cfg.scale_step, cfg.min_slots)
            evicted = self.engine.resize_lane(self.modality, slots=new)
            self._grow_streak = self._shrink_streak = 0
            decision = ScaleDecision(
                t.modality, "shrink", old, new, tuple(evicted),
                reason=(f"occupancy {t.occupancy:.2f} <= "
                        f"{cfg.shrink_occupancy} for "
                        f"{cfg.shrink_patience} ticks"))
            self.decisions.append(decision)
            return decision

        return ScaleDecision(t.modality, "hold", old, old)
