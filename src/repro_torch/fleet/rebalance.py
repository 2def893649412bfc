"""Load rebalancing across engine instances, with hysteresis.

Port of ``repro.fleet.rebalance``. A fleet serves many engines
(processes, hosts, cards); arrival skew makes some hot -- deep queues,
missed deadlines -- while others idle. :class:`FleetRebalancer`
equalizes them using the primitives the rest of this package built:
each ``observe()`` tick snapshots every engine's
:class:`~repro_torch.serving.stream.LaneTelemetry` (host counters only,
so a tick never waits for the device), scores load, and (when the
hottest-coldest gap justifies the cost) live-migrates one stream
hot-to-cold through the
:class:`~repro_torch.fleet.store.CheckpointStore`.

The load score is deliberately simple and dimensionless::

    score = queued_windows / slots + miss_weight * deadline_miss_rate
            + fault_weight * fault_rate          (+ fault_weight if dead)

Backlog per slot measures *pressure* (how far behind the lane is per
unit of capacity); the sliding-horizon miss rate measures *harm*
(deadlines actually slipping, the thing the paper's closed-loop latency
story cares about); ``miss_weight`` converts harm into pressure units.
The fault terms make unhealthy lanes score hot: ``fault_rate`` is the
lane's retries+quarantines per window attempt, and a dead lane takes a
flat ``fault_weight`` penalty on top -- so the rebalancer drains load
AWAY from a degrading engine before its streams start failing. A dead
lane is additionally never chosen as a migration *target*, and a dead
hot lane is left for the
:class:`~repro_torch.fleet.supervisor.LaneSupervisor` (migrating off it
needs recovery, not a drain).

Anti-thrash, twice over: the ``imbalance`` dead-band means small gaps
are never acted on (a migration costs a lane drain and a restore), and
after every move the rebalancer sits out ``cooldown`` ticks so the
moved load shows up in both engines' sliding-horizon telemetry before
the next decision. One migration per tick, always the hottest engine's
deepest-queued stream to the coldest engine.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

from repro_torch.core._api import FleetConfig
from repro_torch.fleet.migrate import migrate_stream
from repro_torch.fleet.store import CheckpointStore

__all__ = ["FleetRebalancer", "RebalanceReport", "load_score"]


def load_score(telemetry, config: FleetConfig) -> float:
    """One lane's scalar load: backlog pressure + weighted miss harm
    + weighted fault churn (+ a flat penalty for a dead lane)."""
    score = (telemetry.backlog_per_slot
             + config.miss_weight * telemetry.deadline_miss_rate
             + config.fault_weight * getattr(telemetry, "fault_rate", 0.0))
    if getattr(telemetry, "dead", False):
        score += config.fault_weight
    return score


@dataclasses.dataclass(frozen=True)
class RebalanceReport:
    """One ``observe()`` tick's outcome. ``displaced`` results were
    collected early by the migration's lane drain; the caller routes
    them like ``step()`` output."""

    moved: Tuple                     # MigrationRecord rows (0 or 1)
    displaced: Tuple                 # StreamResult rows from the drain
    loads: Dict[str, float]          # engine id -> score this tick
    reason: str

    @property
    def migrated(self) -> bool:
        return bool(self.moved)


class FleetRebalancer:
    """Watch a fleet of engines; migrate streams hot-to-cold.

    ``engines`` maps an engine id (any display name) to a
    ``StreamEngine``. All engines must serve the watched modality
    (``modality=None`` works for single-lane engines, like every other
    lane-addressed surface). The rebalancer owns nothing: engines keep
    serving between ticks, and every decision goes through the public
    telemetry/migration surfaces.
    """

    def __init__(self, engines: Mapping[str, object], *,
                 store: Optional[CheckpointStore] = None,
                 config: Optional[FleetConfig] = None,
                 modality: Optional[str] = None):
        if len(engines) < 2:
            raise ValueError(
                f"rebalancing needs >= 2 engines, got {len(engines)}")
        self.engines = dict(engines)
        self.store = store if store is not None else CheckpointStore()
        self.config = config if config is not None else FleetConfig()
        self.modality = modality
        self._cooldown = 0
        self.migrations = []         # every MigrationRecord, in order

    def loads(self) -> Dict[str, float]:
        """Current per-engine load scores (one telemetry snapshot each)."""
        return {eid: load_score(e.telemetry(self.modality), self.config)
                for eid, e in self.engines.items()}

    def observe(self) -> RebalanceReport:
        """One control tick: score, compare, maybe migrate one stream."""
        tels = {eid: e.telemetry(self.modality)
                for eid, e in self.engines.items()}
        scores = {eid: load_score(t, self.config)
                  for eid, t in tels.items()}
        if self._cooldown > 0:
            self._cooldown -= 1
            return RebalanceReport(
                (), (), scores,
                f"cooldown ({self._cooldown + 1} ticks left)")
        hot_id = max(scores, key=scores.__getitem__)
        # A dead lane cannot accept a restore (its engine raises), so it
        # is never a migration target -- even when it scores coldest.
        alive = [eid for eid, t in tels.items()
                 if not getattr(t, "dead", False)]
        if not alive:
            return RebalanceReport(
                (), (), scores, "every lane is dead (supervisor's job)")
        cold_id = min(alive, key=scores.__getitem__)
        gap = scores[hot_id] - scores[cold_id]
        if hot_id == cold_id or gap <= self.config.imbalance:
            return RebalanceReport(
                (), (), scores,
                f"balanced (gap {gap:.2f} <= "
                f"dead-band {self.config.imbalance})")
        if getattr(tels[hot_id], "dead", False):
            # Draining a dead lane needs recovery (abort + rebuild),
            # which is the LaneSupervisor's move, not a live migration.
            return RebalanceReport(
                (), (), scores,
                f"hot lane {hot_id} is dead (supervisor's job)")
        hot = self.engines[hot_id]
        cold = self.engines[cold_id]
        telemetry = tels[hot_id]
        # The victim: the hot engine's deepest queue moves the most
        # pressure per migration. Skip streams with nothing queued
        # (moving them changes no score) and ids already open on the
        # target (restore demands a fresh stream).
        for sid, snap in sorted(telemetry.streams.items(),
                                key=lambda kv: kv[1].queued, reverse=True):
            if snap.queued <= 0 or cold.has_stream(sid):
                continue
            record = migrate_stream(hot.handle(sid), cold,
                                    store=self.store)
            self.migrations.append(record)
            self._cooldown = self.config.cooldown
            return RebalanceReport(
                (record,), record.displaced, scores,
                f"moved {sid!r}: {hot_id} ({scores[hot_id]:.2f}) -> "
                f"{cold_id} ({scores[cold_id]:.2f})")
        return RebalanceReport(
            (), (), scores,
            f"no migratable stream on {hot_id} (gap {gap:.2f})")
