"""Fleet control plane of the port: the policy layer over the serving
primitives (the counterpart of ``repro.fleet``).

The serving layer holds every mechanism this needs (host-serializable
``StreamCheckpoint`` with bitwise restore, per-stream ``StreamStats``,
one captured CUDA graph per shape key, live lane resize/drain hooks);
this package is the control plane that drives them, in three
cooperating pieces:

  * :class:`~repro_torch.fleet.autoscale.LaneAutoscaler` -- watches one
    lane's queue-depth and deadline-miss telemetry and resizes its slot
    count: grow on sustained backlog, shrink on idle, each new slot
    count's graph captured inside ``resize_lane``.
  * :mod:`~repro_torch.fleet.migrate` -- live migration: checkpoint a
    stream *while windows are in flight* by draining only its lane
    (``drain_lane``), then replay the checkpoint into another engine,
    bitwise-identical to an uninterrupted scan.
  * :class:`~repro_torch.fleet.store.CheckpointStore` +
    :class:`~repro_torch.fleet.rebalance.FleetRebalancer` -- snapshot
    every engine's telemetry, score load (queue depth + deadline-miss
    rate), and migrate streams hot-to-cold through the store, with an
    imbalance dead-band and a post-move cooldown so it never thrashes.

Fault tolerance rides the same surfaces:

  * :class:`~repro_torch.fleet.faults.FaultInjector` -- seeded,
    replayable fault schedules (step errors, NaN poison, stalls, lane
    kills) wrapped around any engine as a
    :class:`~repro_torch.fleet.faults.FaultyEngine`, so every recovery
    path is testable.
  * :class:`~repro_torch.fleet.supervisor.LaneSupervisor` -- journals
    submissions, auto-checkpoints watched streams every K ticks into
    the (capacity-bounded, LRU) :class:`CheckpointStore`, and on lane
    death rebuilds the lane and restores+replays -- bitwise-identical
    for every window ever reported successful.
  * the rebalancer's load score charges ``fault_weight`` for a lane's
    retry/quarantine churn (flat penalty when dead), so unhealthy lanes
    shed load before they fail outright.

Every knob lives in :class:`~repro_torch.core._api.FleetConfig`
(injection schedules in :class:`~repro_torch.core._api.FaultConfig`);
the serving layer stays policy-free. The package is plain Python: what
it costs on the card is the mechanisms it calls (a resize's capture, a
migration's drain and copies, a rebuilt engine's first capture).
"""
from repro_torch.core._api import FaultConfig, FleetConfig
from repro_torch.fleet.autoscale import LaneAutoscaler, ScaleDecision
from repro_torch.fleet.faults import (FaultInjector, FaultyEngine,
                                      InjectedFault, LaneStall)
from repro_torch.fleet.migrate import (MigrationRecord, checkpoint_live,
                                       migrate_stream)
from repro_torch.fleet.rebalance import (FleetRebalancer, RebalanceReport,
                                         load_score)
from repro_torch.fleet.store import CheckpointStore
from repro_torch.fleet.supervisor import LaneSupervisor

__all__ = [
    "FleetConfig", "FaultConfig",
    "LaneAutoscaler", "ScaleDecision",
    "FaultInjector", "FaultyEngine", "InjectedFault", "LaneStall",
    "MigrationRecord", "checkpoint_live", "migrate_stream",
    "FleetRebalancer", "RebalanceReport", "load_score",
    "CheckpointStore",
    "LaneSupervisor",
]
