"""Fleet pieces of the port (the counterpart of ``repro.fleet``).

So far the two the serving surface's fault and migration paths stand on:

  * :class:`~repro_torch.fleet.faults.FaultInjector` -- seeded, replayable
    fault schedules (step errors, NaN poison, stalls, lane kills) wrapped
    around any engine as a :class:`~repro_torch.fleet.faults.FaultyEngine`,
    so every recovery path of ``StreamEngine`` can be driven on purpose;
  * :class:`~repro_torch.fleet.store.CheckpointStore` -- pickled
    ``StreamCheckpoint`` blobs with single-use restore and an LRU bound.

The control-plane policies (autoscaler, migration, rebalancer, lane
supervisor) are not ported yet (see ROADMAP).
"""
from repro_torch.core._api import FaultConfig
from repro_torch.fleet.faults import (FaultInjector, FaultyEngine,
                                      InjectedFault, LaneStall)
from repro_torch.fleet.store import CheckpointStore

__all__ = ["FaultConfig", "FaultInjector", "FaultyEngine", "InjectedFault",
           "LaneStall", "CheckpointStore"]
