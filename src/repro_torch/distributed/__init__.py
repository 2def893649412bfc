"""Distribution of the port: mesh construction, sharding rules (FSDP/TP/
EP/CP + the serving engines' slot axis), in-model annotations (port of
``repro.distributed``).

The rules are specs, plain tuples of mesh axis names: what a tensor's
shards are on a mesh. ``shardings``/``slot_shardings`` bind them to a
mesh (:class:`NamedSharding`), ``place`` cuts tensors into per-device
blocks (:class:`ShardedTensor`) and ``gather`` joins them again; the
serving engines shard their slots with them (``EngineConfig.mesh``).
"""
from repro_torch.distributed.mesh import Mesh, make_mesh, slot_axis
from repro_torch.distributed.sharding import (NamedSharding, ShardedTensor,
                                              batch_pspecs, cache_pspecs,
                                              gather, opt_pspecs,
                                              param_pspecs, place, shardings,
                                              slot_pspec, slot_shardings,
                                              slot_state_pspecs)
from repro_torch.distributed.annotate import constrain, current_mesh

__all__ = ["Mesh", "make_mesh", "slot_axis", "batch_pspecs", "cache_pspecs",
           "opt_pspecs", "param_pspecs", "slot_pspec", "slot_state_pspecs",
           "shardings", "slot_shardings", "NamedSharding", "ShardedTensor",
           "place", "gather", "constrain", "current_mesh"]
