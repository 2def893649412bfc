"""Distribution of the port: mesh construction, sharding rules (FSDP/TP/
EP/CP + the serving engines' slot axis), in-model annotations (port of
``repro.distributed``).

The rules are specs, plain tuples of mesh axis names: what a tensor's
shards are on a mesh. ``shardings``/``slot_shardings`` bind them to a
mesh (:class:`NamedSharding`), ``place`` cuts tensors into per-device
blocks (:class:`ShardedTensor`) and ``gather`` joins them again; the
serving engines shard their slots with them (``EngineConfig.mesh``).

Training over a mesh runs one process a rank (``runtime``: ``init``,
``spawn``, :class:`ProcessMesh`): each rank holds its ``local_block`` of
every tensor, the models gather FSDP dims at use (``unshard_fsdp``) and
place Megatron's tensor-parallel collectives (``collectives``), and
``gather_logical`` joins the blocks into whole arrays for checkpoints.
"""
from repro_torch.distributed.mesh import Mesh, make_mesh, slot_axis
from repro_torch.distributed.sharding import (NamedSharding, ShardedTensor,
                                              batch_pspecs, cache_pspecs,
                                              gather, gather_logical,
                                              local_block, opt_pspecs,
                                              param_pspecs, place, shardings,
                                              slot_pspec, slot_shardings,
                                              slot_state_pspecs)
from repro_torch.distributed.annotate import (constrain, current_mesh,
                                              unshard_fsdp)
from repro_torch.distributed.runtime import ProcessMesh

__all__ = ["Mesh", "make_mesh", "slot_axis", "batch_pspecs", "cache_pspecs",
           "opt_pspecs", "param_pspecs", "slot_pspec", "slot_state_pspecs",
           "shardings", "slot_shardings", "NamedSharding", "ShardedTensor",
           "place", "gather", "constrain", "current_mesh", "local_block",
           "gather_logical", "unshard_fsdp", "ProcessMesh"]
