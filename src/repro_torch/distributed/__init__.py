"""Distribution of the port: mesh construction, sharding rules (FSDP/TP/
EP/CP + the serving engines' slot axis), in-model annotations (port of
``repro.distributed``).

The rules are specs, plain tuples of mesh axis names: what a tensor's
shards would be on a mesh. Binding them to devices (the JAX package's
``shardings`` and ``slot_shardings``) is the multi-GPU runtime, which
waits for ROADMAP item 7.
"""
from repro_torch.distributed.mesh import Mesh, make_mesh, slot_axis
from repro_torch.distributed.sharding import (batch_pspecs, cache_pspecs,
                                              opt_pspecs, param_pspecs,
                                              slot_pspec, slot_state_pspecs)
from repro_torch.distributed.annotate import constrain, current_mesh

__all__ = ["Mesh", "make_mesh", "slot_axis", "batch_pspecs", "cache_pspecs",
           "opt_pspecs", "param_pspecs", "slot_pspec", "slot_state_pspecs",
           "constrain", "current_mesh"]
