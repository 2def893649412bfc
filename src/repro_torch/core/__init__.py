"""Core of the port: LIF dynamics (``lif``), event voxelization
(``events``), the spiking CNN (``snn``), the batched closed loop
(``pipeline``), the engine protocol (``engine``) and the copied
pure-Python modules (``_api``, ``energy``, ``tiling``).

The package imports none of its modules, so a kernel module can import
``repro_torch.core.lif`` without pulling in the model that calls it.
"""
