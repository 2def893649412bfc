"""Core of the port: LIF dynamics (``lif``), event voxelization
(``events``), the spiking CNN (``snn``), the batched closed loop
(``pipeline``); frame acquisition (``frames``), ternary quantization and
2-bit packing (``ternary``), the CUTIE ternary CNN (``tcn``); the engine
protocol and the frame-wing engine (``engine``); one captured CUDA graph
per shape key (``graphs``); and the copied
pure-Python modules (``_api``, ``energy``, ``tiling``).

The package imports none of its modules, so a kernel module can import
``repro_torch.core.lif`` or ``repro_torch.core.ternary`` without pulling
in the model that calls it.
"""
