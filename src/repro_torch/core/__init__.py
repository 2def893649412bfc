"""Core of the port: LIF dynamics (``lif``), event voxelization
(``events``), the spiking CNN (``snn``), the batched closed loop
(``pipeline``); frame acquisition (``frames``), ternary quantization and
2-bit packing (``ternary``), the CUTIE ternary CNN (``tcn``); the engine
protocol and the frame-wing engine (``engine``); one captured CUDA graph
per shape key (``graphs``); and the copied
pure-Python modules (``_api``, ``energy``, ``tiling``).

The package exposes the names of ``repro.core.__all__``, but imports none
of its modules until one of those names is first read (a module-level
``__getattr__``, PEP 562): a kernel module can import
``repro_torch.core.lif`` or ``repro_torch.core.ternary`` without pulling
in the model that calls it.
"""
from __future__ import annotations

import importlib

# Each public name and the module of this package that defines it.
_SOURCES = {
    "_api": ("EngineConfig",),
    "lif": ("LIFParams", "lif_scan_reference", "lif_step",
            "spike_surrogate"),
    "snn": ("SNNConfig", "SNN_STATE_LAYERS", "init_snn", "snn_apply",
            "snn_init_state", "snn_logits", "snn_loss"),
    "ternary": ("pack2bit", "ternarize", "ternary_ste", "unpack2bit"),
    "tiling": ("SNE_NEURON_CAPACITY", "TilePlan", "plan_layer_tiles",
               "plan_network"),
    "energy": ("KRAKEN_DOMAINS", "CUTIE_DOMAIN", "FRAME_DOMAINS",
               "KrakenModel", "NOMINAL", "NOMINAL_FRAME", "StageExecution",
               "pipeline_energy"),
    "pipeline": ("BatchedClosedLoop", "ClosedLoopPipeline",
                 "ClosedLoopResult", "pwm_from_logits"),
    "tcn": ("TCNConfig", "init_tcn", "pack_tcn", "tcn_apply",
            "tcn_layer_macs"),
    "engine": ("FrameTCNEngine", "InferenceEngine"),
}
_MODULE_OF = {name: mod for mod, names in _SOURCES.items() for name in names}

__all__ = [name for names in _SOURCES.values() for name in names]


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{mod}"), name)
    globals()[name] = value
    return value
