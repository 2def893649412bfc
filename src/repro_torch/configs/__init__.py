"""Model configurations of the port.

``CONFIG``, ``SMOKE``, ``TCN_CONFIG``, ``TCN_SMOKE`` and ``WINDOW_MS`` are
the paper's networks (``colibries``). ``get_config(arch, smoke=False)``
is the JAX package's architecture registry, with its names: ``ARCHS``
lists the 10 LM-family architectures. The port has the transformer
families (dense, MoE, VLM: seven archs), ``rwkv6-7b`` and ``colibries``;
``zamba2-1.2b`` and ``seamless-m4t-medium`` raise ``NotImplementedError``
until their families are ported (ROADMAP queue 1, item 6: the rest of
item 13). ``shapes`` holds the JAX package's dry-run shape sets.
"""
from __future__ import annotations

import importlib
from typing import Any

from repro_torch.configs.colibries import (CONFIG, SMOKE, TCN_CONFIG,
                                           TCN_SMOKE, WINDOW_MS)

__all__ = ["CONFIG", "SMOKE", "TCN_CONFIG", "TCN_SMOKE", "WINDOW_MS",
           "ARCHS", "get_config"]

ARCHS = [
    "h2o-danube-1.8b",
    "glm4-9b",
    "nemotron-4-340b",
    "llama3.2-1b",
    "rwkv6-7b",
    "llama4-scout-17b-a16e",
    "deepseek-moe-16b",
    "zamba2-1.2b",
    "seamless-m4t-medium",
    "qwen2-vl-2b",
]

# The architectures the port has, by module.
_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "glm4-9b": "glm4_9b",
    "nemotron-4-340b": "nemotron_4_340b",
    "llama3.2-1b": "llama3_2_1b",
    "rwkv6-7b": "rwkv6_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "colibries": "colibries",
}


def get_config(arch: str, smoke: bool = False) -> Any:
    if arch in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
        return mod.SMOKE if smoke else mod.CONFIG
    if arch in ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: its family comes with ROADMAP "
            f"queue 1, item 6 (the rest of item 13: zamba2 and enc-dec)")
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(set(ARCHS) | set(_MODULES))}")
