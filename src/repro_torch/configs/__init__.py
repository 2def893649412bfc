"""Model configurations of the port.

``CONFIG``, ``SMOKE``, ``TCN_CONFIG``, ``TCN_SMOKE`` and ``WINDOW_MS`` are
the paper's networks (``colibries``). ``get_config(arch, smoke=False)``
is the JAX package's architecture registry, with its names: ``ARCHS``
lists the 10 LM-family architectures, and the port has every one of
them: the transformer families (dense, MoE, VLM: seven archs),
``rwkv6-7b``, the ``zamba2-1.2b`` hybrid and the ``seamless-m4t-medium``
encoder-decoder, besides ``colibries``. ``shapes`` holds the JAX
package's dry-run shape sets.
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

# Each architecture's module.
_MODULES = {
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "glm4-9b": "glm4_9b",
    "nemotron-4-340b": "nemotron_4_340b",
    "llama3.2-1b": "llama3_2_1b",
    "rwkv6-7b": "rwkv6_7b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "deepseek-moe-16b": "deepseek_moe_16b",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "colibries": "colibries",
}


def get_config(arch: str, smoke: bool = False) -> Any:
    if arch in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
        return mod.SMOKE if smoke else mod.CONFIG
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(set(ARCHS) | set(_MODULES))}")
