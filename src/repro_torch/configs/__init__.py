"""Model configurations of the port.

``CONFIG``, ``SMOKE``, ``TCN_CONFIG``, ``TCN_SMOKE`` and ``WINDOW_MS`` are
the paper's networks (``colibries``). ``get_config(arch, smoke=False)``
is the JAX package's architecture registry, with its names: ``ARCHS``
lists the 10 LM-family architectures. The port has ``rwkv6-7b`` (and
``colibries``); the others raise ``NotImplementedError`` until their
family is ported (ROADMAP queue 1, item 13).
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
    "rwkv6-7b": "rwkv6_7b",
    "colibries": "colibries",
}


def get_config(arch: str, smoke: bool = False) -> Any:
    if arch in _MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
        return mod.SMOKE if smoke else mod.CONFIG
    if arch in ARCHS:
        raise NotImplementedError(
            f"{arch!r} is not ported yet: its family comes with ROADMAP "
            f"queue 1, item 13 (the LM seed assets)")
    raise KeyError(f"unknown arch {arch!r}; known: "
                   f"{sorted(set(ARCHS) | set(_MODULES))}")
