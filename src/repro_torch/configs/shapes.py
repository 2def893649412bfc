"""Assigned input-shape sets (identical across the 10 LM-family archs).

  train_4k     seq 4096   global_batch 256   -> train_step
  prefill_32k  seq 32768  global_batch 32    -> prefill (full forward)
  decode_32k   seq 32768  global_batch 128   -> serve_step (1 new token,
                                                32k cache)
  long_500k    seq 524288 global_batch 1     -> serve_step; only for
                                                sub-quadratic archs
                                                (see DESIGN.md skip list)
"""
from __future__ import annotations

import dataclasses
from typing import List

from repro_torch.models.config import ModelConfig

__all__ = ["ShapeSpec", "SHAPES", "cells_for"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def cells_for(cfg: ModelConfig) -> List[ShapeSpec]:
    """The dry-run cells this arch runs (long_500k only if sub-quadratic)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.is_sub_quadratic:
        out.append(SHAPES["long_500k"])
    return out
