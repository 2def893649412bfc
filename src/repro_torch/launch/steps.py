"""Step builders (port of ``repro.launch.steps``, serving half):

  prefill_step(params, batch)          -> last-position logits
  serve_step(params, cache, tokens)    -> (next_tokens, cache')

A prefill batch is ``Model.apply``'s: ``{"tokens"}``, plus
``"patch_embeds"`` for the VLM and the encoder's ``"frames"`` (B, S_enc,
frontend_dim) for the enc-dec family.

``make_train_step`` and the abstract input specs of the dry-run come with
LM training (ROADMAP queue 1, item 6: the rest of item 13).
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig

__all__ = ["make_prefill_step", "make_serve_step"]


def make_prefill_step(cfg: ModelConfig) -> Callable:
    model = build_model(cfg)

    def prefill_step(params, batch):
        logits, _ = model.apply(params, batch)
        # A copy of the last position, so the (B, S, V) f32 logits are
        # freed on return rather than kept alive by a view.
        return logits[:, -1].contiguous()    # next-token distribution

    return prefill_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    model = build_model(cfg)

    def serve_step(params, cache, tokens):
        logits, new_cache = model.decode(params, cache, tokens)
        next_tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        return next_tok, new_cache

    return serve_step
