"""Step builders + abstract input specs for every (arch x shape) cell
(port of ``repro.launch.steps``).

``input_specs(cfg, shape)`` returns meta tensors (shapes and dtypes, no
storage) for each model input, and ``abstract_cache``/
``abstract_opt_state`` the decode cache and the AdamW state the same way.
``make_*_step`` build the step functions:

  train_step(params, opt_state, batch) -> (params', opt_state', metrics)
  prefill_step(params, batch)          -> last-position logits
  serve_step(params, cache, tokens)    -> (next_tokens, cache')

A prefill or train batch is ``Model.apply``'s: ``{"tokens"}`` (plus
``"targets"`` to train), ``"patch_embeds"`` for the VLM and the encoder's
``"frames"`` (B, S_enc, frontend_dim) for the enc-dec family. The steps
are eager (no compilation); a train step runs inside
``training.deterministic(all_ops=True)``, as ``Trainer``'s does.

A serve step runs in ``execution_mode("serve")``, as the JAX package's
does. Under a process mesh (``distributed.runtime``) it takes this
rank's blocks -- the params under ``sharding.decode_pspecs``' specs (the
train layout, ``_quantized_pspecs`` for a ternary tree), the cache under
``cache_pspecs``, the rank's rows of the tokens, tagged with their spec
by ``sharding.local_block`` -- and returns the rank's rows of the next
tokens (tagged with the same spec, so steps chain) and its block of the
new cache: the weights stay in their blocks and only activations cross
ranks (``models.layers``). The tokens' spec says which batch axes split
the rows (``annotate.serve_rows``): a global batch that an axis does not
divide (B=1, the ``long_500k`` cells) is whole on every rank of it, and
the cache is then split over a sequence or state dim instead (context
parallelism).
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.configs.shapes import ShapeSpec
from repro_torch.distributed import annotate as A
from repro_torch.distributed import collectives as C
from repro_torch.distributed.annotate import execution_mode
from repro_torch.models import build_model
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.training.determinism import deterministic
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update)
from repro_torch.training.trainer import loss_and_grads

__all__ = [
    "input_specs", "abstract_cache", "abstract_opt_state",
    "make_train_step", "make_prefill_step", "make_serve_step",
]

_I32 = torch.int32


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Abstract model inputs for a cell (train/prefill batch, or the decode
    token batch; decode caches come from ``abstract_cache``)."""
    b = shape.global_batch
    s = shape.seq_len if shape.kind != "decode" else 1
    specs = {"tokens": _spec((b, s), _I32)}
    if shape.kind == "train":
        specs["targets"] = _spec((b, s), _I32)
    if cfg.family == "encdec" and shape.kind != "decode":
        fd = cfg.frontend_dim or cfg.d_model
        specs["frames"] = _spec((b, shape.seq_len, fd), torch.float32)
    if cfg.family == "vlm" and shape.kind != "decode":
        # Dynamic-resolution stub: 1/4 of the sequence is vision patches.
        n_vis = max(shape.seq_len // 4, 16)
        specs["patch_embeds"] = _spec((b, n_vis, cfg.d_model),
                                      torch.float32)
    return specs


def abstract_cache(cfg: ModelConfig, shape: ShapeSpec) -> Any:
    """Meta-tensor tree of the decode cache for this cell."""
    return build_model(cfg).init_cache(shape.global_batch, shape.seq_len,
                                       device="meta")


def abstract_opt_state(cfg: ModelConfig) -> Any:
    """Meta-tensor tree of the AdamW state (f32 moments, int32 step)."""
    return adamw_init(build_model(cfg).abstract_params())


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig | None = None,
                    *, remat: bool = True,
                    scan_layers: bool = True) -> Callable:
    """One AdamW step on ``Model.loss``'s gradients. Returns
    ``(params', opt_state', {"ce", "tokens", "aux", "grad_norm", "lr",
    "loss"})``; nothing is updated in place."""
    opt_cfg = opt_cfg or AdamWConfig()
    model = build_model(cfg)

    def train_step(params, opt_state, batch):
        with deterministic(all_ops=True):
            loss, metrics, grads = loss_and_grads(
                model, params, batch, remat=remat, scan_layers=scan_layers)
            new_params, new_opt, om = adamw_update(grads, opt_state, params,
                                                   opt_cfg)
        return new_params, new_opt, {**metrics, **om, "loss": loss}

    return train_step


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
        spec = A.spec_of(tokens)
        with execution_mode("serve"), A.serve_rows(
                None if spec is None else spec[0]):
            if spec is None and C.active() is not None:
                raise ValueError(
                    "tokens without a spec under a process mesh: place "
                    "them with sharding.local_block under decode_pspecs")
            logits, new_cache = model.decode(params, cache, tokens)
            next_tok = L.greedy_tokens(logits[:, -1:], cfg.vocab_size)
        next_tok = next_tok.to(torch.int32)
        return (next_tok if spec is None else A.tag(next_tok, spec)), \
            new_cache

    return serve_step
