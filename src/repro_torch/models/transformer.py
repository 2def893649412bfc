"""Decoder-only transformer backbone: the dense, MoE and VLM families (port
of ``repro.models.transformer``).

Parameters are a nested dict of tensors with the layers stacked on a
leading axis, in the JAX package's layouts, and the layers run as a
Python loop over that axis (the JAX package's ``scan_layers`` selects
nothing here: it changes how XLA compiles the forward, not its values).
``remat`` recomputes each layer in the backward (``layers.remat``, where
the JAX package applies ``jax.checkpoint``). A ternary-packed MLP weight
(``serving.quantize_for_serving``) goes through kernel K3 in
``layers.dense``;
everything else is plain torch ops, as XLA computes it in the JAX
package.

Under a process mesh (training over a mesh of ``runtime.MESH_AXES``)
the embedding and the head are vocab-parallel and the layers tensor-parallel
(``layers``); the logits are then this rank's vocab columns, which
``model.lm_loss`` reduces over ``model``.

A decode step keeps the cache's position ``pos`` a 0-d int tensor on the
device and writes each layer's k and v with an indexed copy, so it never
reads a value back to the host. Over a process mesh (serve mode,
``launch.steps.make_serve_step``) the decode of every family here runs
on the rank's rows, its blocks of the weights and its stripe of the
cache's sequence (``layers``: ``serve_einsum``, ``_attend_decode_serve``
with M-RoPE positions for the VLM, ``_moe_serve`` for the MoE, a tied
head on the embedding's stored block).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, as_dtype

__all__ = [
    "transformer_defs", "transformer_apply", "transformer_decode",
    "init_kv_cache", "unembed",
]


def transformer_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v, nl = cfg.d_model, cfg.vocab_size, cfg.num_layers
    layer: Dict[str, Any] = {
        "ln1": ParamDef((nl, d), ("layers", "norm"), init="ones"),
        "ln2": ParamDef((nl, d), ("layers", "norm"), init="ones"),
        "attn": L.attention_defs(cfg, layers=nl),
    }
    if cfg.family == "moe":
        layer["moe"] = L.moe_defs(cfg, layers=nl)
    else:
        layer["mlp"] = L.mlp_defs(cfg, layers=nl)
    defs: Dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", "embed"), scale=1.0,
                          fan_in_axes=(1,)),
        "layers": layer,
        "ln_f": ParamDef((d,), ("norm",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((d, v), ("embed", "vocab"),
                                   fan_in_axes=(0,))
    return defs


def unembed(params: Dict[str, Any], h: torch.Tensor, cfg: ModelConfig
            ) -> torch.Tensor:
    """Final norm + LM head (``embed.T`` when tied); logits in f32, with
    the optional softcap. Under a process mesh the head is vocab-parallel
    where its vocab divides ``model`` (``layers.head_logits``)."""
    h = L.rms_norm(h, params["ln_f"], cfg.norm_eps)
    logits = (L.head_logits(h, params["embed"], tied=True)
              if cfg.tie_embeddings else L.head_logits(h, params["lm_head"]))
    if cfg.logits_softcap:
        c = cfg.logits_softcap
        logits = c * torch.tanh(logits / c)
    return logits


def _embed(params, tokens, cfg: ModelConfig):
    return L.embed_lookup(params["embed"], tokens).to(as_dtype(cfg.dtype))


def _layer_body(h, lp, positions, cfg: ModelConfig, *, mrope):
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    h = h + L.attention_apply(lp["attn"], a_in, positions, cfg,
                              causal=True, mrope=mrope)
    m_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    if cfg.family == "moe":
        mo, aux = L.moe_apply(lp["moe"], m_in, cfg)
        return h + mo, aux
    return h + L.mlp_apply(lp["mlp"], m_in, cfg), None


def transformer_apply(
    params: Dict[str, Any],
    tokens: torch.Tensor,                 # (B, S) int
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    extra_embeds: Optional[torch.Tensor] = None,  # VLM patch embeddings
    scan_layers: bool = True,
    remat: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V) f32, moe_aux_loss).

    For the VLM family the first ``extra_embeds.shape[1]`` sequence slots
    carry the patch embeddings, and the default positions are M-RoPE rows
    of a square patch grid (``mrope_positions``). ``remat`` recomputes
    each layer's activations in the backward."""
    del scan_layers
    body = L.remat(_layer_body) if remat else _layer_body
    b, s = tokens.shape
    h = _embed(params, tokens, cfg)
    mrope = cfg.family == "vlm"
    n_vis = 0 if extra_embeds is None else extra_embeds.shape[1]
    if extra_embeds is not None:
        h = torch.cat([extra_embeds.to(h.dtype), h[:, n_vis:]], dim=1)
    if positions is None:
        if mrope:
            side = max(int(n_vis ** 0.5), 1)
            positions = L.mrope_positions(b, s, n_vis, (side, side),
                                          device=h.device)
        else:
            positions = torch.arange(s, device=h.device)[None].expand(b, s)

    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["layers"], i)
        h, a = body(h, lp, positions, cfg, mrope=mrope)
        if a is not None:
            aux = aux + a
    return unembed(params, h, cfg), aux


def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Stacked per-layer KV cache on ``device`` (the card by default).
    Sliding-window archs get a ring buffer of the window's size."""
    dt = as_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    if cfg.sliding_window is not None:
        cache_len = min(cache_len, cfg.sliding_window)
    shape = (cfg.num_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "pos": torch.zeros((), dtype=torch.int32, device=dev)}


def transformer_decode(
    params: Dict[str, Any],
    cache: Dict[str, torch.Tensor],
    tokens: torch.Tensor,                 # (B, 1)
    cfg: ModelConfig,
    *,
    window_override: Optional[int] = None,
    scan_layers: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step over the stacked cache. Returns (logits f32, new
    cache); the cache passed in is not modified (the new one is a copy
    written layer by layer). Over a process mesh: this rank's rows of
    the logits (its vocab block where the head is vocab-parallel) and
    its block of the new cache."""
    del scan_layers
    L.check_sharded_decode(cfg, cache)
    h = _embed(params, tokens, cfg)
    mrope = cfg.family == "vlm"
    window = window_override or cfg.sliding_window
    pos = cache["pos"]
    stripe = L.kv_stripe(cache["k"])
    k_new, v_new = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.num_layers):
        lp = L.layer_params(params["layers"], i)
        a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        h = h + L._attend_decode(lp["attn"], a_in, k_new[i], v_new[i], pos,
                                 cfg, window=window, mrope=mrope,
                                 stripe=stripe)
        m_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        if cfg.family == "moe":
            h = h + L.moe_apply(lp["moe"], m_in, cfg)[0]
        else:
            h = h + L.mlp_apply(lp["mlp"], m_in, cfg)
    logits = unembed(params, h, cfg)
    return logits, L.keep_spec({"k": k_new, "v": v_new, "pos": pos + 1},
                               cache)
