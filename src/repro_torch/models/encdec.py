"""Encoder-decoder backbone, Seamless-M4T medium's transformer core (port of
``repro.models.encdec``).

The audio frontend is a stub, as in the JAX package: the encoder consumes
precomputed frame embeddings (B, S, frontend_dim) projected into d_model.
Encoder blocks are bidirectional; decoder blocks are causal
self-attention + cross-attention to the encoder output. Everything is
``models/layers.py``: attention, cross-attention through
``attention_apply(kv_x=...)``, the MLPs (K3 through ``layers.dense`` for a
ternary-packed MLP weight). ``frontend_proj`` is a plain product, as the
JAX package's einsum, so ``encode`` takes float parameters; ternary
parameters serve decode (``generate``, ``BatchScheduler``), as there.

Layers run as a Python loop over the stacked layer axis (``scan_layers``
selects nothing; ``remat`` recomputes each encoder and decoder layer in
the backward, ``layers.remat``).

Under a process mesh (training over a mesh of ``runtime.MESH_AXES``)
the frames are the rank's batch rows, ``frontend_proj`` is gathered at
use over ``data``, every attention (the encoder's, the decoder's self- and
cross-attention, whose ``kv_x`` enters through ``copy_to``) runs on the
rank's heads and the MLPs are tensor-parallel (``layers``); the
embedding is vocab-parallel (``layers.embed_lookup``) and so is the head
where the vocabulary divides ``model`` (``layers.head_logits``; where it
does not, as seamless' 256,206 rows over 4, every rank computes every
logit). A decode step keeps
``pos`` a 0-d device tensor and never reads a value back to the host;
over a process mesh it runs in serve mode (``encdec_decode``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch import resolve_device
from repro_torch.distributed import annotate as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, as_dtype

__all__ = ["encdec_defs", "encdec_apply", "encode", "encdec_decode",
           "init_encdec_cache", "prefill_cross_kv"]


def encdec_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    ne, nd = cfg.encoder_layers, cfg.decoder_layers
    fd = cfg.frontend_dim or d

    enc_layer = {
        "ln1": ParamDef((ne, d), ("layers", "norm"), init="ones"),
        "ln2": ParamDef((ne, d), ("layers", "norm"), init="ones"),
        "attn": L.attention_defs(cfg, layers=ne),
        "mlp": L.mlp_defs(cfg, layers=ne),
    }
    dec_layer = {
        "ln1": ParamDef((nd, d), ("layers", "norm"), init="ones"),
        "ln2": ParamDef((nd, d), ("layers", "norm"), init="ones"),
        "ln3": ParamDef((nd, d), ("layers", "norm"), init="ones"),
        "self_attn": L.attention_defs(cfg, layers=nd),
        "cross_attn": L.attention_defs(cfg, layers=nd),
        "mlp": L.mlp_defs(cfg, layers=nd),
    }
    return {
        "frontend_proj": ParamDef((fd, d), ("embed", "embed_out"),
                                  fan_in_axes=(0,)),
        "embed": ParamDef((v, d), ("vocab", "embed"), fan_in_axes=(1,)),
        "encoder": enc_layer,
        "decoder": dec_layer,
        "ln_enc": ParamDef((d,), ("norm",), init="ones"),
        "ln_f": ParamDef((d,), ("norm",), init="ones"),
        "lm_head": ParamDef((d, v), ("embed", "vocab"), fan_in_axes=(0,)),
    }


def _positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None].expand(b, s)


def _encoder_layer(h, lp, positions, cfg: ModelConfig):
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    h = h + L.attention_apply(lp["attn"], a_in, positions, cfg,
                              causal=False)
    m_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    return h + L.mlp_apply(lp["mlp"], m_in, cfg)


def encode(params: Dict[str, Any], frames: torch.Tensor, cfg: ModelConfig,
           *, remat: bool = False) -> torch.Tensor:
    """frames (B, S_enc, frontend_dim) -> encoder output (B, S_enc, D).
    ``remat`` recomputes each layer in the backward."""
    w = params["frontend_proj"]
    if not isinstance(w, torch.Tensor):
        raise TypeError("encode takes a float frontend_proj (the JAX "
                        "package's plain product); ternary parameters "
                        "serve decode only")
    h = torch.matmul(frames.to(as_dtype(cfg.dtype)),
                     A.unshard_fsdp(w, (None, None)))
    positions = _positions(*h.shape[:2], h.device)
    body = L.remat(_encoder_layer) if remat else _encoder_layer
    for i in range(cfg.encoder_layers):
        h = body(h, L.layer_params(params["encoder"], i), positions, cfg)
    return L.rms_norm(h, params["ln_enc"], cfg.norm_eps)


def _embed(params, tokens, cfg: ModelConfig):
    return L.embed_lookup(params["embed"], tokens).to(as_dtype(cfg.dtype))


def _unembed(params, h, cfg: ModelConfig):
    return L.head_logits(L.rms_norm(h, params["ln_f"], cfg.norm_eps),
                         params["lm_head"])


def _decoder_layer(h, lp, positions, enc_out, cfg: ModelConfig):
    a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
    h = h + L.attention_apply(lp["self_attn"], a_in, positions, cfg,
                              causal=True)
    c_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
    h = h + L.attention_apply(lp["cross_attn"], c_in, positions, cfg,
                              causal=False, kv_x=enc_out)
    m_in = L.rms_norm(h, lp["ln3"], cfg.norm_eps)
    return h + L.mlp_apply(lp["mlp"], m_in, cfg)


def _decoder(params, tokens, enc_out, cfg, *, scan_layers=True,
             remat=False):
    del scan_layers
    b, s = tokens.shape
    h = _embed(params, tokens, cfg)
    positions = _positions(b, s, h.device)
    body = L.remat(_decoder_layer) if remat else _decoder_layer
    for i in range(cfg.decoder_layers):
        h = body(h, L.layer_params(params["decoder"], i), positions,
                 enc_out, cfg)
    return h


def encdec_apply(params: Dict[str, Any], batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, *, scan_layers: bool = True,
                 remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward: ``batch["frames"]`` + decoder ``batch["tokens"]`` ->
    (logits (B,S,V) f32, 0.0)."""
    enc_out = encode(params, batch["frames"], cfg, remat=remat)
    h = _decoder(params, batch["tokens"], enc_out, cfg,
                 scan_layers=scan_layers, remat=remat)
    return (_unembed(params, h, cfg),
            torch.zeros((), dtype=torch.float32, device=h.device))


def init_encdec_cache(cfg: ModelConfig, batch: int, cache_len: int,
                      dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Decoder self-attn KV cache + *precomputed* cross-attn K/V, on
    ``device`` (the card by default).

    Cross keys/values are projected once from the encoder output at
    prefill (``prefill_cross_kv``) -- recomputing them per decode step
    would add 2*S_enc*D*KV FLOPs a step and dominate decode.
    """
    dt = as_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    shape = (cfg.decoder_layers, batch, cache_len, cfg.num_kv_heads,
             cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=dev),
        "v": torch.zeros(shape, dtype=dt, device=dev),
        "ck": torch.zeros(shape, dtype=dt, device=dev),
        "cv": torch.zeros(shape, dtype=dt, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def prefill_cross_kv(params: Dict[str, Any], enc_out: torch.Tensor,
                     cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project the encoder output into stacked per-layer cross K/V,
    (L, B, S_enc, KVH, hd) each."""
    ca = params["decoder"]["cross_attn"]
    ck = torch.einsum("bsd,ldhk->lbshk", enc_out, ca["wk"])
    cv = torch.einsum("bsd,ldhk->lbshk", enc_out, ca["wv"])
    return ck, cv


def encdec_decode(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, cfg: ModelConfig,
                  *, scan_layers: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decoder step attending the precomputed cross K/V. Returns
    (logits f32, new cache); the cache passed in is not modified. Over a
    process mesh (serve mode) the self-attention attends over the rank's
    part of its KV cache, the cross-attention over the rank's part of the
    encoder K/V (``layers.cross_decode``; each in its own layout,
    ``layers.kv_stripe``: a stripe of the sequence combined over the axes
    that split it, or the rank's KV heads or head-dim block), the MLP and
    the head by their serve rules: the result is this rank's rows of the
    logits and its block of the new cache."""
    del scan_layers
    L.check_sharded_decode(cfg, cache)
    h = _embed(params, tokens, cfg)
    pos = cache["pos"]
    stripe = L.kv_stripe(cache["k"])
    cstripe = L.kv_stripe(cache["ck"])
    k_new, v_new = cache["k"].clone(), cache["v"].clone()
    for i in range(cfg.decoder_layers):
        lp = L.layer_params(params["decoder"], i)
        a_in = L.rms_norm(h, lp["ln1"], cfg.norm_eps)
        h = h + L._attend_decode(lp["self_attn"], a_in, k_new[i], v_new[i],
                                 pos, cfg, window=None, mrope=False,
                                 stripe=stripe)
        c_in = L.rms_norm(h, lp["ln2"], cfg.norm_eps)
        h = h + L.cross_decode(lp["cross_attn"], c_in, cache["ck"][i],
                               cache["cv"][i], cfg, cstripe)
        m_in = L.rms_norm(h, lp["ln3"], cfg.norm_eps)
        h = h + L.mlp_apply(lp["mlp"], m_in, cfg)
    return _unembed(params, h, cfg), L.keep_spec({
        "k": k_new, "v": v_new, "ck": cache["ck"], "cv": cache["cv"],
        "pos": pos + 1}, cache)
