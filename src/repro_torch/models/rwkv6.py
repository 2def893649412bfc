"""RWKV-6 "Finch" (arXiv:2404.05892): attention-free LM with token-shift
and data-dependent per-channel decay (port of ``repro.models.rwkv6``).

Every WKV recurrence -- the full-sequence forward (``rwkv6_apply``,
from a zero state) and each decode step (``T=1`` from the cache's state)
-- runs through ``kernels.ops.wkv6_scan``, kernel K4 on the card. K4
fixes the order of its sums (r.S in 16-wide i-segments, the bonus term
as the rank-one ((r*u).k) v; ``kernels/wkv6_scan.py``), and its state
update keeps the rounding of the stepwise form. Under autograd the
WKV's gradient is that of ``wkv6_chunked`` (the JAX package's
chunked-parallel form, ``kernels/wkv6_scan.py``), recomputed in the
backward; ``_wkv6_step`` (its stepwise decode) stays a plain oracle for
the tests. Both agree with K4 within rounding.

Parameters are a nested dict of tensors with the layers stacked on a
leading axis, in the JAX package's layouts (projection weights (K, N)),
and the layers run as a Python loop over that axis. Under a process mesh
(training over a mesh of ``runtime.MESH_AXES``) the model is
tensor-parallel over heads: ``wr/wk/wv/wg`` are column-parallel
(``heads_x``), so each rank runs the WKV -- K4 on the card -- on its
``H/|model|`` heads, with its
heads' block of ``u`` and its channels of ``w0``, ``gn_s`` and ``gn_b``
(``split_to``: the replicated leaves' gradients come back whole); ``wo``
and the channel mix's ``wv`` are row-parallel; the embedding and the
head are vocab-parallel; ``unshard_fsdp`` gathers the FSDP dims at the
JAX package's sites. A decode step over a process mesh runs in serve
mode (``launch.steps.make_serve_step``): every product reads the block
its rank stores (``layers.serve_einsum``; ``dense`` and K3 on a packed
block's columns), the rank's rows go through K4 on its heads from its
block of the cache's state, and the token-shift caches keep the rank's
rows. Where the global batch does not divide the batch axes the rows are
whole on every rank of them and the state's dk is split over ``data``:
each rank steps its stripe of rows through K4's stripe entry
(``_wkv_stripe``).

Numerics note (as in the JAX package): the per-step log-decay is clamped
to >= -4, so the chunked form's exp(-cumsum) stays in f32 range at chunk
16; the clamp binds only in the far tail of official RWKV-6 decays.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.distributed import annotate as A
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.kernels.wkv6_scan import CHUNK as _WKV_CHUNK
from repro_torch.kernels.wkv6_scan import wkv6_chunked, wkv6_stripe_combine
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, as_dtype

__all__ = ["rwkv6_defs", "rwkv6_apply", "rwkv6_decode", "init_rwkv_cache",
           "wkv6_chunked"]

_LOGW_MIN = -4.0


def rwkv6_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v, nl, r = cfg.d_model, cfg.vocab_size, cfg.num_layers, \
        cfg.rwkv_lora_rank
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim

    def pd(shape, axes, **kw):
        return ParamDef((nl,) + shape, ("layers",) + axes, **kw)

    layer = {
        "ln1_s": pd((d,), ("norm",), init="ones"),
        "ln1_b": pd((d,), ("norm",), init="zeros"),
        "ln2_s": pd((d,), ("norm",), init="ones"),
        "ln2_b": pd((d,), ("norm",), init="zeros"),
        "tm": {
            # ddlerp: 5 interpolation targets (r, k, v, w, g).
            "mu": pd((5, d), (None, "norm"), init="zeros"),
            "lora_a": pd((d, 5, r), ("embed", None, "lora"),
                         fan_in_axes=(2,)),
            "lora_b": pd((5, r, d), (None, "lora", "embed"),
                         fan_in_axes=(2,), scale=0.1),
            # data-dependent decay lora + base.
            "w0": pd((d,), ("norm",), init="constant", constant=-0.6),
            "wa": pd((d, r), ("embed", "lora"), fan_in_axes=(1,)),
            "wb": pd((r, d), ("lora", "embed"), fan_in_axes=(1,),
                     scale=0.1),
            "u": pd((h, hd), ("heads", "head_dim"), init="zeros"),
            "wr": pd((d, d), ("embed", "heads_x"), fan_in_axes=(1,)),
            "wk": pd((d, d), ("embed", "heads_x"), fan_in_axes=(1,)),
            "wv": pd((d, d), ("embed", "heads_x"), fan_in_axes=(1,)),
            "wg": pd((d, d), ("embed", "heads_x"), fan_in_axes=(1,)),
            "wo": pd((d, d), ("heads_x", "embed"), fan_in_axes=(1,)),
            "gn_s": pd((d,), ("norm",), init="ones"),
            "gn_b": pd((d,), ("norm",), init="zeros"),
        },
        "cm": {
            "mu_k": pd((d,), ("norm",), init="zeros"),
            "mu_r": pd((d,), ("norm",), init="zeros"),
            "wk": pd((d, cfg.d_ff), ("embed", "mlp"), fan_in_axes=(1,)),
            "wv": pd((cfg.d_ff, d), ("mlp", "embed"), fan_in_axes=(1,)),
            "wr": pd((d, d), ("embed", "heads_x"), fan_in_axes=(1,)),
        },
    }
    return {
        "embed": ParamDef((v, d), ("vocab", "embed"), fan_in_axes=(1,)),
        "ln0_s": ParamDef((d,), ("norm",), init="ones"),
        "ln0_b": ParamDef((d,), ("norm",), init="zeros"),
        "layers": layer,
        "ln_f_s": ParamDef((d,), ("norm",), init="ones"),
        "ln_f_b": ParamDef((d,), ("norm",), init="zeros"),
        "lm_head": ParamDef((d, v), ("embed", "vocab"), fan_in_axes=(0,)),
    }


# ----------------------------------------------------------------------
# WKV recurrence -- the stepwise oracle (the served path runs K4)
# ----------------------------------------------------------------------


def _wkv6_step(r, k, v, logw, u, state):
    """Single-token WKV step. r/k/v/logw (B,H,hd); state (B,H,hd,hd)."""
    r_, k_, v_, w_ = (x.float() for x in (r, k, v, torch.exp(logw)))
    kv = torch.einsum("bhi,bhj->bhij", k_, v_)
    o = torch.einsum("bhi,bhij->bhj", r_,
                     state + u.float()[None, :, :, None] * kv)
    state = w_[..., None] * state + kv
    return o.to(r.dtype), state


# ----------------------------------------------------------------------
# Blocks
# ----------------------------------------------------------------------


def _token_shift(x: torch.Tensor, last: Optional[torch.Tensor] = None):
    """Previous-token tensor; ``last`` (B, D) seeds position 0 (decode)."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _product(eq, x, w):
    """``torch.einsum(eq, x, w)`` of a weight gathered at use
    (``unshard_fsdp``: tiny, replicated), or on the stored block in serve
    mode under a process mesh (``layers.serve_einsum``)."""
    if A.serving():
        return L.serve_einsum(eq, x, w)
    return torch.einsum(eq, x, A.unshard_fsdp(w))


def _ddlerp(tm, x, sx):
    """Data-dependent interpolation producing (r,k,v,w,g) inputs."""
    xx = sx - x
    base = x + xx * tm["mu"][:, None, None]            # (5, B, S, D)
    lora = torch.tanh(_product("bsd,dkr->bskr", x + xx * 0.5,
                               tm["lora_a"]))
    adj = _product("bskr,krd->kbsd", lora, tm["lora_b"])
    return base + xx[None] * adj                        # (5, B, S, D)


def _time_mix(tm, x, cfg: ModelConfig, *, sx=None, state0=None,
              stripe=False):
    """The time mix of one layer. The WKV runs through K4 in both modes:
    the whole sequence from a zero state (``state0`` None), or a decode
    step from the cache's ``state0`` and token-shift ``sx``; with
    ``stripe``, ``state0`` is this rank's stripe of dk rows over ``data``
    (``_wkv_stripe``). Returns (output, final WKV state). Under a process
    mesh r/k/v/g are this rank's channels (column-parallel), which must
    be whole heads."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    sx = _token_shift(x, sx)
    xr, xk, xv, xw, xg = _ddlerp(tm, x, sx)
    r = L.dense(xr, tm["wr"])
    dl = r.shape[-1]                           # this rank's channels
    if dl % hd:
        raise ValueError(f"{dl} channels a rank split a {hd}-wide head")
    hl = dl // hd
    r = r.reshape(b, s, hl, hd)
    k = L.dense(xk, tm["wk"]).reshape(b, s, hl, hd)
    v = L.dense(xv, tm["wv"]).reshape(b, s, hl, hd)
    g = L.dense(xg, tm["wg"])
    if A.serving():
        dec = L.serve_einsum("bsr,rd->bsd", torch.tanh(L.serve_einsum(
            "bsd,dr->bsr", xw, tm["wa"])), tm["wb"])
    else:
        dec = torch.tanh(xw @ A.unshard_fsdp(tm["wa"])) @ A.unshard_fsdp(
            tm["wb"])
    w0, gn_s, gn_b = tm["w0"], tm["gn_s"], tm["gn_b"]
    u = tm["u"]
    if dl != d:                                # this rank's heads
        dec, w0, gn_s, gn_b = (C.split_to(t, -1, "model")
                               for t in (dec, w0, gn_s, gn_b))
        if not A.serving():                    # else: the stored block
            u = A.unshard_fsdp(u, ("model", None))
        if u.shape[0] != hl or (state0 is not None
                                and state0.shape[1] != hl):
            raise NotImplementedError(
                f"{hl} heads a rank against u of {u.shape[0]} heads and a "
                f"state of {None if state0 is None else state0.shape[1]}")
    logw = -torch.exp((w0 + dec).float())
    logw = torch.clamp(logw, min=_LOGW_MIN).reshape(b, s, hl, hd)
    if stripe:
        o, state = _wkv_stripe(r, k, v, logw, u, state0)
    else:
        o, state = ops.wkv6_scan(r, k, v, logw, u, state0)
    # Per-head group norm (population variance, as jnp.var), then the
    # SiLU(g) gate (RWKV-6 output block).
    mu = o.mean(dim=-1, keepdim=True)
    var = torch.var(o, dim=-1, keepdim=True, correction=0)
    o = ((o - mu) * torch.rsqrt(var + 64e-5)).reshape(b, s, dl)
    o = o * gn_s + gn_b
    o = o * F.silu(g)
    return L.dense(o, tm["wo"], role="down"), state


def _wkv_stripe(r, k, v, logw, u, state0):
    """The WKV of a decode step whose state block holds this rank's stripe
    of dk rows over ``data`` (``cache_pspecs`` at a global batch the batch
    axes do not divide): r, k, v, logw and u are whole on every ``data``
    rank (the projections' sums all-reduced there), K4's stripe entry
    steps the rank's rows and returns their segments' partials of r.S,
    which are gathered over ``data`` (activations, never the state) and
    added in ascending row order with the whole bonus term
    (``wkv6_stripe_combine``): one-device K4's ``o`` bit for bit where the
    stripe is a multiple of 16 rows."""
    dk, hd = state0.shape[2], r.shape[-1]
    if dk * C.axis_size("data") != hd:
        raise ValueError(f"a state block of {dk} of {hd} rows over a data "
                         f"axis of {C.axis_size('data')}")
    part, beta, state = ops.wkv6_stripe(r, k, v, logw, u, state0,
                                        C.axis_index("data") * dk)
    return wkv6_stripe_combine(C.gather_dim(part, 3, "data"), beta,
                               v), state


def _channel_mix(cm, x, *, sx=None):
    sx = _token_shift(x, sx)
    xx = sx - x
    xk = x + xx * cm["mu_k"]
    xr = x + xx * cm["mu_r"]
    kk = torch.square(torch.relu(L.dense(xk, cm["wk"])))
    kv = L.dense(kk, cm["wv"], role="down")
    return torch.sigmoid(L.dense(xr, cm["wr"], gather_output=True)) * kv


def _layer(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    return L.layer_params(layers, i)


def _embed(params, tokens, cfg: ModelConfig):
    h = L.embed_lookup(params["embed"], tokens).to(as_dtype(cfg.dtype))
    return L.layer_norm(h, params["ln0_s"], params["ln0_b"], cfg.norm_eps)


def _unembed(params, h, cfg: ModelConfig):
    """Final norm and f32 logits (``layers.head_logits``: the JAX
    package's ``preferred_element_type=float32`` product); under a process
    mesh this rank's vocab columns where ``model`` divides the vocab."""
    h = L.layer_norm(h, params["ln_f_s"], params["ln_f_b"], cfg.norm_eps)
    return L.head_logits(h, params["lm_head"])


def _layer_body(h, lp, cfg: ModelConfig):
    x = L.layer_norm(h, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
    tm_out, _ = _time_mix(lp["tm"], x, cfg)
    h = h + tm_out
    x = L.layer_norm(h, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
    return h + _channel_mix(lp["cm"], x)


def rwkv6_apply(params: Dict[str, Any], tokens: torch.Tensor,
                cfg: ModelConfig, *, scan_layers: bool = True,
                remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over (B, S) tokens. Returns (logits f32,
    aux=0).

    S must be a multiple of min(16, S), as the JAX package's chunked form
    requires, so both packages accept the same inputs. The layers always
    run as a loop (``scan_layers`` selects nothing); ``remat`` recomputes
    each layer in the backward (``layers.remat``, where the JAX package
    applies ``jax.checkpoint``), so K4 runs twice a layer in a training
    step.
    """
    del scan_layers
    s = tokens.shape[1]
    c = min(_WKV_CHUNK, s)
    if c and s % c:
        raise ValueError(f"seq {s} not divisible by chunk {c}")
    body = L.remat(_layer_body) if remat else _layer_body
    h = _embed(params, tokens, cfg)
    for i in range(cfg.num_layers):
        h = body(h, _layer(params["layers"], i), cfg)
    logits = _unembed(params, h, cfg)
    return logits, torch.zeros((), dtype=torch.float32, device=h.device)


def init_rwkv_cache(cfg: ModelConfig, batch: int, cache_len: int = 0,
                    dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """O(1) recurrent cache: WKV state + token-shift states per layer, on
    ``device`` (the card by default).

    ``cache_len`` is ignored (constant-size state).
    """
    del cache_len
    dev = resolve_device(device)
    nl, d = cfg.num_layers, cfg.d_model
    h, hd = cfg.rwkv_heads, cfg.rwkv_head_dim
    dt = as_dtype(dtype or cfg.dtype)
    return {
        "state": torch.zeros((nl, batch, h, hd, hd), dtype=torch.float32,
                             device=dev),
        "tm_x": torch.zeros((nl, batch, d), dtype=dt, device=dev),
        "cm_x": torch.zeros((nl, batch, d), dtype=dt, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def rwkv6_decode(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                 tokens: torch.Tensor, cfg: ModelConfig,
                 *, scan_layers: bool = True
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. tokens (B, 1). Returns (logits f32, new cache);
    the cache passed in is not modified. Over a process mesh (serve
    mode): this rank's rows of the logits (its vocab block) and its
    block of the new cache (``cache_pspecs``: the state's heads over
    ``model``, every leaf's rows over the batch axes that divide the
    batch; where none divides it, the state's dk over ``data``)."""
    del scan_layers
    L.check_sharded_decode(cfg, cache)
    stripe = L.state_split("state", cache["state"])
    h = _embed(params, tokens, cfg)
    states, tm_xs, cm_xs = [], [], []
    for i in range(cfg.num_layers):
        lp = _layer(params["layers"], i)
        x = L.layer_norm(h, lp["ln1_s"], lp["ln1_b"], cfg.norm_eps)
        tm_out, state = _time_mix(lp["tm"], x, cfg, sx=cache["tm_x"][i],
                                  state0=cache["state"][i], stripe=stripe)
        h = h + tm_out
        x2 = L.layer_norm(h, lp["ln2_s"], lp["ln2_b"], cfg.norm_eps)
        h = h + _channel_mix(lp["cm"], x2, sx=cache["cm_x"][i])
        states.append(state)
        tm_xs.append(x[:, 0])
        cm_xs.append(x2[:, 0])
    logits = _unembed(params, h, cfg)
    return logits, L.keep_spec(
        {"state": torch.stack(states), "tm_x": torch.stack(tm_xs),
         "cm_x": torch.stack(cm_xs), "pos": cache["pos"] + 1}, cache)
