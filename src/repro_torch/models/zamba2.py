"""Zamba2 hybrid backbone: Mamba-2 (SSD) layers + a weight-shared attention
block invoked every ``attn_every`` layers (port of ``repro.models.zamba2``;
arXiv:2411.15242).

Mamba-2 layers use the chunked SSD form for a full sequence (scalar
per-head decay, so the intra-chunk factorization is exact, with no
clamping) and the O(1) stepwise recurrence for decode. The shared
attention block is a pre-norm attention + MLP pair, weight-tied across its
invocations, built from ``layers.attention_apply``/``_attend_decode`` and
``layers.mlp_apply``.

The JAX package computes the SSD scan, the depthwise conv and the gates
with XLA, so plain torch ops compute them here; the only kernel is K3,
which ``layers.dense`` reaches for a ternary-packed ``in_proj``,
``out_proj`` or shared-MLP weight. Layers run as a Python loop over the
stacked layer axis (``scan_layers`` selects nothing; ``remat``
recomputes each Mamba layer in the backward, ``layers.remat``).
A decode step keeps ``pos`` a 0-d device tensor and never reads a value
back to the host.

Under a process mesh (training over a mesh of ``runtime.MESH_AXES``)
each ``model`` rank runs the SSD on its block of ``ssm_heads / |model|``
heads and holds only their state (``_heads_in``): ``in_proj``, ``conv_w``
and ``conv_b`` are gathered whole at use (their stored blocks do not
line up with the ``z | x | B | C | dt`` split points; the all-gather's
backward sums the ranks' parts of the gradient), the rank takes its
heads' columns of ``z``, ``x`` and ``dt`` and all of the shared ``B``
and ``C`` behind ``copy_to`` of the input, ``a_log``/``dt_bias``/
``d_skip`` are its stored blocks, ``norm_s``'s statistic is reduced over
``model`` (``_rms_norm_heads``) and ``out_proj`` is row-parallel. The
shared block is the dense family's TP, the embedding and the head
vocab-parallel (``layers.embed_lookup``, ``layers.head_logits``). A
decode step there runs in serve mode, where no weight is gathered:
``_mamba_decode_serve`` moves activations instead.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.distributed import annotate as A
from repro_torch.distributed import collectives as C
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef, as_dtype

__all__ = ["zamba2_defs", "zamba2_apply", "zamba2_decode",
           "init_zamba_cache", "mamba2_chunked"]


def _mamba_defs(cfg: ModelConfig, nl: int) -> Dict[str, Any]:
    d = cfg.d_model
    din = cfg.ssm_d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    k = cfg.conv_kernel
    conv_dim = din + 2 * n

    def pd(shape, axes, **kw):
        return ParamDef((nl,) + shape, ("layers",) + axes, **kw)

    return {
        "ln": pd((d,), ("norm",), init="ones"),
        "in_proj": pd((d, 2 * din + 2 * n + h), ("embed", "mlp"),
                      fan_in_axes=(1,)),
        "conv_w": pd((k, conv_dim), (None, "conv"), scale=1.0,
                     fan_in_axes=(0,)),
        "conv_b": pd((conv_dim,), ("conv",), init="zeros"),
        "a_log": pd((h,), ("heads",), init="constant", constant=0.0),
        "dt_bias": pd((h,), ("heads",), init="zeros"),
        "d_skip": pd((h,), ("heads",), init="ones"),
        "norm_s": pd((din,), ("norm",), init="ones"),
        "out_proj": pd((din, d), ("mlp", "embed"), fan_in_axes=(0,)),
    }


def zamba2_defs(cfg: ModelConfig) -> Dict[str, Any]:
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": ParamDef((v, d), ("vocab", "embed"), fan_in_axes=(1,)),
        "layers": _mamba_defs(cfg, cfg.num_layers),
        # ONE shared attention block, weight-tied across invocations.
        "shared": {
            "ln1": ParamDef((d,), ("norm",), init="ones"),
            "ln2": ParamDef((d,), ("norm",), init="ones"),
            "attn": L.attention_defs(cfg),
            "mlp": L.mlp_defs(cfg),
        },
        "ln_f": ParamDef((d,), ("norm",), init="ones"),
        "lm_head": ParamDef((d, v), ("embed", "vocab"), fan_in_axes=(0,)),
    }


# ----------------------------------------------------------------------
# Mamba-2 SSD core
# ----------------------------------------------------------------------


def mamba2_chunked(
    x: torch.Tensor,        # (B, S, H, P) inputs (post conv/silu)
    dt: torch.Tensor,       # (B, S, H) softplus'd step sizes
    a: torch.Tensor,        # (H,) negative decay rates (-exp(a_log))
    b_in: torch.Tensor,     # (B, S, N) input projections (ngroups=1)
    c_in: torch.Tensor,     # (B, S, N)
    state0: Optional[torch.Tensor] = None,
    chunk: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan. Returns (y (B,S,H,P) in ``x``'s dtype, state
    (B,H,P,N) f32). f32 inside.

    h_t = exp(a*dt_t) h_{t-1} + dt_t x_t B_t^T ;  y_t = h_t C_t (the skip
    term is the caller's). The JAX package's chunk body: within a chunk,
    ``cum`` is the cumsum of ``a*dt`` and ``y = att @ (dt x) + exp(cum) *
    (C . state)`` with ``att = tril(exp(cum_t - cum_s)) * (C_t . B_s)``;
    the state leaving a chunk is ``exp(cum_end) * state + sum_s
    exp(cum_end - cum_s) dt_s x_s B_s^T``. Every term that does not read
    the carried state is computed for all chunks at once; the loop over
    chunks carries the state alone. All decay exponents used are <= 0.
    ``S`` must be a multiple of the chunk (no padding, as in the
    reference).
    """
    bsz, s, h, p = x.shape
    n = b_in.shape[-1]
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"seq {s} % chunk {c} != 0")
    nc = s // c
    xc = x.reshape(bsz, nc, c, h, p).float()
    dtc = dt.reshape(bsz, nc, c, h).float()
    bc = b_in.reshape(bsz, nc, c, n).float()
    cc = c_in.reshape(bsz, nc, c, n).float()
    state = (torch.zeros((bsz, h, p, n), dtype=torch.float32,
                         device=x.device)
             if state0 is None else state0.float())

    cum = torch.cumsum(a.float() * dtc, dim=2)             # (b, nc, c, h)
    # intra-chunk: att[t, s] = exp(cum_t - cum_s) (C_t . B_s), s <= t
    scores = torch.einsum("bitn,bisn->bits", cc, bc)
    ldiff = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (b,nc,t,s,h)
    mask = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    # exp of the masked exponents (-inf above the diagonal), not a mask of
    # exp: the same values, but the exponents above the diagonal are
    # positive and overflow to inf at long chunks and fast decays, and
    # where(mask, inf, 0)'s gradient is 0 * inf = NaN (as the JAX
    # package's is; ROADMAP section 3).
    att = torch.exp(torch.where(mask[:, :, None], ldiff, -torch.inf)) \
        * scores[..., None]
    dtx = xc * dtc[..., None]                              # (b,nc,c,h,p)
    y = torch.einsum("bitsh,bishp->bithp", att, dtx)
    # each chunk's own contribution to the state it leaves
    cum_end = cum[:, :, -1]                                # (b, nc, h)
    k_tail = torch.exp(cum_end[:, :, None] - cum)          # (b, nc, c, h)
    own = torch.einsum("bichp,bicn->bihpn", dtx * k_tail[..., None], bc)
    decay = torch.exp(cum_end)[..., None, None]            # (b,nc,h,1,1)
    entering = []
    for i in range(nc):
        entering.append(state)
        state = decay[:, i] * state + own[:, i]
    # cross-chunk: y += exp(cum_t) * C_t . (state entering the chunk)
    y_cross = torch.einsum("bitn,bihpn->bithp", cc,
                           torch.stack(entering, dim=1))
    y = y + y_cross * torch.exp(cum)[..., None]
    return y.reshape(bsz, s, h, p).to(x.dtype), state


def _mamba_step(x, dt, a, b_in, c_in, state):
    """One-token SSD update. x (B,H,P); dt (B,H); b/c (B,N); state
    (B,H,P,N) f32. Returns (y (B,H,P) in ``x``'s dtype, new state)."""
    dtf = dt.float()
    dec = torch.exp(a.float()[None] * dtf)                 # (B, H)
    dbx = (x.float() * dtf[..., None])[..., None] \
        * b_in.float()[:, None, None, :]
    state = dec[..., None, None] * state + dbx
    y = torch.einsum("bhpn,bn->bhp", state, c_in.float())
    return y.to(x.dtype), state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` at every x (``F.softplus``
    returns x itself above its threshold)."""
    return torch.logaddexp(x, x.new_zeros(()))


def _heads_in(lp, x, cfg: ModelConfig):
    """Under a process mesh: this ``model`` rank's ``in_proj`` product
    (its heads' columns of ``z``, ``x`` and ``dt`` and the shared ``B``
    and ``C``, from ``copy_to(x)``) and its channels of ``conv_w`` and
    ``conv_b`` (its heads' ``x`` channels, then ``B`` and ``C``), each
    weight gathered whole first (``annotate.gather_whole``), and its
    number of heads."""
    din, n, h, p = (cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads,
                    cfg.ssm_head_dim)
    lo, hi = C.block_range(h, "model")
    xs = (lo * p, hi * p)
    cols = [xs, (din + xs[0], din + xs[1]), (2 * din, 2 * din + 2 * n),
            (2 * din + 2 * n + lo, 2 * din + 2 * n + hi)]
    chans = [xs, (din, din + 2 * n)]

    def pick(w, spans):
        return torch.cat([w[..., a:b] for a, b in spans], dim=-1)
    w_in = pick(A.gather_whole(lp["in_proj"]), cols)
    proj = torch.matmul(C.copy_to(x, "model"), w_in)
    return (proj, pick(A.gather_whole(lp["conv_w"]), chans),
            pick(A.gather_whole(lp["conv_b"]), chans), hi - lo)


def _rms_norm_heads(y, scale, eps: float, width: int):
    """``layers.rms_norm`` of a row whose ``width`` entries lie in blocks
    over ``model``, on this rank's block ``y``: the f32 sum of squares
    all-reduced over ``model`` (and, since every rank's block reads the
    statistic, its gradient summed back over ``model``, ``copy_to``), the
    rank's slice of the replicated ``scale`` (``split_to``: its gradient
    gathered whole)."""
    yf = y.float()
    ss = C.copy_to(C.all_reduce((yf * yf).sum(dim=-1, keepdim=True),
                                "model"), "model")
    return ((yf * torch.rsqrt(ss / width + eps)).to(y.dtype)
            * C.split_to(scale, 0, "model"))


def _mamba_forward(lp, x, cfg: ModelConfig, *, conv_state=None,
                   ssm_state=None, decode: bool = False,
                   p_split: bool = False):
    """Apply one Mamba-2 layer (pre-norm; the caller adds the residual).

    Returns (out, (conv_state, ssm_state)): the last ``conv_kernel - 1``
    conv inputs (B, k-1, conv_dim) and the SSM state (B, H, P, N) f32;
    under a process mesh, this rank's heads' (H / |model| of them).
    """
    bsz, s, d = x.shape
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    p = cfg.ssm_head_dim
    k = cfg.conv_kernel
    sharded = C.active() is not None
    if sharded:
        if decode:
            return _mamba_decode_serve(lp, x, cfg, conv_state, ssm_state,
                                       p_split)
        proj, conv_w, conv_b, h = _heads_in(lp, x, cfg)
    else:
        proj = L.dense(x, lp["in_proj"])
        conv_w, conv_b, h = lp["conv_w"], lp["conv_b"], cfg.ssm_heads
    di = h * p
    z, xbc, dt_raw = torch.split(proj, [di, di + 2 * n,
                                        proj.shape[-1] - 2 * di - 2 * n],
                                 dim=-1)

    # Depthwise causal conv over the (x, B, C) channels.
    if decode:
        window = torch.cat([conv_state, xbc], dim=1)       # (B, k, cd)
        conv_out = (window * conv_w).sum(dim=1, keepdim=True)
        new_conv_state = window[:, 1:]
    else:
        # The reference's shifted multiply-add, tap by tap in this order
        # (a library conv would choose its own reduction order).
        pad = F.pad(xbc, (0, 0, k - 1, 0))
        conv_out = sum(pad[:, i:i + s] * conv_w[i] for i in range(k))
        new_conv_state = pad[:, -(k - 1):]
    xbc = F.silu(conv_out + conv_b)
    xs, b_in, c_in = torch.split(xbc, [di, n, n], dim=-1)
    xs = xs.reshape(bsz, -1, h, p)
    dt = _softplus(dt_raw.float() + lp["dt_bias"].float())
    a = -torch.exp(lp["a_log"].float())

    if decode:
        y, ssm_state = _mamba_step(xs[:, 0], dt[:, 0], a, b_in[:, 0],
                                   c_in[:, 0], ssm_state)
        y = y[:, None]
    else:
        y, ssm_state = mamba2_chunked(xs, dt, a, b_in, c_in, ssm_state,
                                      chunk=min(cfg.chunk_size * 2, s))
    y = y + xs * lp["d_skip"][:, None]
    y = y.reshape(bsz, -1, di)
    if sharded:
        y = _rms_norm_heads(y * F.silu(z), lp["norm_s"], cfg.norm_eps, din)
    else:
        y = L.rms_norm(y * F.silu(z), lp["norm_s"], cfg.norm_eps)
    out = L.dense(y, lp["out_proj"], role="down")
    return out, (new_conv_state, ssm_state)


def _mamba_decode_serve(lp, x, cfg: ModelConfig, conv_state, ssm_state,
                        p_split: bool = False):
    """One Mamba-2 layer's decode step in serve mode under a process mesh
    (``_mamba_forward(decode=True)`` there), on this rank's rows ``x``
    (B_r, 1, D), its blocks of the weights and of the cache.

    ``in_proj``'s output columns (``z | x | B | C | dt``) are split over
    ``model`` in blocks that do not line up with the SSD heads, and
    ``conv_w``/``conv_b``'s channels in blocks that do not either, so
    activations move instead of weights: the product on the stored block
    (``dense``'s serve rule, K3 on the rank's columns when packed)
    gathered over ``model`` into every column; the new conv state from
    the whole ``x | B | C`` (the cache keeps the whole conv dim on every
    ``model`` rank, so each writes the same bits); the conv on the stored
    channels, gathered over ``model``; then each rank takes its heads'
    ``z``, ``x`` and ``dt`` and the shared ``B`` and ``C``, steps the SSM
    state of its heads (the cache's block) with its blocks of ``a_log``,
    ``dt_bias`` and ``d_skip``, normalizes with the statistic summed over
    ``model`` (``_rms_norm_heads``) and ends in ``out_proj``'s serve rule
    (row-parallel on its heads). Where the global batch does not divide
    the batch axes (rows whole on every rank of them) the state's head
    dim P may be split over ``data`` (``p_split``, from the cache's spec):
    each rank steps its P rows of its heads
    and the y rows are gathered over ``data`` before ``d_skip``, the gate
    and the norm; the conv state, whole over ``data`` and ``model``, gets
    the same bits on every rank. Heads or conv channels that ``model``
    does not divide raise ``NotImplementedError``, as in training.
    Returns (out, (conv_state, ssm_state))."""
    din, n, p = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_head_dim
    h = cfg.ssm_heads
    if (A.serve_layout(lp["a_log"])[0],
            A.serve_layout(lp["conv_b"])[0]) != ("model", "model"):
        raise NotImplementedError(
            f"{cfg.name}: {h} SSM heads or {din + 2 * n} conv channels over "
            f"a model axis of {C.axis_size('model')}")
    proj = L.dense(x, lp["in_proj"], gather_output=True)
    z, xbc, dt_raw = torch.split(proj, [din, din + 2 * n, h], dim=-1)
    window = torch.cat([conv_state, xbc], dim=1)           # (B, k, cd)
    lo, hi = C.block_range(din + 2 * n, "model")
    conv = C.gather_dim(F.silu((window[..., lo:hi] * lp["conv_w"]).sum(
        dim=1, keepdim=True) + lp["conv_b"]), -1, "model")
    lo, hi = C.block_range(h, "model")
    xs = conv[..., lo * p:hi * p].reshape(x.shape[0], 1, hi - lo, p)
    b_in, c_in = conv[..., din:din + n], conv[..., din + n:]
    dt = _softplus(dt_raw[..., lo:hi].float() + lp["dt_bias"].float())
    a = -torch.exp(lp["a_log"].float())
    p_loc = ssm_state.shape[2]
    if p_split:                         # P over data: this rank's rows
        if p_loc * C.axis_size("data") != p:
            raise ValueError(f"an SSM state block of {p_loc} of {p} rows "
                             f"over a data axis of {C.axis_size('data')}")
        lo_p = C.axis_index("data") * p_loc
        y, ssm_state = _mamba_step(xs[:, 0, :, lo_p:lo_p + p_loc], dt[:, 0],
                                   a, b_in[:, 0], c_in[:, 0], ssm_state)
        y = C.gather_dim(y, 2, "data")
    else:
        y, ssm_state = _mamba_step(xs[:, 0], dt[:, 0], a, b_in[:, 0],
                                   c_in[:, 0], ssm_state)
    y = (y[:, None] + xs * lp["d_skip"][:, None]).reshape(
        x.shape[0], 1, -1) * F.silu(z[..., lo * p:hi * p])
    y = _rms_norm_heads(y, lp["norm_s"], cfg.norm_eps, din)
    return L.dense(y, lp["out_proj"], role="down"), (window[:, 1:],
                                                     ssm_state)


def _mamba_layer(h, lp, cfg: ModelConfig):
    out, _ = _mamba_forward(lp, L.rms_norm(h, lp["ln"], cfg.norm_eps), cfg)
    return h + out


def _shared_block(sp, h, positions, cfg, *, window=None):
    a_in = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
    h = h + L.attention_apply(sp["attn"], a_in, positions, cfg,
                              causal=True, window=window)
    m_in = L.rms_norm(h, sp["ln2"], cfg.norm_eps)
    return h + L.mlp_apply(sp["mlp"], m_in, cfg)


def _stage_bounds(cfg: ModelConfig):
    """Mamba-layer index ranges between shared-attn invocations."""
    period = cfg.attn_every or cfg.num_layers
    bounds = []
    i = 0
    while i < cfg.num_layers:
        j = min(i + period, cfg.num_layers)
        bounds.append((i, j))
        i = j
    return bounds


def _embed(params, tokens, cfg: ModelConfig):
    return L.embed_lookup(params["embed"], tokens).to(as_dtype(cfg.dtype))


def _unembed(params, h, cfg: ModelConfig):
    return L.head_logits(L.rms_norm(h, params["ln_f"], cfg.norm_eps),
                         params["lm_head"])


def zamba2_apply(params: Dict[str, Any], tokens: torch.Tensor,
                 cfg: ModelConfig, *, scan_layers: bool = True,
                 remat: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. Returns (logits (B,S,V) f32, 0.0): each
    stage of Mamba layers, then the shared block, over every stage.
    ``remat`` recomputes each Mamba layer in the backward (where the JAX
    package applies ``jax.checkpoint``); the shared block keeps its
    activations, as there."""
    del scan_layers
    mamba = L.remat(_mamba_layer) if remat else _mamba_layer
    b, s = tokens.shape
    h = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=h.device)[None].expand(b, s)
    for i, j in _stage_bounds(cfg):
        for li in range(i, j):
            h = mamba(h, L.layer_params(params["layers"], li), cfg)
        h = _shared_block(params["shared"], h, positions, cfg)
    return (_unembed(params, h, cfg),
            torch.zeros((), dtype=torch.float32, device=h.device))


def init_zamba_cache(cfg: ModelConfig, batch: int, cache_len: int,
                     dtype=None, device=None) -> Dict[str, torch.Tensor]:
    """Mamba conv + SSM states per layer, plus one KV cache per shared-attn
    invocation, on ``device`` (the card by default). At long context the
    shared block runs with a sliding window (``long_context_window``),
    bounding the KV caches: a cache clamped to the window is a ring."""
    dt = as_dtype(dtype or cfg.dtype)
    dev = resolve_device(device)
    nl = cfg.num_layers
    din, n = cfg.ssm_d_inner, cfg.ssm_state
    h, p, k = cfg.ssm_heads, cfg.ssm_head_dim, cfg.conv_kernel
    n_inv = len(_stage_bounds(cfg))
    if cfg.long_context_window is not None:
        cache_len = min(cache_len, cfg.long_context_window)
    kv = (n_inv, batch, cache_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "conv": torch.zeros((nl, batch, k - 1, din + 2 * n), dtype=dt,
                            device=dev),
        "ssm": torch.zeros((nl, batch, h, p, n), dtype=torch.float32,
                           device=dev),
        "attn_k": torch.zeros(kv, dtype=dt, device=dev),
        "attn_v": torch.zeros(kv, dtype=dt, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def zamba2_decode(params: Dict[str, Any], cache: Dict[str, torch.Tensor],
                  tokens: torch.Tensor, cfg: ModelConfig,
                  *, scan_layers: bool = True
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. Returns (logits f32, new cache); the cache passed
    in is not modified. The shared block attends over a ring exactly when
    the cache was clamped to ``long_context_window`` at init. Over a
    process mesh (serve mode) each Mamba layer is
    ``_mamba_decode_serve``'s, the shared block attends over the rank's
    stripe of its KV cache (a ring too), and the result is this rank's
    rows of the logits and its block of the new cache."""
    del scan_layers
    L.check_sharded_decode(cfg, cache)
    h = _embed(params, tokens, cfg)
    pos = cache["pos"]
    stripe = L.kv_stripe(cache["attn_k"])
    ck_len = cache["attn_k"].shape[2] if stripe is None else stripe.length
    ring = (cfg.long_context_window is not None
            and ck_len == cfg.long_context_window)
    window = ck_len if ring else None
    k_new, v_new = cache["attn_k"].clone(), cache["attn_v"].clone()
    conv_new, ssm_new = [], []
    p_split = L.state_split("ssm", cache["ssm"])
    sp = params["shared"]
    for si, (i, j) in enumerate(_stage_bounds(cfg)):
        for li in range(i, j):
            lp = L.layer_params(params["layers"], li)
            out, (conv_st, ssm_st) = _mamba_forward(
                lp, L.rms_norm(h, lp["ln"], cfg.norm_eps), cfg,
                conv_state=cache["conv"][li], ssm_state=cache["ssm"][li],
                decode=True, p_split=p_split)
            h = h + out
            conv_new.append(conv_st)
            ssm_new.append(ssm_st)
        a_in = L.rms_norm(h, sp["ln1"], cfg.norm_eps)
        h = h + L._attend_decode(sp["attn"], a_in, k_new[si], v_new[si],
                                 pos, cfg, window=window, mrope=False,
                                 stripe=stripe)
        m_in = L.rms_norm(h, sp["ln2"], cfg.norm_eps)
        h = h + L.mlp_apply(sp["mlp"], m_in, cfg)
    return _unembed(params, h, cfg), L.keep_spec({
        "conv": torch.stack(conv_new), "ssm": torch.stack(ssm_new),
        "attn_k": k_new, "attn_v": v_new, "pos": pos + 1}, cache)
