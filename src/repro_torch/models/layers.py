"""Shared neural layers (port of ``repro.models.layers``): norms,
RoPE/M-RoPE, GQA attention, MLPs, MoE and ``dense``.

All layers are functional: ``*_defs`` returns the ParamDef tree,
``*_apply`` consumes the materialized params (projection weights in the
JAX package's (K, N) layouts). Attention is the JAX package's blockwise
online softmax: it never materializes (Sq, Sk) scores beyond one
``kv_chunk`` of keys. XLA computes attention, RoPE, the norms and MoE
dispatch in the JAX package, so plain torch ops compute them here; the
only kernel below is K3, which ``dense`` reaches for a ternary-packed
weight.

Under an active process mesh (``distributed.runtime``; training over
a mesh of ``runtime.MESH_AXES``) each rank holds blocks of the parameters
(``sharding.local_block``) and the layers place the collectives that
GSPMD places in the JAX package, at the JAX package's sites:
``unshard_fsdp`` gathers a weight's FSDP (``data``) dims at use, and the
``model`` axis is Megatron's tensor parallelism. Activations between
blocks are replicated over ``model`` (the batch rows are the rank's
block over ``pod`` and ``data``); ``dense`` is column-parallel for
``role="up"`` (behind ``copy_to``, the output this rank's columns) and
row-parallel for ``role="down"`` (followed by an ``all_reduce``), each
as the weight's
chosen layout says; attention runs on this rank's heads; the MoE
experts are parallel over ``model`` (``moe_apply``); the embedding and
the LM head are vocab-parallel (``embed_lookup``, ``head_logits``: the
rank's vocab columns) where the vocabulary divides ``model``. Off a
process mesh every collective is the identity and the layers are the
one-device ones.

A decode step under a process mesh runs in ``"serve"`` mode
(``launch.steps.make_serve_step``), as the JAX package's does: each
weight is read only as the block the rank stores (``annotate.
serve_layout``), and rows of activations, token ids, softmax statistics
and partial sums cross ranks instead (:func:`serve_einsum`, the rule of
``dense``, the attention projections, the embedding and the LM head;
K3 on the rank's output columns of a packed weight with whole-K rows).
The residual stream is the rank's rows, whole; the rows are split over
the batch axes that divide the global batch and whole on every rank of
the others (``annotate.rows_split``, from the tokens' spec). A decode
step's attention attends over the rank's part of the KV cache
(:func:`kv_stripe`: a stripe of the sequence over ``model``, ``data`` or
both -- flash-decoding, the max, the sum and the weighted values combined
over exactly those axes -- or the rank's KV heads or head-dim block), the
enc-dec's cross-attention over its part of the encoder K/V
(:func:`cross_decode`), the MoE routes the global batch's groups on every
rank (``_moe_serve``), and :func:`greedy_tokens` takes the argmax of
vocab-parallel logits.
"""
from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import resolve_device
from repro_torch.distributed import annotate as A
from repro_torch.distributed import collectives as C
from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import ParamDef

__all__ = [
    "rms_norm", "rope_freqs", "apply_rope", "mrope_positions",
    "attention_defs", "attention_apply", "attention_decode",
    "mlp_defs", "mlp_apply", "moe_defs", "moe_apply", "moe_groups",
    "moe_check_batch", "moe_route_logits", "cross_decode",
    "dense", "blockwise_attention", "layer_norm", "logits_f32", "remat",
    "layer_params", "embed_lookup", "head_logits", "serve_einsum",
    "greedy_tokens", "check_sharded_decode", "cache_rule", "state_split",
    "kv_stripe", "KVStripe", "keep_spec",
]

# ----------------------------------------------------------------------
# Basic ops
# ----------------------------------------------------------------------


def remat(fn):
    """``fn`` with its activations recomputed in the backward: the
    counterpart of ``jax.checkpoint`` (non-reentrant
    ``torch.utils.checkpoint``). Only the inputs are kept; the recompute
    runs the same ops on the same inputs, so its values, and the
    gradients, are those of ``fn`` itself bit for bit; it runs under the
    process mesh of the forward (``annotate.recompute_context``)."""
    def run(*args, **kwargs):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False,
            context_fn=A.recompute_context, **kwargs)
    return run


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    """RMSNorm as the JAX package computes it: the statistic and the
    normalisation in f32, a cast to ``x``'s dtype, then the scale in that
    dtype."""
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm as the JAX package computes it: statistics and the
    normalisation in f32, a cast to ``x``'s dtype, then the scale and bias
    in that dtype."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mu).mean(dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def serve_einsum(eq: str, x: torch.Tensor, w: Any, *, spec=None,
                 wshape=None, product=None) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` in serve mode under a process mesh, on
    the block ``w`` this rank stores and this rank's rows of ``x`` (its
    first letter). ``x``'s other dims are whole, or split over
    ``model`` (a column-parallel output, told from its size against the
    whole weight's). The rule, from the block's stored spec and the
    step's rows (``annotate.rows_split``):

      * a weight dim on an axis that ``x`` shares: ``x``'s block of it
        (a dim ``x`` holds split over ``model`` is used as it is where
        the weight splits it over ``model`` too, else gathered first);
      * a weight with a dim on ``data`` while the rows are split over
        ``data``: ``x``'s rows are gathered over ``data`` first, since
        every row needs each data rank's slice (rows whole over ``data``
        are already on every rank);
      * a contracted dim on ``data``: the partial products are
        reduce-scattered back to each rank's rows (rows whole: all-reduced
        over ``data``); on ``model``: all-reduced;
      * an output dim on ``data``: with the rows gathered, rows traded for
        columns (``all_to_all``), so each rank gets its rows whole; with
        the rows whole, the columns gathered; an output dim on ``model``
        stays split.

    No collective moves the weight. ``spec``/``wshape``: the block's
    spec and shape where ``w`` is no tagged tensor (a packed weight's
    (K, N)); ``product(x, w)``: the local product (default
    ``torch.einsum(eq, x, w)``)."""
    xs, rest = eq.split(",")
    ws, out = rest.split("->")
    spec = tuple(A.serve_layout(w) if spec is None else spec)
    wshape = tuple(w.shape if wshape is None else wshape)
    axis = dict(zip(ws, spec))
    if not set(axis.values()) <= {None, "data", "model"}:
        raise NotImplementedError(f"a weight block of spec {spec} in a "
                                  f"decode step")
    m = C.axis_size("model")
    live = "data" in spec and C.axis_size("data") > 1
    rows = live and A.rows_split("data")
    if rows:            # before any narrowing: the other ranks' blocks differ
        x = C.gather_dim(x, 0, "data")
    for d, letter in enumerate(xs[1:], 1):
        if letter not in axis:
            continue
        a = axis[letter]
        whole = wshape[ws.index(letter)] * (C.axis_size(a) if a else 1)
        if x.shape[d] != whole:
            if x.shape[d] * m != whole:
                raise ValueError(f"{eq}: x's dim {d} of {x.shape[d]} "
                                 f"against a weight dim of {whole}")
            if a == "model":
                continue
            x = C.gather_dim(x, d, "model")
        if a is not None:
            lo, hi = C.block_range(x.shape[d], a)
            x = x.narrow(d, lo, hi - lo)
    y = torch.einsum(eq, x, w) if product is None else product(x, w)
    summed = {axis[c] for c in ws if c in xs and c not in out} - {None}
    r = out.index(xs[0])
    if "data" in summed:
        y = C.scatter_dim(y, r, "data") if rows else C.all_reduce_(y, "data")
    if "model" in summed:
        y = C.all_reduce_(y, "model")
    if live and "data" not in summed:
        col = out.index(next(c for c in out if axis.get(c) == "data"))
        y = C.all_to_all(y, r, col, "data") if rows \
            else C.gather_dim(y, col, "data")
    return y


def _serve_dense(x: torch.Tensor, w: Any, gather_output: bool
                 ) -> torch.Tensor:
    """``dense`` in serve mode under a process mesh: :func:`serve_einsum`
    over the last dim; a packed weight's product is K3 on its block of
    output columns (``_quantized_pspecs``: K whole), so each output
    element is the one-device K3's for the same row."""
    lead = "abcdefgh"[:x.ndim - 1]
    eq = f"{lead}k,kn->{lead}n"
    if isinstance(w, dict) and "packed" in w:
        pk = w["packed"]
        spec = A.serve_layout(pk)
        y = serve_einsum(eq, x, pk, spec=spec,
                         wshape=(pk.shape[0] * 4, pk.shape[1]),
                         product=lambda a, b: ops.ternary_matmul(
                             a, b, w["scale"]))
    else:
        spec = A.serve_layout(w)
        y = serve_einsum(eq, x, w)
    if gather_output and spec[-1] == "model":
        y = C.gather_dim(y, -1, "model")
    return y


def dense(x: torch.Tensor, w: Any, role: str = "up", *,
          gather_output: bool = False) -> torch.Tensor:
    """``x @ w`` against a float (K, N) weight or a ternary-packed dict.

    A ``{"packed": (K//4, N) uint8, "scale": (N,)}`` weight is the CUTIE
    serving format: ``x``'s rows go through kernel K3
    (``kernels.ops.ternary_matmul``: in-kernel unpacking, an f32 sum in
    ascending k within each 512-k segment and over the segments in
    ascending order, then the scale) and comes back in ``x``'s dtype.
    A float weight is a library matmul, as the JAX package leaves it to
    XLA.

    ``role`` is the Megatron orientation under a process mesh (the JAX
    package's candidates for ``unshard_fsdp``): ``"up"`` takes a
    replicated ``x``; with N on ``model`` it is column-parallel
    (``copy_to(x) @ w``, the output this rank's columns, gathered when
    ``gather_output``), with K on ``model`` row-parallel. ``"down"``
    takes the output of an "up" over the same dim: split when its K is
    on ``model`` (``all_reduce`` of the partial product), else
    replicated. Both return a replicated output unless an "up" is
    column-parallel. In serve mode under a process mesh the product
    follows the block's stored layout (:func:`serve_einsum`; ``role``
    selects nothing there): the output is this rank's rows, split over
    ``model`` where the weight's N is (gathered when ``gather_output``).
    """
    if A.serving():
        return _serve_dense(x, w, gather_output)
    if isinstance(w, dict) and "packed" in w:
        return ops.ternary_matmul(x, w["packed"], w["scale"])
    if role == "down":
        w, lay = A.gather_at_use(w, ("model", None), (None, "model"))
    else:
        w, lay = A.gather_at_use(w, (None, "model"), ("model", None))
    if lay is None or lay == (None, None):
        return torch.matmul(x, w)
    if role != "down" and lay[1] == "model":        # column-parallel
        y = torch.matmul(C.copy_to(x, "model"), w)
        return C.gather_from(y, -1, "model") if gather_output else y
    if lay[0] == "model":                            # row-parallel
        if role != "down":
            x = C.split_to(x, -1, "model")
        return C.all_reduce(torch.matmul(x, w), "model")
    # a "down" whose N is on model: its input is replicated
    return C.gather_from(torch.matmul(C.copy_to(x, "model"), w), -1,
                         "model")


def layer_params(layers: Any, i: int) -> Any:
    """Layer ``i`` of a stacked layer tree (each leaf's leading axis),
    with each block's spec tag (``annotate.tag``) carried to the slice."""
    def one(x):
        y = x[i]
        s = A.spec_of(x)
        return y if s is None else A.tag(y, s[1:])
    if isinstance(layers, dict):
        return {k: layer_params(v, i) for k, v in layers.items()}
    return one(layers)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``. Under a process mesh the table is gathered at use
    (``unshard_fsdp(table, ("model", None))``); with its vocab rows on
    ``model`` the lookup is vocab-parallel: rows outside this rank's range
    give zeros, and an ``all_reduce`` over ``model`` adds the ranks'
    lookups (the gradient lands on the rank holding each row).

    In serve mode the table stays in its stored (vocab, embed) block: the
    token ids are gathered over ``data`` where the embed dim is split
    there and the rows are too, each rank looks up its vocab rows of its
    embed columns, the lookups are summed over ``model`` (one rank's row
    and zeros: exact) and rows are traded for columns over ``data`` (rows
    whole over ``data``: the columns gathered)."""
    if A.serving():
        return _serve_embed(table, tokens)
    table, lay = A.gather_at_use(table, ("model", None))
    idx = tokens.long()
    if lay is None or lay[0] != "model":
        return table[idx]
    lo = C.axis_index("model") * table.shape[0]
    local = idx - lo
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[torch.where(inside, local, 0)]
    rows = rows * inside[..., None].to(rows.dtype)
    return C.all_reduce(rows, "model")


def _serve_embed(table: torch.Tensor, tokens: torch.Tensor
                 ) -> torch.Tensor:
    vspec, dspec = A.serve_layout(table)
    if vspec not in (None, "model") or dspec not in (None, "data"):
        raise NotImplementedError(f"an embedding block of spec "
                                  f"{(vspec, dspec)} in a decode step")
    rows = dspec == "data" and A.rows_split("data")
    if rows:
        tokens = C.gather_dim(tokens, 0, "data")
    idx = tokens.long()
    if vspec is None:
        out = table[idx]
    else:
        local = idx - C.axis_index("model") * table.shape[0]
        inside = (local >= 0) & (local < table.shape[0])
        out = table[torch.where(inside, local, 0)]
        out = C.all_reduce_(out * inside[..., None].to(out.dtype), "model")
    if dspec == "data":
        out = C.all_to_all(out, 0, -1, "data") if rows \
            else C.gather_dim(out, -1, "data")
    return out


def greedy_tokens(logits: torch.Tensor, vocab: int) -> torch.Tensor:
    """The argmax over the last dim of ``logits``, as ``torch.argmax``
    takes it (ties to the lowest index). Logits narrower than ``vocab``
    are this rank's vocab-parallel block over ``model`` (serve mode):
    each rank's best value and index, the max of the values over
    ``model``, and the lowest global index that holds it."""
    idx = torch.argmax(logits, dim=-1)
    if logits.shape[-1] == vocab:
        return idx
    if logits.shape[-1] * C.axis_size("model") != vocab:
        raise ValueError(f"logits of {logits.shape[-1]} columns for a "
                         f"vocabulary of {vocab}")
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    best = C.all_reduce_max(val, "model")
    glob = idx + C.axis_index("model") * logits.shape[-1]
    cand = torch.where(val == best, glob, torch.full_like(glob, vocab))
    return C.all_reduce_(cand, "model", dist.ReduceOp.MIN)


def head_logits(h: torch.Tensor, w: torch.Tensor, *, tied: bool = False
                ) -> torch.Tensor:
    """The LM head: ``logits_f32(h, w)`` against a (D, V) head, or against
    the (V, D) embedding transposed when ``tied``. Under a process mesh
    the head is gathered at use with its vocab on ``model`` where that
    divides (vocab-parallel: the logits are this rank's vocab columns,
    from ``copy_to`` of ``h``), else whole (every rank all the logits,
    e.g. seamless' 256,206 rows over a model axis of 4). In serve mode
    the head stays in its stored block (:func:`serve_einsum`): the
    logits are this rank's rows, vocab-parallel where the vocab is on
    ``model``."""
    if A.serving():
        if tied:
            return serve_einsum("bsd,vd->bsv", h, w,
                                product=lambda a, b: logits_f32(a, b.t()))
        return serve_einsum("bsd,dv->bsv", h, w, product=logits_f32)
    if tied:
        w, lay = A.gather_at_use(w, ("model", None))
        w = w.t()
        split = lay is not None and lay[0] == "model"
    else:
        w, lay = A.gather_at_use(w, (None, "model"))
        split = lay is not None and lay[1] == "model"
    return logits_f32(C.copy_to(h, "model") if split else h, w)


class _MmF32(torch.autograd.Function):
    """The card's bf16 x bf16 -> f32 product, differentiable (the
    ``out_dtype`` overload has no derivative): the backward multiplies the
    f32 cotangent by the other operand in f32 and rounds to bf16, as XLA
    transposes a ``preferred_element_type=float32`` dot, and as the CPU
    path's autograd through its f32 casts does."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.mm(g, b.t().float()).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.mm(a.t().float(), g).to(b.dtype)
        return ga, gb


def logits_f32(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``h @ w`` with an f32 result, as the JAX package's
    ``preferred_element_type=float32`` product: a bf16 matmul would round
    the logits to bf16 and move greedy argmaxes. On the card, bf16
    operands go to one product with an f32 output (f32 accumulation, no
    f32 copy of the weight; under autograd through ``_MmF32``); elsewhere
    both operands are cast to f32 first. A product of two bf16 values is
    exact in f32, so both are the same sum up to its order."""
    if h.is_cuda and h.dtype == w.dtype == torch.bfloat16:
        h2 = h.reshape(-1, h.shape[-1])
        if torch.is_grad_enabled() and (h.requires_grad or w.requires_grad):
            flat = _MmF32.apply(h2, w)
        else:
            flat = torch.mm(h2, w, out_dtype=torch.float32)
        return flat.reshape(*h.shape[:-1], w.shape[-1])
    return torch.matmul(h.float(), w.float())


# ----------------------------------------------------------------------
# Rotary embeddings (RoPE + Qwen2-VL M-RoPE)
# ----------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies, shape (head_dim // 2,), f32, on ``device``
    (the card by default)."""
    dev = resolve_device(device)
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=dev) / head_dim
    return 1.0 / torch.pow(theta, exps)


def apply_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    theta: float,
    mrope_sections: Optional[Tuple[int, int, int]] = None,
) -> torch.Tensor:
    """Rotate (B, S, H, hd). ``positions``: (B, S) or (3, B, S) for M-RoPE.

    M-RoPE (Qwen2-VL): the head_dim/2 frequency slots are split into
    (t, h, w) sections; each section takes its angle from the matching
    position row. Text tokens have t == h == w, so M-RoPE degenerates to
    1-D RoPE for them. The angles, ``cos``/``sin`` and the rotation are
    f32, then cast to ``x``'s dtype.
    """
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                  # (hd/2,)
    if positions.ndim == 2:
        ang = positions[..., None].float() * inv           # (B,S,hd/2)
    else:
        if mrope_sections is None:
            raise ValueError("3-row positions require mrope_sections")
        secs = mrope_sections
        if sum(secs) != hd // 2:
            raise ValueError(f"mrope sections {secs} != head_dim/2 {hd//2}")
        ang3 = positions[..., None].float() * inv          # (3,B,S,hd/2)
        parts = []
        off = 0
        for i, s in enumerate(secs):
            parts.append(ang3[i, ..., off:off + s])
            off += s
        ang = torch.cat(parts, dim=-1)                     # (B,S,hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_positions(
    batch: int, seq: int, num_vision: int, vision_grid: Tuple[int, int],
    device=None,
) -> torch.Tensor:
    """Qwen2-VL position rows (3, B, S) int32 on ``device`` (the card by
    default): vision patches first, then text.

    Patches at sequence slots [0, num_vision) carry (t=0, h=row, w=col) of
    a (gh, gw) grid; text tokens continue with t=h=w running positions.
    """
    gh, gw = vision_grid
    idx = torch.arange(seq, dtype=torch.int32,
                       device=resolve_device(device))
    vis = idx < num_vision
    text = idx - num_vision + max(gh, gw)
    h_pos = torch.where(vis, torch.div(idx, gw, rounding_mode="floor")
                        % gh, text)
    w_pos = torch.where(vis, idx % gw, text)
    t_pos = torch.where(vis, torch.zeros_like(idx), text)
    pos = torch.stack([t_pos, h_pos, w_pos])               # (3, S)
    return pos[:, None, :].expand(3, batch, seq)


# ----------------------------------------------------------------------
# Attention (GQA, optional sliding window, blockwise online softmax)
# ----------------------------------------------------------------------


def _stacked(layers: Optional[int]):
    """A ParamDef maker with an optional leading ``layers`` axis."""
    lead = () if layers is None else (layers,)
    lax_ = () if layers is None else ("layers",)

    def pd(shape, axes, fan):
        return ParamDef(lead + shape, lax_ + axes,
                        fan_in_axes=tuple(len(lead) + a for a in fan))
    return pd


def attention_defs(cfg: ModelConfig, layers: Optional[int] = None
                   ) -> Dict[str, ParamDef]:
    """QKV/O projections, optionally stacked over a leading layer axis."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    pd = _stacked(layers)
    return {
        "wq": pd((d, h, hd), ("embed", "heads", "head_dim"), (0,)),
        "wk": pd((d, kvh, hd), ("embed", "kv_heads", "head_dim"), (0,)),
        "wv": pd((d, kvh, hd), ("embed", "kv_heads", "head_dim"), (0,)),
        "wo": pd((h, hd, d), ("heads", "head_dim", "embed"), (0, 1)),
    }


def _chunk_mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    """(Sq, Sk) validity mask from absolute positions."""
    diff = q_pos[..., :, None] - k_pos[..., None, :]
    mask = torch.ones_like(diff, dtype=torch.bool)
    if causal:
        mask &= diff >= 0
    if window is not None:
        mask &= diff < window
    return mask


def blockwise_attention(
    q: torch.Tensor,            # (B, Sq, H, hd)
    k: torch.Tensor,            # (B, Sk, KVH, hd)
    v: torch.Tensor,            # (B, Sk, KVH, hd)
    *,
    causal: bool,
    window: Optional[int] = None,
    q_offset: int | torch.Tensor = 0,
    kv_chunk: int = 2048,
) -> torch.Tensor:
    """Memory-efficient attention: a loop over KV chunks, online softmax.

    The JAX package's algorithm, chunk for chunk in the same order: f32
    scores of one (B, KVH, G, Sq, kv_chunk) block, a running max, sum and
    accumulator in f32, masked scores at -inf and their weights at 0. GQA
    folds the q-per-kv group G = H / KVH into the head axes. The JAX
    package pads the keys to whole chunks; here the last chunk is short
    instead, so a padded key never enters a sum (the JAX package's
    causal mask excludes them too; its non-causal call counts them in
    the softmax's denominator, ROADMAP section 3). Without autograd the
    mask and the exp work in place; under autograd the same ops run out
    of place, with the same values.
    """
    b, sq, h, hd = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    kv_chunk = min(kv_chunk, sk)
    qg = q.reshape(b, sq, kvh, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    q_pos = q_offset + torch.arange(sq, device=q.device)

    m = torch.full((b, kvh, g, sq), -math.inf, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, kvh, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, kvh, g, sq, hd), dtype=torch.float32,
                      device=q.device)
    for lo in range(0, sk, kv_chunk):
        hi = min(lo + kv_chunk, sk)
        k_pos = torch.arange(lo, hi, device=q.device)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg,
                         k[:, lo:hi].float()) * scale
        blocked = ~_chunk_mask(q_pos, k_pos, causal, window)  # (Sq, kc)
        if s.requires_grad:             # autograd keeps every step's input
            s = s.masked_fill(blocked, -math.inf)
        else:
            s.masked_fill_(blocked, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        if s.requires_grad:
            p = torch.exp(s - m_safe[..., None]).masked_fill(blocked, 0.0)
        else:
            p = s.sub_(m_safe[..., None]).exp_().masked_fill_(blocked, 0.0)
        corr = torch.where(torch.isneginf(m), 0.0, torch.exp(m - m_safe))
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p, v[:, lo:hi].float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, hd)
    return out.to(q.dtype)


def attention_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    positions: torch.Tensor,
    cfg: ModelConfig,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    kv_x: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    mrope: bool = False,
) -> torch.Tensor:
    """Full-sequence attention (prefill). ``kv_x`` enables cross-attention
    (no rotation then); ``kv_positions`` is accepted and unused, as in the
    JAX package.

    Under a process mesh whose ``model`` axis divides the heads, each rank
    computes its block of heads (the JAX package's ``heads_tp``): q from
    ``copy_to(x)`` and its heads' block of ``wq``; K/V the same way when
    the KV heads divide too (``kv_tp``), else from the whole ``wk``/``wv``
    on every rank, each local q head then taking its group's KV head
    (``copy_to`` carries their gradients back whole); the output
    projection is row-parallel over heads, then ``all_reduce``. When the
    heads do not divide, every rank computes every head with whole
    weights (the JAX package shards the sequence there instead)."""
    del kv_positions
    kv_src = x if kv_x is None else kv_x
    tp = A.tp_size()
    heads_tp = cfg.num_heads % tp == 0
    kv_tp = cfg.num_kv_heads % tp == 0
    wq = A.unshard_fsdp(p["wq"], (None, "model", None))
    wk = A.unshard_fsdp(p["wk"], (None, "model", None) if kv_tp
                        else (None, None, None))
    wv = A.unshard_fsdp(p["wv"], (None, "model", None) if kv_tp
                        else (None, None, None))
    part = heads_tp and tp > 1
    xq = C.copy_to(x, "model") if part else x
    q = torch.einsum("bsd,dhk->bshk", xq, wq)
    if kv_tp or not part:
        kv_in = xq if kv_x is None else (
            C.copy_to(kv_src, "model") if part else kv_src)
        k = torch.einsum("bsd,dhk->bshk", kv_in, wk)
        v = torch.einsum("bsd,dhk->bshk", kv_in, wv)
    else:
        # every rank's K/V whole; this rank's q heads' groups picked
        lo, hi = C.block_range(cfg.num_heads, "model")
        grp = torch.arange(lo, hi, device=x.device) // cfg.q_per_kv
        k, v = (C.copy_to(torch.einsum("bsd,dhk->bshk", kv_src, w),
                          "model")[:, :, grp] for w in (wk, wv))
    secs = cfg.mrope_sections if mrope else None
    if kv_x is None:  # self-attention: rotate both
        q = apply_rope(q, positions, cfg.rope_theta, secs)
        k = apply_rope(k, positions, cfg.rope_theta, secs)
    out = blockwise_attention(q, k, v, causal=causal,
                              window=window or cfg.sliding_window)
    wo = A.unshard_fsdp(p["wo"], ("model", None, None) if heads_tp
                        else (None, None, None))
    y = torch.einsum("bshk,hkd->bsd", out, wo)
    return C.all_reduce(y, "model") if part else y


def check_sharded_decode(cfg: ModelConfig, cache: Dict[str, Any]) -> None:
    """Under a process mesh, raise for a decode the port does not run
    sharded: ``NotImplementedError`` for a step outside serve mode
    (``launch.steps.make_serve_step`` sets it) and for a cache leaf whose
    spec has no serve rule (:func:`cache_rule` names the rules); a cache
    leaf without a spec raises ``ValueError``: caches reach the model as
    the blocks ``sharding.local_block`` cuts under ``cache_pspecs``."""
    if C.active() is None:
        return
    if not A.serving():
        raise NotImplementedError(
            f"{cfg.name}: a decode step under a process mesh runs in serve "
            f"mode (launch.steps.make_serve_step)")
    for name, t in cache.items():
        if name == "pos":
            continue
        spec = A.spec_of(t)
        if spec is None:
            raise ValueError(f"the cache's {name!r} without a spec under a "
                             f"process mesh: place it with sharding."
                             f"local_block under cache_pspecs")
        cache_rule(name, spec, t.ndim)


# The layouts a cache leaf may take in a sharded decode step, by the
# leaf's kind: what ``sharding.cache_pspecs`` gives, dim by dim after the
# stacked layer axis (batch, then the rest).
_KV_RULE = ("a KV cache (L, B, S, KVH, hd): the sequence over 'data', "
            "'model' or ('data', 'model'), or the KV heads or head_dim "
            "over 'model'")
_STATE_RULE = ("a recurrent state (L, B, H, x, y): the heads over 'model', "
               "x over 'data'")
_WHOLE_RULE = "a token-shift or conv cache: whole but for its rows"


def cache_rule(name: str, spec, ndim: int) -> str:
    """The serve rule of a cache leaf ``name`` of ``ndim`` dims under
    ``spec`` (its stacked layer dim first, then the batch dim over the
    batch axes or None); raises ``NotImplementedError`` naming the rule
    the spec breaks."""
    spec = tuple(spec) + (None,) * (ndim - len(spec))
    rest = spec[2:]
    if name in ("k", "v", "ck", "cv", "attn_k", "attn_v"):
        rule = _KV_RULE
        ok = (rest[0] in (None, "data", "model", ("data", "model"))
              and rest[1] in (None, "model") and rest[2] in (None, "model")
              and sum("model" in _axes(e) for e in rest) <= 1)
    elif name in ("state", "ssm"):
        rule = _STATE_RULE
        ok = rest[0] in (None, "model") and rest[1] in (None, "data") \
            and rest[2] is None
    else:
        rule = _WHOLE_RULE
        ok = all(e is None for e in rest)
    if spec[0] is not None or not ok:
        raise NotImplementedError(
            f"a cache spec {spec} for {name!r} has no serve rule; the "
            f"sharded decode takes {rule}")
    return rule


def state_split(name: str, state: torch.Tensor) -> bool:
    """Whether the stacked recurrent state ``name`` (L, B, H, x, y), in
    serve mode under a process mesh, holds this rank's stripe of x over a
    ``data`` axis of more than one rank: its spec (``cache_pspecs`` at a
    global batch the batch axes do not divide) puts x there."""
    if not A.serving():
        return False
    spec = A.spec_of(state)
    cache_rule(name, spec, state.ndim)
    return spec[3] == "data" and C.axis_size("data") > 1


def keep_spec(new: Dict[str, Any], old: Dict[str, Any]) -> Dict[str, Any]:
    """``new`` (a decode step's new cache) with each leaf tagged with the
    spec of ``old``'s leaf of that name, where it has one: the next
    step reads the blocks' layout from the tags."""
    for name, t in new.items():
        spec = A.spec_of(old[name]) if name in old else None
        if spec is not None:
            A.tag(t, spec)
    return new


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class KVStripe(NamedTuple):
    """This rank's part of a KV cache in serve mode under a process mesh
    (:func:`kv_stripe`): slots ``[lo, lo + S_r)`` of the sequence's
    ``length`` slots, the mesh axes the sequence is split over (major
    first, axes of one rank left out), and whether the KV heads or the
    head dim are split over ``model``."""
    lo: int
    length: int
    seq_axes: Tuple[str, ...]
    heads: bool
    head_dim: bool


def kv_stripe(k_cache: torch.Tensor) -> Optional[KVStripe]:
    """The :class:`KVStripe` of a stacked (L, B, S, KVH, hd) KV cache block
    in serve mode under a process mesh, from its spec (``cache_pspecs``):
    the sequence over ``model`` (flash-decoding), over ``data`` or over
    ``("data", "model")`` (context parallelism: a global batch the batch
    axes do not divide), or a sequence that ``model`` does not divide
    with the KV heads or the head dim over ``model``. None outside serve
    mode. Any other spec raises ``NotImplementedError``
    (:func:`cache_rule`)."""
    if not A.serving():
        return None
    spec = A.spec_of(k_cache)
    cache_rule("k", spec, k_cache.ndim)
    n = k_cache.shape[2]
    block, parts, axes = 0, 1, []
    for a in _axes(spec[2]):
        block = block * C.axis_size(a) + C.axis_index(a)
        parts *= C.axis_size(a)
        if C.axis_size(a) > 1:
            axes.append(a)
    live = C.axis_size("model") > 1
    return KVStripe(block * n, n * parts, tuple(axes),
                    spec[3] == "model" and live, spec[4] == "model" and live)


def _heads_to(t: torch.Tensor, heads: int, split: bool) -> torch.Tensor:
    """A projection's output (B, 1, heads or this rank's block, ...) with
    all its heads (gathered over ``model``) or, when ``split``, this
    rank's block of them."""
    if split:
        if t.shape[2] == heads:
            lo, hi = C.block_range(heads, "model")
            t = t[:, :, lo:hi]
        return t
    return t if t.shape[2] == heads else C.gather_dim(t, 2, "model")


def _hd_to(t: torch.Tensor, head_dim: int, split: bool) -> torch.Tensor:
    """``t`` (B, 1, H, head_dim or this rank's block) with the whole head
    dim (gathered over ``model``) or, when ``split``, this rank's
    block."""
    if split:
        if t.shape[3] == head_dim:
            lo, hi = C.block_range(head_dim, "model")
            t = t[..., lo:hi]
        return t
    return t if t.shape[3] == head_dim else C.gather_dim(t, 3, "model")


def _serve_qkv(p, x, cfg: ModelConfig, st: KVStripe, names, posb, secs):
    """The serve rule's q (and k, v) of ``x`` in the layout of a cache of
    stripe ``st``: each projection on its stored block, then every head
    or, with the KV heads over ``model``, this rank's heads (its q heads
    are those of its KV heads' groups); rotated on the whole head dim
    (``posb`` None: no rotation), then cut to this rank's block of the
    head dim where the cache splits it."""
    out = []
    for name in names:
        n = cfg.num_heads if name == "wq" else cfg.num_kv_heads
        t = _heads_to(serve_einsum("bsd,dhk->bshk", x, p[name]), n, st.heads)
        if name == "wv":
            out.append(_hd_to(t, cfg.head_dim, st.head_dim))
            continue
        t = _hd_to(t, cfg.head_dim, False)
        if posb is not None:
            t = apply_rope(t, posb, cfg.rope_theta, secs)
        out.append(_hd_to(t, cfg.head_dim, st.head_dim))
    return out


def _attend_decode_serve(p, x, k_cache, v_cache, pos, cfg: ModelConfig, *,
                         window: Optional[int], mrope: bool,
                         stripe: KVStripe) -> torch.Tensor:
    """``_attend_decode`` on this rank's rows and its part of the cache
    (``kv_stripe``: slots ``[lo, lo + S_r)`` of the sequence's ``S``, its
    KV heads or head-dim block): q, k and v from the projections' serve
    rule in the cache's layout (:func:`_serve_qkv`); only the owner of the
    token's slot writes it (a select, so nothing waits for the device;
    the ring's slot too); scores at global key positions
    (:func:`_stripe_attend`); the output projection on the stored block of
    ``wo``."""
    b = x.shape[0]
    secs = cfg.mrope_sections if mrope else None
    posb = pos.reshape(1, 1).expand(b, 1)
    if mrope:
        posb = posb[None].expand(3, b, 1)
    q, k, v = _serve_qkv(p, x, cfg, stripe, ("wq", "wk", "wv"), posb, secs)

    lo, s_all = stripe.lo, stripe.length
    s_loc = k_cache.shape[1]
    slot = pos % s_all if window is not None \
        else torch.clamp(pos, max=s_all - 1)
    local = slot.reshape(1).long() - lo
    mine = (local >= 0) & (local < s_loc)
    at = torch.clamp(local, 0, s_loc - 1)
    for cache, new in ((k_cache, k), (v_cache, v)):
        keep = cache.index_select(1, at)
        cache.index_copy_(1, at, torch.where(mine, new.to(cache.dtype),
                                             keep))

    k_idx = lo + torch.arange(s_loc, device=x.device)
    valid = k_idx <= pos
    if window is not None:
        valid = valid | (pos >= s_all)
    out = _stripe_attend(q, k_cache, v_cache, valid, stripe, cfg.head_dim)
    return serve_einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])


def _stripe_attend(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, valid: Optional[torch.Tensor],
                   stripe: KVStripe, head_dim: int) -> torch.Tensor:
    """One query's attention (B, 1, H_r, hd_r) over this rank's part of
    the keys (B, S_r, KVH_r, hd_r), flash-decoding over the sequence's
    axes (``stripe.seq_axes``): f32 scores (with the head dim over
    ``model``, the partial dot products all-reduced over ``model`` first),
    masked to -inf where ``valid`` is False, the softmax's max over the
    sequence's axes, then the weighted values and the sum, combined in one
    sum over each of them. Returns the f32 output (B, 1, H_r, hd): the
    rank's q heads, the values' head-dim blocks gathered over ``model``.
    At least one key of the whole sequence must be valid (slot 0 is, in a
    decode step), so the max over the ranks is finite."""
    b, _, h, hd = q.shape
    kvh = k_cache.shape[2]
    qg = q.reshape(b, 1, kvh, h // kvh, hd).float()
    sc = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float())
    if stripe.head_dim:
        sc = C.all_reduce_(sc, "model")
    sc = sc * (1.0 / math.sqrt(head_dim))
    if valid is not None:
        sc = sc.masked_fill(~valid, -math.inf)
    top = sc.amax(dim=-1)
    for a in stripe.seq_axes:
        top = C.all_reduce_max(top, a)
    w_att = torch.exp(sc - top[..., None])
    acc = torch.einsum("bkgqs,bskd->bkgqd", w_att, v_cache.float())
    both = torch.cat([acc.flatten(), w_att.sum(dim=-1).flatten()])
    for a in stripe.seq_axes:
        both = C.all_reduce_(both, a)
    acc = both[:acc.numel()].view(acc.shape)
    tot = both[acc.numel():].view(acc.shape[:-1])
    out = (acc / tot[..., None]).permute(0, 3, 1, 2, 4).reshape(
        b, 1, h, hd)
    return C.gather_dim(out, 3, "model") if stripe.head_dim else out


def cross_decode(p: Dict[str, Any], x: torch.Tensor, ck: torch.Tensor,
                 cv: torch.Tensor, cfg: ModelConfig,
                 stripe: Optional[KVStripe] = None) -> torch.Tensor:
    """One decode step's cross-attention of ``x`` (B, 1, D) over the
    precomputed encoder keys and values ``ck``/``cv`` (B, S_enc, KVH, hd):
    non-causal, nothing written, the output projected by ``wo``. In serve
    mode under a process mesh ``ck``/``cv`` are this rank's part of the
    encoder K/V (``cache_pspecs``' KV layout) and ``stripe`` its
    :func:`kv_stripe`: q from the projection's serve rule in that layout,
    attention over the rank's part combined over the sequence's axes
    (:func:`_stripe_attend`), ``wo`` on its stored block."""
    if A.serving():
        if stripe is None:
            raise NotImplementedError("a cross-attention under a process "
                                      "mesh without its K/V's stripe")
        q, = _serve_qkv(p, x, cfg, stripe, ("wq",), None, None)
        out = _stripe_attend(q, ck, cv, None, stripe, cfg.head_dim)
        return serve_einsum("bshk,hkd->bsd", out.to(x.dtype), p["wo"])
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    out = blockwise_attention(q, ck, cv, causal=False)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _attend_decode(p, x, k_cache, v_cache, pos, cfg: ModelConfig, *,
                   window: Optional[int], mrope: bool,
                   stripe: Optional[KVStripe] = None
                   ) -> torch.Tensor:
    """One token's attention at position ``pos`` (a 0-d int tensor on the
    device): writes this token's k and v into ``k_cache``/``v_cache``
    (B, S, KVH, hd) in place with an indexed copy, then attends over the
    valid slots. No value goes to the host, so a step never waits for
    the device. In serve mode under a process mesh ``stripe`` is the
    cache block's (``kv_stripe``) and the step is
    ``_attend_decode_serve``'s."""
    if A.serving():
        if stripe is None:
            raise NotImplementedError("a decode attention under a process "
                                      "mesh without its cache's stripe")
        return _attend_decode_serve(p, x, k_cache, v_cache, pos, cfg,
                                    window=window, mrope=mrope,
                                    stripe=stripe)
    b = x.shape[0]
    secs = cfg.mrope_sections if mrope else None
    posb = pos.reshape(1, 1).expand(b, 1)
    if mrope:
        posb = posb[None].expand(3, b, 1)
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = apply_rope(q, posb, cfg.rope_theta, secs)
    k = apply_rope(k, posb, cfg.rope_theta, secs)

    s_cache = k_cache.shape[1]
    # SWA: rolling ring-buffer slot; full attention: append at pos.
    slot = pos % s_cache if window is not None \
        else torch.clamp(pos, max=s_cache - 1)
    slot = slot.reshape(1).long()
    k_cache.index_copy_(1, slot, k.to(k_cache.dtype))
    v_cache.index_copy_(1, slot, v.to(v_cache.dtype))

    kvh, hd, h = cfg.num_kv_heads, cfg.head_dim, cfg.num_heads
    g = h // kvh
    qg = q.reshape(b, 1, kvh, g, hd).float()
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache.float()) * scale
    k_idx = torch.arange(s_cache, device=x.device)
    valid = k_idx <= pos
    if window is not None:
        # Rolling cache: every resident entry is within the window once
        # pos >= s_cache; before that, unwritten slots are masked.
        valid = valid | (pos >= s_cache)
    s = s.masked_fill(~valid, -math.inf)
    w_att = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bkgqd", w_att, v_cache.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, 1, h, hd).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def attention_decode(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                  # (B, 1, D)
    cache: Dict[str, torch.Tensor],   # {"k","v": (B, S, KVH, hd), "pos": ()}
    cfg: ModelConfig,
    *,
    window: Optional[int] = None,
    mrope: bool = False,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Single-token decode with a (rolling, for SWA) KV cache update.
    Returns (output, new cache); the cache passed in is not modified."""
    k_cache, v_cache = cache["k"].clone(), cache["v"].clone()
    y = _attend_decode(p, x, k_cache, v_cache, cache["pos"], cfg,
                       window=window, mrope=mrope)
    return y, {"k": k_cache, "v": v_cache, "pos": cache["pos"] + 1}


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------


def mlp_defs(cfg: ModelConfig, layers: Optional[int] = None,
             d_ff: Optional[int] = None) -> Dict[str, ParamDef]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    pd = _stacked(layers)
    out = {"w_up": pd((d, f), ("embed", "mlp"), (0,)),
           "w_down": pd((f, d), ("mlp", "embed"), (0,))}
    if cfg.activation == "swiglu":
        out["w_gate"] = pd((d, f), ("embed", "mlp"), (0,))
    return out


def mlp_apply(p: Dict[str, Any], x: torch.Tensor,
              cfg: ModelConfig) -> torch.Tensor:
    """swiglu, squared_relu or gelu; ``jax.nn.gelu`` is the tanh
    approximation by default, so the gelu here is too."""
    if cfg.activation == "swiglu":
        h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    elif cfg.activation == "squared_relu":
        h = torch.square(torch.relu(dense(x, p["w_up"])))
    else:
        h = F.gelu(dense(x, p["w_up"]), approximate="tanh")
    return dense(h, p["w_down"], role="down")


# ----------------------------------------------------------------------
# MoE (shared + routed experts, group-wise einsum dispatch, GShard-style
# capacity with token dropping)
# ----------------------------------------------------------------------


def moe_defs(cfg: ModelConfig, layers: Optional[int] = None
             ) -> Dict[str, Any]:
    d = cfg.d_model
    ef = cfg.expert_d_ff or cfg.d_ff
    e = cfg.num_experts
    pd = _stacked(layers)
    defs: Dict[str, Any] = {
        "router": pd((d, e), ("embed", "experts"), (0,)),
        "we_gate": pd((e, d, ef), ("experts", "embed", "mlp"), (1,)),
        "we_up": pd((e, d, ef), ("experts", "embed", "mlp"), (1,)),
        "we_down": pd((e, ef, d), ("experts", "mlp", "embed"), (1,)),
    }
    if cfg.num_shared_experts:
        sf = ef * cfg.num_shared_experts
        defs["shared"] = {
            "w_gate": pd((d, sf), ("embed", "mlp"), (0,)),
            "w_up": pd((d, sf), ("embed", "mlp"), (0,)),
            "w_down": pd((sf, d), ("mlp", "embed"), (0,)),
        }
    return defs


def _one_hot(idx: torch.Tensor, n: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot``: ``idx[..., None] == arange(n)`` in ``dtype``
    (an index outside [0, n) gives a row of zeros)."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).to(dtype)


def moe_route(router: torch.Tensor, xg: torch.Tensor, cfg: ModelConfig,
              cap: int, *, expert_axis: Optional[str] = None
              ) -> Dict[str, torch.Tensor]:
    """The router of ``moe_apply`` on grouped tokens ``xg`` (NG, G, D).

    Returns the f32 ``probs`` (NG, G, E), the chosen experts ``gate_idx``
    (NG, G, k), their renormalized and capacity-masked ``gate_vals``, the
    f32 slot ``pos`` of each (token, choice) in its expert's buffer and
    ``keep = pos < cap``. Top-k is a stable descending sort over the
    experts, then the first k, so equal probabilities go to the lower
    expert index, as ``jax.lax.top_k`` breaks ties. A slot is the
    exclusive cumsum over (G*k) in token-major, then choice, order.

    ``expert_axis``: ``router`` holds this rank's block of the experts'
    columns over that mesh axis; the rank's logits are gathered over it
    (``gather_from``: the backward keeps the rank's block), so every rank
    of the axis routes from the same bits.
    """
    logits = torch.einsum("ngd,de->nge", xg, router).float()
    if expert_axis is not None:
        logits = C.gather_from(logits, -1, expert_axis)
    return moe_route_logits(logits, cfg, cap)


def moe_route_logits(logits: torch.Tensor, cfg: ModelConfig, cap: int
                     ) -> Dict[str, torch.Tensor]:
    """:func:`moe_route` from the f32 router logits (NG, G, E)."""
    e, k = cfg.num_experts, cfg.top_k
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, gate_idx = top.values[..., :k], top.indices[..., :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    onehot = _one_hot(gate_idx, e, torch.float32)            # (ng,g,k,e)
    ng, g = logits.shape[:2]
    flat = onehot.reshape(ng, g * k, e)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(ng, g, k, e)
    pos = torch.sum(pos * onehot, dim=-1)                    # (ng, g, k)
    keep = pos < cap
    return dict(probs=probs, gate_idx=gate_idx, onehot=onehot, pos=pos,
                keep=keep, gate_vals=gate_vals * keep)


def moe_groups(b: int, s: int, cfg: ModelConfig) -> Tuple[int, int, int]:
    """``(g, ng, cap)``: the group size, the number of groups and the
    expert capacity of ``moe_apply`` over ``b`` rows of ``s`` tokens, as
    the JAX package groups them (``g = min(moe_group_size, b * s)``);
    tokens that do not fill whole groups raise ``ValueError``. Under a
    process mesh the rows are the rank's: ``moe_check_batch`` holds them
    to the global batch's groups."""
    n = b * s
    g = min(cfg.moe_group_size, n)
    if n % g:
        raise ValueError(f"MoE groups: {b} x {s} = {n} tokens do not fill "
                         f"whole groups of {g} tokens")
    cap = min(int(math.ceil(g * cfg.top_k * cfg.capacity_factor
                            / cfg.num_experts)), g)
    return g, n // g, cap


def moe_check_batch(b: int, s: int, b_all: int, cfg: ModelConfig) -> None:
    """Raise ``ValueError`` unless a rank's ``b`` rows of ``s`` tokens, its
    share of a global batch of ``b_all`` rows, group as the JAX package
    groups the global batch: the rank's group size must be the global
    one and its tokens must fill whole groups. Anything else would drop
    another set of tokens. ``Trainer.local_batch`` checks each batch."""
    n = b * s
    g_all = min(cfg.moe_group_size, b_all * s)
    if min(cfg.moe_group_size, n) != g_all or n % g_all:
        raise ValueError(
            f"MoE groups: a rank holds {b} x {s} = {n} tokens of a "
            f"{b_all} x {s} global batch, grouped in {g_all} tokens "
            f"(moe_group_size {cfg.moe_group_size}); a rank's tokens must "
            f"fill whole groups of that size")


def moe_apply(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux load-balance loss). The one-hot dispatch and
    combine tensors are in ``x``'s dtype, as in the JAX package; the aux
    loss counts each token's top-1 choice.

    Under a process mesh the experts are parallel over ``model`` (the
    specs put ``experts`` there): the router's and the expert weights'
    ``data`` dims are gathered at use (the JAX package's ``unshard_fsdp``
    sites), each rank computes the logits of its experts and gathers them
    (``moe_route``), so softmax, top-k and the capacity cumsum run on the
    whole (NG, G, E) on every rank; ``xg`` enters through ``copy_to``,
    the dispatch and combine tensors are cut to the rank's experts
    (``split_to``: the combine's gradient, and through it the router's,
    is whole on every rank), and the rank's partial combine is summed
    over ``model``. The aux loss's statistics are means over the global
    groups: averaged over every batch axis (``pod``, ``data``:
    ``all_reduce``, whose backward is the identity, for ``me``;
    ``ce_frac`` has no gradient), so the loss counts it once, rows
    replicated over an axis included (each rank's mean is then the
    same). The shared experts are ``dense``'s TP. Off a process
    mesh every collective is the identity. Experts that do not divide
    ``model`` (the specs then put the experts' ``mlp`` dim there) raise
    ``NotImplementedError``. In serve mode the rule is
    :func:`_moe_serve`'s."""
    if A.serving():
        return _moe_serve(p, x, cfg)
    b, s, d = x.shape
    e = cfg.num_experts
    g, ng, cap = moe_groups(b, s, cfg)
    xg = x.reshape(ng, g, d)
    router, lay = A.gather_at_use(p["router"], (None, "model"))
    ep = lay is not None and lay[1] == "model"
    if not ep and A.tp_size() > 1:
        raise NotImplementedError(
            f"{cfg.name}: {e} experts over a model axis of {A.tp_size()}: "
            f"the fallback layout (each expert's mlp dim on 'model') is "
            f"not trained")
    axis = "model" if ep else None
    xin = C.copy_to(xg, "model") if ep else xg
    r = moe_route(router, xin, cfg, cap, expert_axis=axis)

    # Switch-style load-balance aux loss, over the global groups.
    me = r["probs"].mean(dim=(0, 1))
    ce_frac = _one_hot(r["gate_idx"][..., 0], e,
                       torch.float32).mean(dim=(0, 1))
    for a in C.batch_axes():
        if C.axis_size(a) > 1:
            me = C.all_reduce(me, a) / C.axis_size(a)
            ce_frac = C.all_reduce_(ce_frac, a) / C.axis_size(a)
    aux = e * torch.sum(me * ce_frac)

    disp, comb = _dispatch_combine(r, cap, x.dtype)
    if ep:                                   # this rank's experts
        disp = C.split_to(disp, 2, "model")
        comb = C.split_to(comb, 2, "model")
    xe = torch.einsum("ngd,ngec->necd", xin, disp)           # (ng,e,cap,d)

    we_gate, we_up, we_down = (A.unshard_fsdp(p[k], ("model", None, None))
                               for k in ("we_gate", "we_up", "we_down"))
    hg = F.silu(torch.einsum("necd,edf->necf", xe, we_gate))
    hu = torch.einsum("necd,edf->necf", xe, we_up)
    ye = torch.einsum("necf,efd->necd", hg * hu, we_down)

    y = torch.einsum("ngec,necd->ngd", comb, ye)
    out = (C.all_reduce(y, "model") if ep else y).reshape(b, s, d)
    if cfg.num_shared_experts:
        out = out + _shared_experts(p["shared"], x)
    return out, aux


def _dispatch_combine(r: Dict[str, torch.Tensor], cap: int,
                      dtype: torch.dtype
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (NG, G, E, cap) one-hot dispatch of a routing ``r``
    (:func:`moe_route_logits`) and the combine, its gate-weighted
    inverse, in ``dtype``."""
    pos_oh = _one_hot(r["pos"], cap, dtype) * r["keep"][..., None].to(dtype)
    onehot = r["onehot"]
    disp = torch.einsum("ngke,ngkc->ngec", onehot.to(dtype), pos_oh)
    comb = torch.einsum("ngke,ngkc->ngec",
                        (onehot * r["gate_vals"][..., None]).to(dtype),
                        pos_oh)
    return disp, comb


def _shared_experts(sh: Dict[str, Any], x: torch.Tensor) -> torch.Tensor:
    """The MoE's shared experts, a SwiGLU MLP by ``dense``'s rules."""
    hs = F.silu(dense(x, sh["w_gate"])) * dense(x, sh["w_up"])
    return dense(hs, sh["w_down"], role="down")


def _moe_serve(p: Dict[str, Any], x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``moe_apply`` in serve mode under a process mesh, on this rank's
    rows ``x`` (B_r, S, D) and the blocks it stores: the router (D over
    ``data``, experts over ``model``), each expert's weights (experts
    over ``model``, D over ``data``, F whole) and the shared experts
    (``dense``'s serve rule, K3 when packed).

    The JAX package groups the tokens of the global batch, so a rank that
    routed its own rows alone would form other groups, another capacity
    and other drops. So every row of the global batch reaches every rank
    first, once: rows split over ``data`` are traded for columns
    (``all_to_all``: every row of the data axis, this rank's block of D,
    the block its weights hold; rows whole over ``data`` are on every rank
    already, and the rank takes its D block of them) and rows split over
    ``pod`` gathered (the weights are whole there). A row whole over an
    axis is never gathered over it: its copies would enter the group as
    tokens of their own (at B=1 over ``data`` of 2, a group of 2 tokens,
    whose second copy of each choice is dropped at capacity 1). Then each
    rank:

      * the router logits of its experts from its D block, f32 partial
        sums all-reduced over ``data`` and rounded to ``x``'s dtype (the
        one-device product's rounding), gathered over ``model``: every
        rank routes the whole (NG, G, E) from the same bits
        (:func:`moe_route_logits`);
      * its experts' dispatch and combine, their gate and up products on
        its D block, the partial sums all-reduced over ``data`` (both in
        one call). This is the way back of a sum over ``data`` here: at
        decode a group holds B tokens and the capacity is ~B k / E slots
        (1 for deepseek-moe-16b at B=8), so the slots cannot be split
        over ``data``; the all-reduce moves 2 E_r cap F values, less
        than the rows themselves;
      * the down product onto its D block, the combine over its experts,
        summed over ``model`` (all-reduce), its pod's rows cut out and
        columns traded back for rows over ``data`` (``all_to_all``; rows
        whole over ``data``: the D blocks gathered).

    No weight crosses ranks. The aux loss is the one-device loss of the
    global groups (decode discards it). Experts that do not divide
    ``model`` raise ``NotImplementedError``."""
    b, s, d = x.shape
    e = cfg.num_experts
    d_on, e_on = A.serve_layout(p["router"])
    if e_on != "model" and C.axis_size("model") > 1:
        raise NotImplementedError(
            f"{cfg.name}: {e} experts over a model axis of "
            f"{C.axis_size('model')}: the fallback layout (each expert's mlp "
            f"dim on 'model') has no serve rule")
    cols = d_on == "data" and C.axis_size("data") > 1
    rows_d, rows_p = A.rows_split("data"), A.rows_split("pod")
    if cols:
        xa = C.all_to_all(x, -1, 0, "data") if rows_d else x.narrow(
            -1, *_span(d, "data"))
    else:
        xa = C.gather_dim(x, 0, "data") if rows_d else x
    if rows_p:
        xa = C.gather_dim(xa, 0, "pod")
    na = xa.shape[0]
    g, ng, cap = moe_groups(na, s, cfg)
    xg = xa.reshape(ng, g, -1)
    part = torch.einsum("ngd,de->nge", xg.float(), p["router"].float())
    if cols:
        part = C.all_reduce_(part, "data")
    logits = C.gather_dim(part.to(x.dtype), -1, "model").float()
    r = moe_route_logits(logits, cfg, cap)
    me = r["probs"].mean(dim=(0, 1))
    ce_frac = _one_hot(r["gate_idx"][..., 0], e,
                       torch.float32).mean(dim=(0, 1))
    aux = e * torch.sum(me * ce_frac)

    lo, hi = C.block_range(e, "model")
    disp, comb = (t[:, :, lo:hi] for t in _dispatch_combine(r, cap, x.dtype))
    xe = torch.einsum("ngd,ngec->necd", xg, disp)        # (ng,e_r,cap,d_r)
    gu = torch.stack([torch.einsum("necd,edf->necf", xe, p[k])
                      for k in ("we_gate", "we_up")])
    if cols:
        gu = C.all_reduce_(gu, "data")
    ye = torch.einsum("necf,efd->necd", F.silu(gu[0]) * gu[1], p["we_down"])
    y = C.all_reduce_(torch.einsum("ngec,necd->ngd", comb, ye), "model")
    y = y.reshape(na, s, -1)
    if rows_p:
        y = y.narrow(0, *_span(na, "pod"))
    if cols:
        y = C.all_to_all(y, 0, -1, "data") if rows_d \
            else C.gather_dim(y, -1, "data")
    elif rows_d:
        y = y.narrow(0, *_span(y.shape[0], "data"))
    if cfg.num_shared_experts:
        y = y + _shared_experts(p["shared"], x)
    return y, aux


def _span(size: int, axis: str) -> Tuple[int, int]:
    """``(start, length)`` of this rank's block of a dim of ``size`` over
    ``axis``."""
    lo, hi = C.block_range(size, axis)
    return lo, hi - lo
