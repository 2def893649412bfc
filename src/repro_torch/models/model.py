"""Unified model API (port of ``repro.models.model``) for every family:
the transformer (``dense``, ``moe``, ``vlm``), ``rwkv6``, the ``zamba2``
hybrid and the ``encdec`` encoder-decoder.

``build_model(cfg)`` returns a :class:`Model` bundle exposing:

  defs()                               -> ParamDef tree
  init(generator, dtype, device)       -> parameter tree on the device
  apply(params, batch)                 -> (logits, aux) full-sequence forward
  loss(params, batch)                  -> (scalar loss, metrics) next-token CE
  init_cache(batch, cache_len, dtype, device) -> decode cache (zeros)
  decode(params, cache, tok)           -> (logits, new cache) one serve step

Entry points run on the card unless given ``device="cpu"``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import collectives as C
from repro_torch.models import encdec as ED
from repro_torch.models import params as P
from repro_torch.models import rwkv6 as RW
from repro_torch.models import transformer as TF
from repro_torch.models import zamba2 as ZB
from repro_torch.models.config import ModelConfig

__all__ = ["Model", "build_model", "lm_loss"]


def lm_loss(logits: torch.Tensor, targets: torch.Tensor,
            aux: Optional[torch.Tensor] = None, aux_coef: float = 0.01, *,
            vocab_axis: Optional[str] = None,
            batch_axes: Tuple[str, ...] = ()
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy (f32). targets: (B, S) int, -1 = pad.

    The JAX package's ``lm_loss``: the f32 log-softmax's negative
    log-likelihood of each target, averaged over the unmasked positions
    (at least 1); ``aux_coef * aux`` is added when ``aux`` is given.
    Returns (loss, {"ce", "tokens"} plus "aux"); nothing reads a value
    back to the host.

    Over a process mesh: with ``vocab_axis`` the logits are this rank's
    block of the vocabulary along that axis (vocab-parallel
    cross-entropy: the max, the sum of exponentials and the target's
    logit each reduced over it); with ``batch_axes`` (every batch axis of
    the mesh) the rows are this rank's, and the sum of NLL and the token
    count are summed over each axis before dividing (a mean of the ranks'
    means would weigh their rows by their pads). Rows replicated over an
    axis (a batch that does not divide it) are counted once a rank of it
    in both sums, so the loss is the global batch's mean, and the
    gradient, which the FSDP reduce-scatter and the trainer sum over the
    same axes, counts each row once.
    """
    mask = (targets >= 0).float()
    tgt = torch.clamp(targets, min=0).long()
    if vocab_axis is None:
        logp = F.log_softmax(logits.float(), dim=-1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
    else:
        lf = logits.float()
        m = C.all_reduce_max(lf.amax(dim=-1), vocab_axis)
        sumexp = C.all_reduce(torch.exp(lf - m[..., None]).sum(dim=-1),
                              vocab_axis)
        local = tgt - C.axis_index(vocab_axis) * lf.shape[-1]
        inside = (local >= 0) & (local < lf.shape[-1])
        picked = torch.gather(lf, -1, torch.where(inside, local, 0)[..., None])
        t_logit = C.all_reduce(picked[..., 0] * inside.float(), vocab_axis)
        nll = torch.log(sumexp) + m - t_logit
    total, count = (nll * mask).sum(), mask.sum()
    if batch_axes:
        count = count.clone()
        for a in batch_axes:
            total = C.all_reduce(total, a)
            count = C.all_reduce_(count, a)
    loss = total / torch.clamp(count, min=1.0)
    metrics = {"ce": loss, "tokens": count}
    if aux is not None:
        metrics["aux"] = aux
        loss = loss + aux_coef * aux
    return loss, metrics


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    defs: Callable[[], Any]
    apply: Callable[..., Tuple[torch.Tensor, torch.Tensor]]
    init_cache: Callable[..., Any]
    decode: Callable[..., Tuple[torch.Tensor, Any]]

    def init(self, generator: torch.Generator | None = None, dtype=None,
             device=None) -> Any:
        """Parameters drawn on ``device`` (the card by default) from
        ``generator`` (seeded with 0 when None), in ``dtype`` (the
        config's by default)."""
        dt = P.as_dtype(dtype or self.cfg.dtype)
        return P.materialize(self.defs(), generator, dt, device)

    def abstract_params(self, dtype=None) -> Any:
        return P.abstract(self.defs(), P.as_dtype(dtype or self.cfg.dtype))

    def loss(self, params, batch, *, scan_layers: bool = True,
             remat: bool = False):
        """``lm_loss`` of the next-token logits. Under a process mesh the
        batch rows are this rank's block of the global batch, copies of
        it over the batch axes that the batch does not divide, and logits
        narrower than the vocabulary are the rank's ``model`` block of
        it."""
        logits, aux = self.apply(params, batch, scan_layers=scan_layers,
                                 remat=remat)
        sharded = C.active() is not None
        return lm_loss(
            logits[:, :-1], batch["targets"][:, 1:], aux,
            vocab_axis=("model" if sharded
                        and logits.shape[-1] < self.cfg.vocab_size else None),
            batch_axes=C.batch_axes())

    def num_params(self) -> int:
        return P.tree_num_params(self.defs())


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in ("dense", "moe", "vlm"):
        def apply_fn(params, batch, *, scan_layers=True, remat=False):
            return TF.transformer_apply(
                params, batch["tokens"], cfg,
                extra_embeds=batch.get("patch_embeds"),
                scan_layers=scan_layers, remat=remat)
        return Model(cfg, lambda: TF.transformer_defs(cfg), apply_fn,
                     lambda b, s, dtype=None, device=None: TF.init_kv_cache(
                         cfg, b, s, dtype, device),
                     lambda p, c, t, **kw: TF.transformer_decode(
                         p, c, t, cfg, **kw))
    if fam == "rwkv6":
        def apply_fn(params, batch, *, scan_layers=True, remat=False):
            return RW.rwkv6_apply(params, batch["tokens"], cfg,
                                  scan_layers=scan_layers, remat=remat)
        return Model(cfg, lambda: RW.rwkv6_defs(cfg), apply_fn,
                     lambda b, s, dtype=None, device=None: RW.init_rwkv_cache(
                         cfg, b, s, dtype, device),
                     lambda p, c, t: RW.rwkv6_decode(p, c, t, cfg))
    if fam == "zamba2":
        def apply_fn(params, batch, *, scan_layers=True, remat=False):
            return ZB.zamba2_apply(params, batch["tokens"], cfg,
                                   scan_layers=scan_layers, remat=remat)
        return Model(cfg, lambda: ZB.zamba2_defs(cfg), apply_fn,
                     lambda b, s, dtype=None, device=None:
                     ZB.init_zamba_cache(cfg, b, s, dtype, device),
                     lambda p, c, t, **kw: ZB.zamba2_decode(
                         p, c, t, cfg, **kw))
    if fam == "encdec":
        def apply_fn(params, batch, *, scan_layers=True, remat=False):
            return ED.encdec_apply(params, batch, cfg,
                                   scan_layers=scan_layers, remat=remat)
        return Model(cfg, lambda: ED.encdec_defs(cfg), apply_fn,
                     lambda b, s, dtype=None, device=None:
                     ED.init_encdec_cache(cfg, b, s, dtype, device),
                     lambda p, c, t, **kw: ED.encdec_decode(
                         p, c, t, cfg, **kw))
    raise ValueError(f"unknown family: {fam}")
