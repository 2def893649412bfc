"""AdamW with fp32 moments over (possibly bf16) parameter trees.

Port of ``repro.training.optimizer``. A tree is a nested dict or list of
tensors; the moments carry the parameters' exact structure. The step
counter is an int32 tensor on the parameters' device, and the learning
rate, the clipping scale and the bias corrections stay tensors, so a
step queues its work without synchronizing the host (no ``.item()``, no
``float()``; ``min``/``max`` are ``torch.clamp``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch

from repro_torch.distributed import collectives as C

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (dicts and lists/tuples nest),
    with the matching leaves of the trees in ``rest``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in the JAX package's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def cosine_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio * lr``; ``step``
    a tensor (or an int), the result a float32 tensor beside it."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * frac


def global_norm(tree: Any, specs: Any = None) -> torch.Tensor:
    """The L2 norm of every leaf together. With ``specs`` (the spec of
    each leaf, as ``sharding.param_pspecs`` gives it) under an active
    process mesh the leaves are this rank's blocks: a rank adds a leaf's
    squares only where its index is 0 on every axis the leaf is
    replicated over, so each block counts once, and the sums are added
    over the mesh's axes."""
    pm = C.active()
    if specs is None or pm is None:
        return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                              for x in tree_leaves(tree)))
    total = torch.zeros((), dtype=torch.float32, device=pm.device)
    for x, s in zip(tree_leaves(tree), spec_leaves(specs)):
        held = {a for e in s if e is not None
                for a in ((e,) if isinstance(e, str) else e)}
        if all(pm.coord(a) == 0 for a in pm.axis_names if a not in held):
            total = total + torch.sum(torch.square(x.float()))
    for a in pm.axis_names:
        C.all_reduce_(total, a)
    return torch.sqrt(total)


def spec_leaves(specs: Any) -> List[Any]:
    """A spec tree's specs (tuples), in ``tree_leaves``' order."""
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [x for v in specs for x in spec_leaves(v)]
    return [specs]


def clip_by_global_norm(tree: Any, max_norm: float, specs: Any = None
                        ) -> Tuple[Any, torch.Tensor]:
    gn = global_norm(tree, specs)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda x: (x.float() * scale).to(x.dtype), tree), gn


def adamw_init(params: Any) -> Dict[str, Any]:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }


def adamw_update(
    grads: Any,
    opt_state: Dict[str, Any],
    params: Any,
    cfg: AdamWConfig,
    specs: Any = None,
) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns (new_params, new_state, metrics); nothing
    is updated in place. ``specs``: the params' spec tree when the trees
    are blocks over a process mesh (for the clipping norm)."""
    step = opt_state["step"] + 1
    lr = cosine_schedule(cfg, step)
    grads, gn = clip_by_global_norm(grads, cfg.grad_clip, specs)

    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - torch.pow(b1, step.float())
    bc2 = 1 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        gf = g.float()
        m_new = b1 * m + (1 - b1) * gf
        v_new = b2 * v + (1 - b2) * gf * gf
        mhat = m_new / bc1
        vhat = v_new / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    pick = lambda i: tree_map(lambda p, o: o[i], params, out)
    metrics = {"grad_norm": gn, "lr": lr}
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, metrics
