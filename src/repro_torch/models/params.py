"""Parameter definitions: one declaration yields the parameters and their
shapes (port of ``repro.models.params``).

Every model declares its parameters as a nested dict of :class:`ParamDef`
(shape + logical axis names + init law). From that declaration:

  * ``materialize(defs, generator, dtype, device)`` -> the parameter tree,
    drawn on ``device`` from an explicit ``torch.Generator``;
  * ``abstract(defs, dtype)`` -> the same tree of meta tensors (shapes and
    dtypes, no storage);
  * ``tree_num_params`` -> the parameter count.

The logical axis names are the JAX package's; the sharding rules
(``distributed.sharding.param_pspecs``, in place of the JAX package's
``to_pspecs``) map them onto a mesh's axes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch import resolve_device

__all__ = ["ParamDef", "materialize", "abstract", "tree_num_params",
           "tree_map", "as_dtype"]


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + init law."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    # init: 'normal' (std = scale / sqrt(fan_in_axis_size)), 'zeros',
    # 'ones', 'constant'
    init: str = "normal"
    scale: float = 1.0
    fan_in_axes: Tuple[int, ...] = ()   # axes whose product is fan-in
    constant: float = 0.0

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``, as
    ``ModelConfig.dtype`` spells it)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` on every non-dict leaf of a nested dict, same nesting."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def materialize(defs: Any, generator: Optional[torch.Generator] = None,
                dtype: torch.dtype = torch.float32, device=None) -> Any:
    """Instantiate a ParamDef tree on ``device`` (the card by default).

    The init laws are the JAX package's: ``normal`` draws N(0, 1) in
    ``dtype`` and multiplies by ``scale / sqrt(fan_in)`` in ``dtype``;
    ``zeros``, ``ones`` and ``constant`` fill. The leaves draw from
    ``generator`` one after another (a generator on ``device`` seeded
    with 0 when none is given); the values differ from JAX's, whose keys
    are split per leaf.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)

    def make(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dtype, device=dev)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dtype, device=dev)
        if d.init == "constant":
            return torch.full(d.shape, d.constant, dtype=dtype, device=dev)
        fan_axes = d.fan_in_axes or tuple(range(len(d.shape) - 1))
        fan_in = max(math.prod(d.shape[a] for a in fan_axes), 1)
        std = torch.tensor(d.scale / math.sqrt(fan_in), dtype=dtype)
        x = torch.randn(d.shape, generator=generator, dtype=dtype,
                        device=dev)
        return x.mul_(std.item())

    return tree_map(make, defs)


def abstract(defs: Any, dtype: torch.dtype = torch.float32) -> Any:
    """Meta tensors of the defs' shapes in ``dtype`` (no storage)."""
    return tree_map(
        lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), defs)


def tree_num_params(defs_or_params: Any) -> int:
    """Total parameter count of a ParamDef or tensor tree."""
    if isinstance(defs_or_params, dict):
        return sum(tree_num_params(v) for v in defs_or_params.values())
    return math.prod(defs_or_params.shape)
