"""One STBP training step of the SCNN.

``core.snn.snn_loss`` under autograd (the unrolled LIF dynamics with
their surrogate gradient, Wu et al. 2018), then AdamW, with cuDNN held to
deterministic algorithms so that a run restarted from a checkpoint
repeats the uninterrupted run's bits. ``examples/torch_train_dvs_gesture.py``,
``chip_smoke.py`` and the tests all train through :func:`stbp_step`.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.snn import SNNConfig, snn_loss
from repro_torch.training.determinism import deterministic as _det
from repro_torch.training.optimizer import AdamWConfig, adamw_update

__all__ = ["snn_grads", "stbp_step"]

Params = Dict[str, Dict[str, torch.Tensor]]


def _nothing(i: int) -> None:
    pass


def _grads(params, vox, labels, cfg, mode, mark):
    names = list(params)
    live = {k: {"w": params[k]["w"].detach().requires_grad_()}
            for k in names}
    loss, aux = snn_loss(live, vox, labels, cfg, mode=mode)
    mark(1)
    grads = torch.autograd.grad(loss, [live[k]["w"] for k in names])
    mark(2)
    return loss.detach(), aux, {k: {"w": g} for k, g in zip(names, grads)}


def snn_grads(params: Params, vox: torch.Tensor, labels: torch.Tensor,
              cfg: SNNConfig, *, mode: str = "time_serial"
              ) -> Tuple[torch.Tensor, Dict[str, Any], Params]:
    """``(loss, aux, grads)`` of ``snn_loss`` at ``params``: the loss
    detached, ``aux`` as ``snn_loss`` gives it, ``grads`` shaped like
    ``params`` (``{layer: {"w": dloss/dw}}``)."""
    return _grads(params, vox, labels, cfg, mode, _nothing)


def stbp_step(params: Params, opt: Dict[str, Any], vox: torch.Tensor,
              labels: torch.Tensor, cfg: SNNConfig, ocfg: AdamWConfig, *,
              mode: str = "time_serial", deterministic: bool = True,
              mark: Optional[Callable[[int], None]] = None
              ) -> Tuple[Params, Dict[str, Any], torch.Tensor,
                         Dict[str, Any]]:
    """One step: gradients of ``snn_loss``, then ``adamw_update``.

    Returns ``(params, opt, loss, aux)``; nothing is updated in place and
    nothing synchronizes the host. ``deterministic=False`` leaves cuDNN's
    algorithm choice alone (to measure what determinism costs); a restart
    then drifts from the uninterrupted run. ``mark(i)``, when given, is
    called before the forward (0), after it (1), after the backward (2)
    and after the optimizer (3), e.g. to record CUDA events.
    """
    mark = mark or _nothing
    with _det() if deterministic else contextlib.nullcontext():
        mark(0)
        loss, aux, grads = _grads(params, vox, labels, cfg, mode, mark)
        params, opt, _ = adamw_update(grads, opt, params, ocfg)
        mark(3)
    return params, opt, loss, aux
