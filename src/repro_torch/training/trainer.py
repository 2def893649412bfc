"""Fault-tolerant LM training loop (port of ``repro.training.trainer``).

  * step-atomic checkpoint/restart -- params + optimizer + error-feedback
    state + data cursor are saved every ``ckpt_every`` steps;
    ``run_with_restarts`` resumes from the newest intact checkpoint
    (corrupt ones are skipped).
  * simulated node failure -- ``failure_hook`` raises mid-run; the outer
    ``run_with_restarts`` loop restores and continues. Every step runs
    inside ``deterministic(all_ops=True)``, so the restarted run repeats
    the uninterrupted one bit for bit, on the card too.
  * straggler tracking -- per-step wall times; steps slower than
    ``straggler_factor`` x the median of the last 50 are counted.
  * optional gradient compression (``training.compression``).

The step is eager: ``Model.loss`` under autograd, ``compress_grads`` when
configured, then ``adamw_update``. Parameters stay in the model's dtype
(bf16 for every full config) with f32 moments. Training runs on one
device: ``shardings`` is refused (FSDP/TP over a mesh needs collectives,
the part of ROADMAP item 11 still to port).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.convert import lm_params_from_numpy
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.compression import compress_grads, compression_init
from repro_torch.training.determinism import deterministic
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, tree_map)

__all__ = ["TrainerConfig", "Trainer", "loss_and_grads"]


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    keep_last: int = 3
    log_every: int = 10
    remat: bool = False
    grad_compression_ratio: Optional[float] = None  # e.g. 0.05
    straggler_factor: float = 3.0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def loss_and_grads(model: Model, params: Any, batch: Dict[str, Any],
                   **loss_kw) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """``(loss, metrics, grads)`` of ``model.loss(params, batch,
    **loss_kw)``: ``jax.value_and_grad``'s counterpart. The loss and
    metrics are detached; ``grads`` is shaped like ``params``, zeros for a
    leaf the loss does not read."""
    flat: List[torch.Tensor] = []

    def live(p):
        flat.append(p.detach().requires_grad_())
        return flat[-1]

    loss, metrics = model.loss(tree_map(live, params), batch, **loss_kw)
    got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grads = tree_map(lambda p: _or_zeros(next(got), p), params)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _or_zeros(g, p):
    return torch.zeros_like(p) if g is None else g


def _on(device: torch.device, tree: Any) -> Any:
    """A state tree on ``device``: tensors moved, numpy arrays (e.g. a JAX
    state through ``np.asarray``; bfloat16 bits included) converted."""
    def leaf(x):
        if not isinstance(x, torch.Tensor):
            x = lm_params_from_numpy(np.asarray(x))
        return x.to(device)
    return tree_map(leaf, tree)


class Trainer:
    """Drives ``model`` over a cursor-addressable batch function, on
    ``device`` (the card by default)."""

    def __init__(self, model: Model, cfg: TrainerConfig,
                 batch_fn: Callable[[int], Dict[str, torch.Tensor]],
                 *, shardings: Any = None, device=None):
        if shardings is not None:
            raise NotImplementedError(
                "shardings: the port trains on one device; training over "
                "a mesh waits for ROADMAP item 11")
        self.model = model
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.shardings = None
        self.device = resolve_device(device)
        self.step_times: List[float] = []
        self.straggler_steps = 0

    # -- step ------------------------------------------------------------
    def _step_fn(self, params, opt_state, err_state, batch):
        cfg = self.cfg
        with deterministic(all_ops=True):
            loss, metrics, grads = loss_and_grads(self.model, params, batch,
                                                  remat=cfg.remat)
            cmetrics = {}
            if cfg.grad_compression_ratio is not None:
                grads, err_state, cmetrics = compress_grads(
                    grads, err_state, ratio=cfg.grad_compression_ratio)
            params, opt_state, om = adamw_update(grads, opt_state, params,
                                                 cfg.opt)
        return params, opt_state, err_state, {
            "loss": loss, **metrics, **om, **cmetrics}

    # -- state lifecycle ---------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """Fresh params (``Model.init``), AdamW state and error-feedback
        buffers. ``generator`` is read, not advanced (a copy of its state
        draws), so every call with it gives the same params, as a JAX key
        does; None draws from a generator seeded with 0."""
        g = torch.Generator(device=self.device)
        if generator is None:
            g.manual_seed(0)
        else:
            g.set_state(generator.get_state())
        params = self.model.init(g, device=self.device)
        return {
            "params": params,
            "opt": adamw_init(params),
            "err": (compression_init(params)
                    if self.cfg.grad_compression_ratio is not None
                    else torch.zeros((), device=self.device)),
        }

    def restore(self, template: Dict[str, Any]):
        return CKPT.restore_latest(self.cfg.ckpt_dir, template)

    # -- main loop ---------------------------------------------------------
    def run(self, generator: Optional[torch.Generator] = None, *,
            start_state=None, start_step=0,
            failure_hook: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        """Train from ``start_state`` (e.g. a JAX package state through
        ``np.asarray``: its leaves come across bit for bit) or a fresh
        ``init_state(generator)``, from ``start_step`` to
        ``total_steps``."""
        cfg = self.cfg
        state = (_on(self.device, start_state) if start_state is not None
                 else self.init_state(generator))
        history = []
        step = start_step
        while step < cfg.total_steps:
            if failure_hook is not None:
                failure_hook(step)          # may raise (simulated crash)
            batch = self.batch_fn(step)
            t0 = time.perf_counter()
            p, o, e, metrics = self._step_fn(
                state["params"], state["opt"], state["err"], batch)
            metrics = {k: v.cpu().numpy() for k, v in metrics.items()}
            dt = time.perf_counter() - t0
            state = {"params": p, "opt": o, "err": e}
            self._track_stragglers(dt)
            step += 1
            history.append({"step": step, "loss": float(metrics["loss"]),
                            "time_s": dt})
            if step % cfg.log_every == 0:
                print(f"  step {step:5d} loss {metrics['loss']:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if step % cfg.ckpt_every == 0 or step == cfg.total_steps:
                CKPT.save_checkpoint(
                    cfg.ckpt_dir, step, state,
                    extra={"data_cursor": step,
                           "straggler_steps": self.straggler_steps},
                    keep_last=cfg.keep_last)
        return {"state": state, "history": history, "final_step": step}

    def run_with_restarts(self, generator: Optional[torch.Generator] = None,
                          *, failure_hook=None, max_restarts: int = 5):
        """Crash-resilient outer loop: restore-and-continue on failure."""
        attempts = 0
        start_state, start_step = None, 0
        while True:
            try:
                return self.run(generator, start_state=start_state,
                                start_step=start_step,
                                failure_hook=failure_hook)
            except RuntimeError as e:
                attempts += 1
                if attempts > max_restarts:
                    raise
                err = str(e)
            # Outside the except block, so the failed run's frames (and
            # its state on the card) are freed before a fresh one is made.
            start_state = None
            fresh = self.init_state(generator)   # structure template
            restored = self.restore(fresh)
            if restored is None:
                start_state, start_step = fresh, 0
            else:
                start_step, start_state, _ = restored
            del fresh
            print(f"[trainer] restart #{attempts} from step "
                  f"{start_step} after: {err}", flush=True)

    # -- straggler tracking --------------------------------------------------
    def _track_stragglers(self, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 5:
            med = float(np.median(self.step_times[-50:]))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps += 1
