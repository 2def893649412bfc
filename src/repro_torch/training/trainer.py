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
(bf16 for every full config) with f32 moments.

``shardings`` (a :class:`~repro_torch.distributed.NamedSharding` tree over
a :class:`~repro_torch.distributed.runtime.ProcessMesh`, as
``shardings(pmesh, {"params": param_pspecs(...), "opt": opt_pspecs(...),
"err": ...})`` gives it) trains over a ``("pod", "data", "model")``,
``("data", "model")`` or ``("data",)`` mesh (``runtime.MESH_AXES``), one
process a rank, as the JAX package's ``Trainer(shardings=...)`` does
under GSPMD: each rank keeps its block of params, AdamW moments and
error-feedback state (``sharding.local_block``; ``pod`` holds copies:
pure data parallelism), its block of the batch rows (``batch_pspecs``:
over the prefix of ``(pod, data)`` that divides the batch, copies over
the rest), and runs the step under the process mesh, where the model
gathers FSDP dims at use and is tensor-parallel over ``model``
(``models.layers``). Gradients of leaves replicated over ``data`` are
summed over it, then every gradient over ``pod`` (``reduce_grads``);
the loss, the MoE aux statistics and the metrics are the global
batch's, each row counted once. ``init_state``,
``run(start_state=...)`` and ``restore`` each give a rank its block, so a
restart may run on another mesh ("elastic scaling"): rank 0 writes whole
arrays (``sharding.gather_logical``), the files the one-device trainer
writes for the same state. Only rank 0 prints and writes. Every family
trains: ``dense``, ``vlm``, ``moe`` (experts over ``model``), ``rwkv6``,
``zamba2`` (SSD heads over ``model``) and ``encdec``; meshes over other
axes, and heads or experts that the model axis would split, are refused
by name. ``failure_hook`` runs on
every rank, so a simulated failure (:class:`SimulatedFailure`) raises on
all of them at the same step, and ``run_with_restarts`` waits for every
rank and restores on all of them from the same checkpoint. Over a process
mesh it restarts on nothing else: any other error, a collective's
included, ends that rank, and a rank that ends or dies makes the others'
next collective fail (the process group's timeout), so the run exits
non-zero -- restarting is relaunching, and the elastic restore covers it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.utils._pytree as pytree

from repro_torch import resolve_device
from repro_torch.convert import lm_params_from_numpy
from repro_torch.distributed import annotate as A
from repro_torch.distributed import collectives as C
from repro_torch.distributed import sharding as SH
from repro_torch.distributed.runtime import MESH_AXES
from repro_torch.models import layers as L
from repro_torch.models.model import Model
from repro_torch.training import checkpoint as CKPT
from repro_torch.training.compression import compress_grads, compression_init
from repro_torch.training.determinism import deterministic
from repro_torch.training.optimizer import (AdamWConfig, adamw_init,
                                            adamw_update, tree_map)

__all__ = ["TrainerConfig", "Trainer", "SimulatedFailure", "loss_and_grads",
           "reduce_grads", "refuse_unsupported", "state_shardings"]


class SimulatedFailure(RuntimeError):
    """A failure that a ``failure_hook`` raises on purpose. Over a process
    mesh ``run_with_restarts`` restarts on this alone; on one device on
    any ``RuntimeError``."""


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20             # <= 0: no checkpoints
    ckpt_dir: str = "checkpoints"
    keep_last: int = 3
    log_every: int = 10
    remat: bool = False
    grad_compression_ratio: Optional[float] = None  # e.g. 0.05
    straggler_factor: float = 3.0
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)


def loss_and_grads(model: Model, params: Any, batch: Dict[str, Any],
                   specs: Any = None, **loss_kw
                   ) -> Tuple[torch.Tensor, Dict[str, Any], Any]:
    """``(loss, metrics, grads)`` of ``model.loss(params, batch,
    **loss_kw)``: ``jax.value_and_grad``'s counterpart. The loss and
    metrics are detached; ``grads`` is shaped like ``params``, zeros for a
    leaf the loss does not read.

    ``specs``: the params' spec tree when ``params`` are this rank's
    blocks under an active process mesh: each autograd leaf is tagged
    with its spec (``annotate.unshard_fsdp`` reads it), and the grads are
    summed over the batch axes (``reduce_grads``)."""
    flat: List[torch.Tensor] = []

    def live(p, s=None):
        flat.append(p.detach().requires_grad_())
        return flat[-1] if s is None else A.tag(flat[-1], s)

    live_params = (tree_map(live, params) if specs is None
                   else tree_map(live, params, specs))
    loss, metrics = model.loss(live_params, batch, **loss_kw)
    got = iter(torch.autograd.grad(loss, flat, allow_unused=True))
    grads = tree_map(lambda p: _or_zeros(next(got), p), params)
    if specs is not None:
        grads = reduce_grads(grads, specs)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def reduce_grads(grads: Any, specs: Any) -> Any:
    """A rank's gradient blocks summed over the batch axes of the active
    process mesh: a leaf replicated over ``data`` summed over it (a leaf
    on ``data`` has had its sum reduce-scattered by the FSDP gather),
    then every leaf over ``pod``, whose ranks hold copies of the params.
    The JAX package compresses the whole gradient, so ``compress_grads``
    comes after this."""
    grads = tree_map(lambda g, s: g if "data" in s
                     else C.all_reduce_(g.contiguous(), "data"),
                     grads, specs)
    return tree_map(lambda g: C.all_reduce_(g.contiguous(), "pod"), grads)


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


def refuse_unsupported(cfg, axis_names, model_size: int) -> None:
    """Raise ``NotImplementedError`` for what sharded training does not
    cover: meshes over other axes than those of ``MESH_AXES`` (``("pod",
    "data", "model")``, ``("data", "model")``, ``("data",)``), rwkv6 and
    zamba2 heads that a model axis would split, and MoE experts that do
    not divide it (the specs' fallback layout, each expert's ``mlp`` dim
    on ``model``, which is not trained)."""
    if tuple(axis_names) not in MESH_AXES.values():
        raise NotImplementedError(
            f"a {tuple(axis_names)} mesh: sharded training runs over "
            f"{MESH_AXES[3]}, {MESH_AXES[2]} or {MESH_AXES[1]}")
    if cfg.family == "moe" and cfg.num_experts % model_size:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.num_experts} experts over a model axis of "
            f"{model_size}: the fallback layout (each expert's mlp dim on "
            f"'model') is not trained")
    if (cfg.family == "rwkv6" and cfg.d_model % model_size == 0
            and cfg.rwkv_heads % model_size):
        raise NotImplementedError(
            f"{cfg.name}: {cfg.rwkv_heads} heads over a model axis of "
            f"{model_size} would split a head")
    if cfg.family == "zamba2" and cfg.ssm_heads % model_size:
        raise NotImplementedError(
            f"{cfg.name}: {cfg.ssm_heads} SSD heads over a model axis of "
            f"{model_size} would split a head")


def _sharded(model: Model, shardings: Any):
    """(process mesh, spec tree) of a sharded Trainer, refusing what it
    cannot train."""
    from repro_torch.distributed.runtime import ProcessMesh
    leaves = [x for x in pytree.tree_leaves(
        shardings, is_leaf=lambda x: isinstance(x, SH.NamedSharding))
        if isinstance(x, SH.NamedSharding)]
    if not leaves:
        raise ValueError("shardings holds no NamedSharding")
    pm = leaves[0].mesh
    if not isinstance(pm, ProcessMesh):
        raise TypeError(
            "shardings over a plain Mesh: training over a mesh runs one "
            "process a rank; bind the specs to the ProcessMesh that "
            "distributed.runtime.init returns")
    if any(x.mesh is not pm for x in leaves):
        raise ValueError("shardings over more than one mesh")
    refuse_unsupported(model.cfg, pm.axis_names, pm.axis_size("model"))
    specs = pytree.tree_map(
        lambda x: x.spec if isinstance(x, SH.NamedSharding) else x,
        shardings, is_leaf=lambda x: isinstance(x, SH.NamedSharding))
    return pm, specs


def state_shardings(model: Model, pmesh, compression: bool = False):
    """The ``shardings`` of a train state over ``pmesh``: params and AdamW
    moments by ``param_pspecs``/``opt_pspecs``, the error-feedback state
    as the params (replicated scalar without compression)."""
    ps = SH.param_pspecs(model.defs(), pmesh)
    return SH.shardings(pmesh, {"params": ps,
                                "opt": SH.opt_pspecs(model.defs(), pmesh),
                                "err": ps if compression else ()})


class Trainer:
    """Drives ``model`` over a cursor-addressable batch function, on
    ``device`` (the card by default), or over a process mesh with
    ``shardings`` (on the rank's device)."""

    def __init__(self, model: Model, cfg: TrainerConfig,
                 batch_fn: Callable[[int], Dict[str, torch.Tensor]],
                 *, shardings: Any = None, device=None):
        self.model = model
        self.cfg = cfg
        self.batch_fn = batch_fn
        self.shardings = shardings
        self.pmesh, self.specs = (None, None) if shardings is None \
            else _sharded(model, shardings)
        if self.pmesh is not None:
            if device is not None and torch.device(device) != \
                    self.pmesh.device:
                raise ValueError(f"device {device} is not the rank's "
                                 f"{self.pmesh.device}")
            device = self.pmesh.device
        self.device = resolve_device(device)
        self.step_times: List[float] = []
        self.straggler_steps = 0

    @property
    def lead(self) -> bool:
        """Whether this process prints and writes (rank 0, or alone)."""
        return self.pmesh is None or self.pmesh.rank == 0

    # -- step ------------------------------------------------------------
    def _step_fn(self, params, opt_state, err_state, batch):
        cfg = self.cfg
        ps = None if self.specs is None else self.specs["params"]
        with deterministic(all_ops=True), self._mesh():
            loss, metrics, grads = loss_and_grads(self.model, params, batch,
                                                  ps, remat=cfg.remat)
            cmetrics = {}
            if cfg.grad_compression_ratio is not None:
                grads, err_state, cmetrics = compress_grads(
                    grads, err_state, ratio=cfg.grad_compression_ratio,
                    specs=ps)
            params, opt_state, om = adamw_update(grads, opt_state, params,
                                                 cfg.opt, ps)
        return params, opt_state, err_state, {
            "loss": loss, **metrics, **om, **cmetrics}

    def _mesh(self):
        return self.pmesh if self.pmesh is not None else \
            contextlib.nullcontext()

    def _blocks(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """A whole state as this rank's blocks (itself on one device)."""
        if self.pmesh is None:
            return state
        return SH.local_block(state, self.specs, self.pmesh)

    def local_batch(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The batch on the device, and over a process mesh this rank's
        block of its rows under ``batch_pspecs`` (split over the axes of
        ``(pod, data)`` that divide the batch, copied over the others:
        every row where it divides neither). A MoE model's rows must
        group as the global batch does (``layers.moe_check_batch``)."""
        batch = {k: v.to(self.device) for k, v in batch.items()}
        if self.pmesh is None:
            return batch
        b = next(iter(batch.values())).shape[0]
        specs = SH.batch_pspecs(self.model.cfg, self.pmesh, b, "train")
        local = {k: v[SH.NamedSharding(self.pmesh, specs.get(k, ()))
                      .devices_indices_map(tuple(v.shape))[self.pmesh.rank]]
                 for k, v in batch.items()}
        if self.model.cfg.family == "moe":
            rows, seq = local["tokens"].shape
            L.moe_check_batch(rows, seq, b, self.model.cfg)
        return local

    # -- state lifecycle ---------------------------------------------------
    def init_state(self, generator: Optional[torch.Generator] = None
                   ) -> Dict[str, Any]:
        """Fresh params (``Model.init``), AdamW state and error-feedback
        buffers. ``generator`` is read, not advanced (a copy of its state
        draws), so every call with it gives the same params, as a JAX key
        does; None draws from a generator seeded with 0. Over a process
        mesh every rank draws the whole params and keeps its block."""
        g = torch.Generator(device=self.device)
        if generator is None:
            g.manual_seed(0)
        else:
            g.set_state(generator.get_state())
        params = self.model.init(g, device=self.device)
        params = params if self.pmesh is None else SH.local_block(
            params, self.specs["params"], self.pmesh)
        return {
            "params": params,
            "opt": adamw_init(params),
            "err": (compression_init(params)
                    if self.cfg.grad_compression_ratio is not None
                    else torch.zeros((), device=self.device)),
        }

    def restore(self, template: Dict[str, Any]):
        """The newest intact checkpoint, each leaf this rank's block of
        the stored whole array over a process mesh (whatever mesh wrote
        it)."""
        if self.pmesh is None:
            return CKPT.restore_latest(self.cfg.ckpt_dir, template)
        return CKPT.restore_latest(self.cfg.ckpt_dir, template,
                                   specs=self.specs, pmesh=self.pmesh)

    def save(self, step: int, state: Dict[str, Any]) -> None:
        """Checkpoint ``state`` (this rank's blocks over a process mesh:
        every rank calls, rank 0 writes the whole arrays, and all wait
        for the write) under ``cfg.ckpt_dir``."""
        cfg = self.cfg
        extra = {"data_cursor": step,
                 "straggler_steps": self.straggler_steps}
        if self.pmesh is None:
            CKPT.save_checkpoint(cfg.ckpt_dir, step, state, extra=extra,
                                 keep_last=cfg.keep_last)
            return
        whole = SH.gather_logical(state, self.specs, self.pmesh, root=0)
        if self.lead:
            CKPT.save_checkpoint(cfg.ckpt_dir, step, whole, extra=extra,
                                 keep_last=cfg.keep_last)
        del whole
        dist.barrier()

    # -- main loop ---------------------------------------------------------
    def run(self, generator: Optional[torch.Generator] = None, *,
            start_state=None, start_step=0,
            failure_hook: Optional[Callable[[int], None]] = None
            ) -> Dict[str, Any]:
        """Train from ``start_state`` (e.g. a JAX package state through
        ``np.asarray``: its leaves come across bit for bit; over a process
        mesh each rank keeps its block) or a fresh
        ``init_state(generator)``, from ``start_step`` to
        ``total_steps``."""
        state = (self._blocks(_on(self.device, start_state))
                 if start_state is not None else self.init_state(generator))
        return self._run(state, start_step, failure_hook)

    def _run(self, state, step, failure_hook) -> Dict[str, Any]:
        cfg = self.cfg
        history = []
        while step < cfg.total_steps:
            if failure_hook is not None:
                failure_hook(step)          # may raise (simulated crash)
            batch = self.local_batch(self.batch_fn(step))
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
            if step % cfg.log_every == 0 and self.lead:
                print(f"  step {step:5d} loss {metrics['loss']:.4f} "
                      f"({dt * 1e3:.0f} ms)", flush=True)
            if cfg.ckpt_every > 0 and (step % cfg.ckpt_every == 0
                                       or step == cfg.total_steps):
                self.save(step, state)
        return {"state": state, "history": history, "final_step": step}

    def run_with_restarts(self, generator: Optional[torch.Generator] = None,
                          *, failure_hook=None, max_restarts: int = 5):
        """Crash-resilient outer loop: restore-and-continue on failure (a
        ``RuntimeError`` on one device; over a process mesh a
        :class:`SimulatedFailure`, which every rank raises at the same
        step, and nothing else)."""
        attempts = 0
        state, start_step = None, 0
        restart_on = RuntimeError if self.pmesh is None else SimulatedFailure
        while True:
            try:
                if state is None:
                    state = self.init_state(generator)
                return self._run(state, start_step, failure_hook)
            except restart_on as e:
                attempts += 1
                if attempts > max_restarts:
                    raise
                err = str(e)
            # Outside the except block, so the failed run's frames (and
            # its state on the card) are freed before a fresh one is made.
            state = None
            if self.pmesh is not None:
                dist.barrier()   # every rank restores the same checkpoint
            fresh = self.init_state(generator)   # structure template
            restored = self.restore(fresh)
            if restored is None:
                state, start_step = fresh, 0
            else:
                start_step, state, _ = restored
            del fresh
            if self.lead:
                print(f"[trainer] restart #{attempts} from step "
                      f"{start_step} after: {err}", flush=True)

    # -- straggler tracking --------------------------------------------------
    def _track_stragglers(self, dt: float):
        self.step_times.append(dt)
        if len(self.step_times) >= 5:
            med = float(np.median(self.step_times[-50:]))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_steps += 1
