"""The engine protocol the serving layer drives, and the frame wing (port
of ``repro.core.engine``).

An engine declares ``modality`` and ``duration_us`` and implements
``validate``/``prepare``/``init_state``/``infer``/``shape_key``; the
optional ``infer_dispatch``/``infer_collect`` split, ``warmup``,
``export_state``/``import_state`` and the megastep adapters
(``_mega_parts``/``_mega_args``/``_mega_split``) are probed with
``getattr``/``hasattr``. Two
engines implement it: the event wing,
:class:`~repro_torch.core.pipeline.BatchedClosedLoop`, and the frame wing,
:class:`FrameTCNEngine` (here): frame normalization (``core/frames.py``),
the CUTIE ternary CNN (``core/tcn.py``, fc1 through kernel K3) and
per-stream CUTIE latency/energy accounting
(:meth:`~repro_torch.core.energy.KrakenModel.frame_loop`). Both return
:class:`~repro_torch.core.pipeline.ClosedLoopResult` rows.
"""
from __future__ import annotations

from typing import (Any, Callable, Dict, Hashable, List, Optional, Protocol,
                    Sequence, runtime_checkable)

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import frames as fr
from repro_torch.core._api import EngineConfig
from repro_torch.core.energy import KrakenModel
from repro_torch.core.graphs import GraphCache
from repro_torch.core.pipeline import (PWM_CHANNELS, ClosedLoopResult,
                                       _host_rows, _Shard, _SlotSharding,
                                       export_state_slot, import_state_slot,
                                       pwm_from_logits)
from repro_torch.distributed.mesh import Mesh
from repro_torch.core.tcn import (TCN_LAYERS, TCNConfig, pack_tcn, tcn_apply,
                                  tcn_layer_macs)

__all__ = ["InferenceEngine", "FrameTCNEngine"]


@runtime_checkable
class InferenceEngine(Protocol):
    """What the serving layer needs from an accelerator wing."""

    modality: str
    duration_us: Optional[int]

    def validate(self, item: Any) -> None:
        """Raise ValueError if ``item`` cannot be served by this engine.
        Must not mutate queue-visible state on failure (latching the
        engine's ``duration_us`` on first success is allowed)."""
        ...

    def prepare(self, items: Sequence[Optional[Any]], *,
                batch_size: int) -> Any:
        """Pad one item per slot (None = empty slot) into a batch."""
        ...

    def init_state(self, batch_size: int) -> Any:
        """Zero carried state, slot-major; empty if stateless."""
        ...

    def infer(self, batch: Any, state: Any = None):
        """Run one batch; one result per slot, None for empty slots.

        Without ``state``: returns the result list. With ``state``:
        returns ``(results, new_state)``."""
        ...

    def shape_key(self, batch: Any) -> Hashable:
        """The shape key of a prepared batch."""
        ...


class FrameTCNEngine(_SlotSharding):
    """The CUTIE wing: frame batch -> ternary CNN -> actuation.

    One call normalizes and classifies a whole
    :class:`~repro_torch.core.frames.PaddedFrameBatch` on ``device``
    (``None`` = ``cuda``; without a card only ``device="cpu"`` works);
    the Kraken model then accounts each slot with its own pixel count and
    operand activity. ``params`` are float TCN params in the port's layout
    (packed here with :func:`~repro_torch.core.tcn.pack_tcn`) or, with
    ``prepacked=True``, ``pack_tcn`` output (see
    :func:`repro_torch.convert.tcn_params_from_numpy`). The wing is
    feedforward per frame: its carried state is the empty dict.

    On the card each shape key's step is one captured CUDA graph, as on
    the event wing. ``infer_dispatch`` only queues work on the device's
    current stream; ``infer_collect`` is the one point that waits (one
    device-to-host copy, one a shard on a mesh).

    With ``mesh`` the slots are sharded over the mesh's slot axis, as on
    the event wing (:meth:`attach_mesh`): each shard classifies its rows
    with its own copy of the packed weights, its own graphs and staging
    buffers, on its own device (``device=None`` then means the mesh's
    first device).
    """

    modality = "frame"
    _WEIGHTS = "packed"

    def __init__(
        self,
        params,
        cfg: TCNConfig,
        *,
        model: Optional[KrakenModel] = None,
        duration_us: Optional[int] = None,
        window_ms: float = 300.0,
        prepacked: bool = False,
        device=None,
        mesh: Optional[Mesh] = None,
    ):
        if device is None and isinstance(mesh, Mesh):
            device = mesh.device_list[0]
        self.device = resolve_device(device)
        packed = params if prepacked else pack_tcn(params)
        self.packed = {name: {k: v.to(self.device) for k, v in layer.items()}
                       for name, layer in packed.items()}
        self.cfg = cfg
        self.model = model or KrakenModel()
        self.duration_us = duration_us
        self.window_ms = window_ms
        self.layer_macs = tcn_layer_macs(cfg)
        self.total_macs = float(sum(self.layer_macs))
        self._graphs = GraphCache(self.device)
        if mesh is not None:
            self.attach_mesh(mesh)

    @classmethod
    def from_config(cls, params, cfg: TCNConfig, config: EngineConfig, *,
                    model: Optional[KrakenModel] = None,
                    prepacked: bool = False, device=None):
        """Construct from the :class:`EngineConfig` surface. ``fuse_fc``
        and the serving-layer fields do not apply to the frame wing;
        ``mesh`` shards the slots."""
        return cls(params, cfg, model=model, prepacked=prepacked,
                   duration_us=config.duration_us,
                   window_ms=config.window_ms, device=device,
                   mesh=config.mesh)

    # -- InferenceEngine protocol ----------------------------------------

    def validate(self, frame: fr.FrameWindow) -> None:
        if frame.shape != (self.cfg.height, self.cfg.width):
            raise ValueError(
                f"frame shape {frame.shape} != engine geometry "
                f"({self.cfg.height}, {self.cfg.width})")
        if self.duration_us is None:
            self.duration_us = frame.duration_us
        elif frame.duration_us != self.duration_us:
            raise ValueError(
                f"frame period {frame.duration_us} != engine period "
                f"{self.duration_us} (one tick length per engine)")

    def prepare(self, items: Sequence[Optional[fr.FrameWindow]], *,
                batch_size: int) -> fr.PaddedFrameBatch:
        return fr.pad_frame_windows(
            items, batch_size=batch_size, duration_us=self.duration_us,
            height=self.cfg.height, width=self.cfg.width)

    def shape_key(self, batch: fr.PaddedFrameBatch) -> Hashable:
        return (batch.batch_size, *batch.frame_shape, batch.duration_us)

    def init_state(self, batch_size: int) -> Dict:
        """No carried state: the empty dict, so stateful serving threads
        ``{}`` through unchanged (a stateful frame stream carries
        nothing)."""
        return {}

    def _run(self, pixels: torch.Tensor, packed) -> torch.Tensor:
        """Normalize + classify + readout on the device. Returns one packed
        (B, 1 + channels + classes + 4) f32 tensor: prediction, PWM,
        logits, per-layer operand activity."""
        out = tcn_apply(packed, fr.normalize_frames(pixels), self.cfg)
        logits = out["logits"]
        act = out["activity_per_stream"]
        return torch.cat([
            torch.argmax(logits, -1).float()[:, None],
            pwm_from_logits(logits), logits,
            torch.stack([act[k] for k in TCN_LAYERS], 1),
        ], dim=1)

    def _build_run(self, key=None, shard: Optional[_Shard] = None
                   ) -> Callable:
        """The step of a frame batch: ``run((pixels,))`` -> ``(packed,)``.
        The same function is captured on the card and called on the
        CPU; given a shard, it runs with the shard's weights."""
        packed = self.packed if shard is None else shard.weights

        def run(args):
            with torch.no_grad():
                return (self._run(args[0], packed),)

        return run

    def _inputs(self, key, shard: Optional[_Shard] = None):
        """A fresh static (B, H, W, 1) f32 pixel buffer for capture: the
        whole batch's on the engine's device, or a shard's rows on its
        device."""
        b, h, w = int(key[0]), int(key[1]), int(key[2])
        if shard is not None:
            b //= len(self._shards)
        device = self.device if shard is None else shard.device
        return (torch.zeros((b, h, w, 1), dtype=torch.float32,
                            device=device),)

    def warmup(self, shape_keys) -> None:
        """Prepare each ``(batch_size, height, width[, duration_us])`` key
        before serving: on the card, capture its CUDA graph (the eager
        call before the capture builds the kernels); on the CPU, record
        it. A 3-tuple key borrows the engine's latched ``duration_us`` and
        therefore requires one."""
        for key in shape_keys:
            key = tuple(key)
            if len(key) == 3:
                if self.duration_us is None:
                    raise ValueError(
                        "3-tuple shape key needs a pinned tick period: "
                        "latch duration_us first (pass duration_us= at "
                        "construction or validate a frame) or pass the "
                        "full (batch, height, width, duration_us) key")
                key = (*key, self.duration_us)
            if len(key) != 4:
                raise ValueError(
                    f"shape key must be (batch, height, width[, "
                    f"duration_us]), got {key}")
            key = tuple(int(k) for k in key)
            if key[1:3] != (self.cfg.height, self.cfg.width):
                raise ValueError(
                    f"shape key geometry {key[1:3]} != engine geometry "
                    f"({self.cfg.height}, {self.cfg.width})")
            self._prepare(key)

    # -- cross-wing megastep adapters ------------------------------------
    # Counterparts of BatchedClosedLoop's: the serving layer's fused
    # megastep captures this wing's run (``_mega_parts``) next to the
    # event wing's in one CUDA graph (see EngineConfig.megastep).

    def _mega_args(self, batch: fr.PaddedFrameBatch, state):
        """The concrete arguments matching :meth:`_mega_parts` (in a
        pinned staging buffer of the key on the card); the CUTIE wing
        carries no state, so ``state`` is ignored."""
        return self._pixels(batch, slice(None), self._graphs, self.device)

    def _pixels(self, batch: fr.PaddedFrameBatch, rows: slice,
                graphs: GraphCache, device: torch.device) -> tuple:
        """``(pixels,)`` of slots ``rows``: on the card in the next pinned
        staging buffer of the key in ``graphs``, on the CPU the batch's
        own array."""
        pixels = batch.pixels[rows]
        if device.type != "cuda":
            return (torch.from_numpy(pixels),)
        staged = graphs.staging(self.shape_key(batch), pixels.shape,
                                torch.float32)
        staged.numpy()[...] = pixels
        return (staged,)

    def _mega_split(self, out, batch: fr.PaddedFrameBatch, state):
        """Split a step's outputs into the ``(pending, state)`` pair
        :meth:`infer_dispatch` returns (no-op carry passthrough)."""
        return (batch, out[0]), state

    def infer_dispatch(self, batch: fr.PaddedFrameBatch, state=None):
        """Queue a frame batch on the device without waiting for it.

        Returns a pending handle for :meth:`infer_collect` -- or, with
        ``state`` (the empty dict), ``(pending, state)``. On the card the
        pixels go up in one copy from a pinned staging buffer and the
        key's graph is replayed (captured first if the key was not
        warmed).
        """
        key = self.shape_key(batch)
        if self.mesh is None:
            out = self._call(key, self._mega_args(batch, state))
            pending, state = self._mega_split(out, batch, state)
            return pending if state is None else (pending, state)

        pending = (batch, [o[0] for o in self._sharded_call(
            key, lambda sh, rows: self._pixels(batch, rows, sh.graphs,
                                               sh.device))])
        return pending if state is None else (pending, state)

    def infer_collect(self, pending) -> List[Optional[ClosedLoopResult]]:
        """Fetch a dispatched batch's outputs and account each slot (the
        one device-to-host copy; on a mesh one a shard, in slot order)."""
        batch, packed = pending
        arr = _host_rows(packed)
        c = self.cfg.num_classes
        preds = arr[:, 0].astype(np.int32)
        pwm = arr[:, 1:1 + PWM_CHANNELS]
        logits = arr[:, 1 + PWM_CHANNELS:1 + PWM_CHANNELS + c]
        activity = arr[:, 1 + PWM_CHANNELS + c:]

        results: List[Optional[ClosedLoopResult]] = []
        for b in range(batch.batch_size):
            if not batch.occupied[b]:
                results.append(None)
                continue
            # CUTIE runs its full dense schedule regardless of content;
            # per-stream differences surface as switching activity.
            act = float(np.mean([activity[b, i]
                                 for i in range(len(TCN_LAYERS))]))
            acct = self.model.frame_loop(
                float(batch.num_pixels[b]), self.total_macs, activity=act)
            latency = float(acct["total_time_ms"])
            proc_ms = (acct["stages"]["preprocessing"]["time_ms"]
                       + acct["stages"]["tcn_inference"]["time_ms"])
            period_ms = max(self.window_ms, proc_ms)
            results.append(ClosedLoopResult(
                label_pred=preds[b:b + 1],
                pwm=pwm[b:b + 1],
                latency_ms=latency,
                energy_mj=float(acct["total_energy_mj"]),
                breakdown=acct,
                realtime=latency <= self.window_ms,
                sustained_rate_hz=1000.0 / period_ms,
                logits=logits[b:b + 1],
            ))
        return results

    def export_state(self, state, slot: int):
        """Host copy of one slot's carry: the empty dict."""
        return export_state_slot(state, slot)

    def import_state(self, state, slot: int, payload):
        """Splice a carry back into row ``slot`` (a no-op on ``{}``)."""
        return import_state_slot(state, slot, payload)

    def infer(self, batch: fr.PaddedFrameBatch, state=None):
        """Dispatch + collect back to back. With ``state`` returns
        ``(results, state)``."""
        if state is None:
            return self.infer_collect(self.infer_dispatch(batch))
        pending, new_state = self.infer_dispatch(batch, state)
        return self.infer_collect(pending), new_state

    def infer_frames(self, frames: Sequence[Optional[fr.FrameWindow]], *,
                     batch_size: Optional[int] = None,
                     ) -> List[Optional[ClosedLoopResult]]:
        """Convenience: validate and pad a frame list, run it as one
        batch."""
        frames = list(frames)
        if not frames and not batch_size:
            return []
        for f in frames:
            if f is not None:
                self.validate(f)
        return self.infer(self.prepare(
            frames, batch_size=batch_size or len(frames)))
