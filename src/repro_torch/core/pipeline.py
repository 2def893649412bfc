"""The ColibriES closed control loop: acquire -> preprocess -> infer -> act.

Port of ``repro.core.pipeline``. :class:`BatchedClosedLoop` voxelizes and
infers a padded batch of ``B`` event windows on its device (the card
unless the caller asks for the CPU), then accounts each stream's Kraken
latency and energy on the host from its true event count and firing
rates. :class:`ClosedLoopPipeline` is the paper's single-window loop, a
B=1 view of it.

Every per-stream operation on the path -- integer voxel sums, pools of
spikes, ascending-k fc sums, elementwise LIF dynamics, per-row reductions
-- is row-independent by construction, so a stream's result does not
depend on the batch it rides in. The convolutions are the one library
call on the path; whether cuDNN keeps rows independent is checked on the
card by ``chip_smoke.py``.

On the card each shape key's step is one captured CUDA graph
(``core/graphs.py``, the counterpart of the JAX package's AOT executable
per key): ``warmup`` captures it, and every dispatch copies the batch's
events (staged in pinned host memory) and the carried state into the
graph's inputs and replays it. On the CPU the same step runs eagerly.
``infer_dispatch`` only queues work on the device's current stream and
never synchronises; ``infer_collect`` is the one point that waits.

Slot sharding (``mesh=``, :meth:`_SlotSharding.attach_mesh`): the step of
a mesh-attached engine runs as one shard per block of the mesh's slot
axis, each on its own device with its own graphs, staging buffers and
copy of the weights (see the section below).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree

from repro_torch import resolve_device
from repro_torch.core import events as ev
from repro_torch.core._api import EngineConfig
from repro_torch.core.energy import KrakenModel
from repro_torch.core.graphs import GraphCache
from repro_torch.core.snn import (SNN_STATE_LAYERS, SNNConfig, snn_apply,
                                  snn_init_state, snn_logits)
from repro_torch.core.tiling import SNE_NEURON_CAPACITY, plan_network
from repro_torch.distributed.mesh import Mesh, slot_axis
from repro_torch.distributed.sharding import (NamedSharding, ShardedTensor,
                                              place, slot_pspec,
                                              slot_shardings)

__all__ = ["ClosedLoopResult", "BatchedClosedLoop", "ClosedLoopPipeline",
           "pwm_from_logits", "export_state_slot", "import_state_slot"]

PWM_CHANNELS = 4


def export_state_slot(state: Dict[str, torch.Tensor], slot: int
                      ) -> Dict[str, np.ndarray]:
    """One slot's row of a slot-major carried state, as host numpy arrays
    (a copy: this waits for the device). A sharded state gives the row of
    the block that holds it: the mesh layout never reaches the copy."""
    return {k: v[slot].detach().cpu().numpy().copy()
            for k, v in state.items()}


def import_state_slot(state: Dict[str, torch.Tensor], slot: int,
                      payload) -> Dict[str, torch.Tensor]:
    """A new slot-major state equal to ``state`` with row ``slot``
    replaced by ``payload`` (an :func:`export_state_slot`-shaped dict).
    The exact inverse of export for f32 planes. A sharded plane gets the
    row in the block that holds it; its other blocks are shared."""
    out = {}
    for k, a in state.items():
        if isinstance(a, ShardedTensor):
            out[k] = a.with_row(slot, np.asarray(payload[k]))
            continue
        a = a.clone()
        a[slot] = torch.as_tensor(np.asarray(payload[k]), dtype=a.dtype,
                                  device=a.device)
        out[k] = a
    return out


def _host_rows(packed) -> np.ndarray:
    """A step's packed rows on the host: one device-to-host copy of the
    tensor, or of each shard's block (a list, in slot order)."""
    if isinstance(packed, torch.Tensor):
        return packed.cpu().numpy()
    return np.concatenate([p.cpu().numpy() for p in packed])


def _mix_matrix(n_cls: int, num_channels: int) -> np.ndarray:
    mix = (np.arange(n_cls)[:, None] * np.arange(1, num_channels + 1)[None, :])
    return np.cos(mix / n_cls * np.pi).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mix_on(n_cls: int, num_channels: int,
            device: torch.device) -> torch.Tensor:
    """The mixing matrix on ``device``, copied there once: a copy from
    pageable host memory inside a step cannot be captured in a graph."""
    return torch.from_numpy(_mix_matrix(n_cls, num_channels)).to(device)


def pwm_from_logits(logits: torch.Tensor,
                    num_channels: int = PWM_CHANNELS) -> torch.Tensor:
    """Map classifier logits to PWM duty cycles in [0, 1].

    A fixed linear map from class posteriors to ``num_channels``
    actuation channels, with the JAX package's numpy f32 mixing matrix.
    Broadcast-multiply, then a sum over classes in ascending order (not
    ``probs @ mix``, whose order changes with the row count), so each row
    is batch-size invariant.
    """
    probs = torch.softmax(logits.float(), dim=-1)
    n_cls = probs.shape[-1]
    mix = _mix_on(n_cls, num_channels, probs.device)
    terms = probs[..., :, None] * mix
    duty = terms[..., 0, :]
    for c in range(1, n_cls):
        duty = duty + terms[..., c, :]
    return torch.clamp(0.5 + 0.5 * duty, 0.0, 1.0)


# ----------------------------------------------------------------------
# Slot-axis sharding (shared by both engine wings).
#
# A mesh-attached engine runs each step as one shard per block of the
# mesh's slot axis: shard i takes rows [i*B/n, (i+1)*B/n) of the batch and
# of the carried state through the wing's own step, on its own device,
# with its own captured graph per shape key, its own pinned staging
# buffers and its own copy of the weights. That is the JAX package's
# shard_map step with the shards placed by hand: nothing in a shard's step
# reads another shard's data, and every per-stream operation of the step
# is row-independent, so each shard's rows are the bits the unsharded
# engine gives them. Every shard is queued before any is collected, so
# the devices of a real mesh run at once; a mesh that names one device n
# times (a logical mesh) runs its shards one after another there.
# ----------------------------------------------------------------------

def _mesh_slot_info(mesh: Mesh) -> Tuple[str, int]:
    """(axis name, axis size) the engines shard slots over."""
    ax = slot_axis(mesh)
    return ax, mesh.shape[ax]


def _replicate_to_mesh(tree, mesh: Mesh):
    """Place a tree whole on every mesh device (the weights)."""
    return place(tree, NamedSharding(mesh, ()))


def _slot_shard_to_mesh(tree, mesh: Mesh):
    """Place a slot-major tree with its leading axis over the slot axis (a
    tree already placed so is returned as it is)."""
    return place(tree, slot_shardings(mesh, tree))


def _check_slot_divisible(batch_size: int, mesh: Mesh, what: str) -> None:
    ax, n = _mesh_slot_info(mesh)
    if batch_size % n != 0:
        raise ValueError(
            f"{what} batch size {batch_size} does not divide over the "
            f"mesh slot axis '{ax}' ({n} devices); size lanes/batches in "
            f"multiples of the mesh size (EngineConfig.max_streams)")


def _on_device(device: torch.device):
    """Make ``device`` the current CUDA device (nothing for the CPU)."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


@dataclasses.dataclass(eq=False)
class _Shard:
    """One block of slots of a mesh-attached engine: its position in the
    mesh's device list, its device, the engine's weights on that device
    and its own graph cache (graphs, pool, staging buffers)."""
    pos: int
    device: torch.device
    weights: Any
    graphs: GraphCache


def _slot_positions(mesh: Mesh) -> List[int]:
    """For each block of the slot axis, the first mesh position that holds
    it (on a mesh with other axes, the positions beside it hold copies)."""
    ax, n = _mesh_slot_info(mesh)
    k = mesh.axis_names.index(ax)
    coords = np.indices(mesh.axis_sizes).reshape(len(mesh.axis_sizes), -1).T
    first: Dict[int, int] = {}
    for p, c in enumerate(coords):
        first.setdefault(int(c[k]), p)
    return [first[i] for i in range(n)]


def _from_shards(mesh: Mesh, blocks: Sequence[torch.Tensor]
                 ) -> ShardedTensor:
    """A slot-major tensor from one block per shard, in slot order: each
    shard's position holds its block as it is; any other position holding
    the same slots gets a copy on its device."""
    rows = blocks[0].shape[0]
    shape = (rows * len(blocks), *blocks[0].shape[1:])
    return ShardedTensor.build(
        NamedSharding(mesh, slot_pspec(len(shape), mesh)), shape,
        lambda idx, dev: blocks[idx[0].start // rows].to(dev))


class _SlotSharding:
    """Slot-axis sharding for an engine wing. The wing provides
    ``device``, its weights under the attribute named ``_WEIGHTS``,
    ``_graphs`` (its unsharded graph cache), ``_build_run(key, shard)``
    and ``_inputs(key, shard)``: a step's run function and static inputs,
    of the whole batch or, given a :class:`_Shard`, of the shard's rows
    with the shard's weights on its device."""

    mesh: Optional[Mesh] = None
    _shards: Tuple[_Shard, ...] = ()
    _WEIGHTS = "params"

    def attach_mesh(self, mesh: Optional[Mesh]) -> None:
        """Shard this engine's slot axis over ``mesh``'s slot axis
        (:func:`~repro_torch.distributed.mesh.slot_axis`).

        The weights are placed whole on every mesh device; from here on
        every step runs as one shard per block of slots (one graph per
        shard and shape key on the card) and batches and states are placed
        slot-major on dispatch. Must happen before any shape key is served
        or warmed (a graph of the whole batch binds unsharded buffers),
        and a second attach with a *different* mesh is an error --
        re-attaching the same mesh is a no-op, which is what lets
        ``StreamEngine`` thread one mesh to caller-provided engines. The
        mesh's devices are of the engine's device type: a mesh never moves
        an engine between the card and the CPU.
        """
        if mesh is None or mesh == self.mesh:
            return
        if self.mesh is not None:
            raise ValueError(
                "engine is already attached to a different mesh; one "
                "engine serves one mesh for its whole lifetime")
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a repro_torch.distributed.Mesh "
                            f"(make_mesh), got {type(mesh).__name__}")
        if self.compiled_shape_keys():
            raise RuntimeError(
                "attach_mesh after shape keys were compiled: attach the "
                "mesh at construction (EngineConfig(mesh=...)) or before "
                "the first infer/warmup call")
        kinds = {d.type for d in mesh.device_list}
        if kinds != {self.device.type}:
            raise ValueError(
                f"mesh devices are {sorted(kinds)}, the engine runs on "
                f"{self.device.type}; build the engine on the mesh's "
                f"device type")
        weights = _replicate_to_mesh(getattr(self, self._WEIGHTS), mesh)
        self._shards = tuple(
            _Shard(p, mesh.device_list[p],
                   pytree.tree_map(lambda a, p=p: a.blocks[p], weights),
                   GraphCache(mesh.device_list[p]))
            for p in _slot_positions(mesh))
        self.mesh = mesh
        self.device = self._shards[0].device
        if hasattr(self, "_zero_state"):
            self._zero_state.clear()   # rebuilt on the mesh at next use

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The devices the engine's steps run on: every shard's on a mesh
        (a logical mesh repeats one), else the engine's device."""
        if self.mesh is None:
            return (self.device,)
        return tuple(sh.device for sh in self._shards)

    def compiled_shape_keys(self) -> set:
        """Shape keys with a captured graph on the card (warmed or
        served); on the CPU, the keys warmed or served. Keys are the whole
        lane's, whether or not the engine is sharded."""
        if self.mesh is None:
            return self._graphs.keys()
        return self._shards[0].graphs.keys()

    def _step_of(self, key, shard: Optional[_Shard] = None):
        """The key's captured step in the whole batch's graph cache or in
        ``shard``'s, captured on first use (on the cache's device); None
        on the CPU."""
        if shard is None:
            return self._graphs.get(key, lambda: self._mega_parts(key))
        return shard.graphs.get(key, lambda: (
            self._build_run(key, shard), self._inputs(key, shard)))

    def _prepare(self, key) -> None:
        """Capture (card) or record (CPU) a shape key's step: the whole
        batch's, or each shard's."""
        if self.mesh is None:
            self._step_of(key)
            return
        _check_slot_divisible(int(key[0]), self.mesh, "sharded-engine")
        for sh in self._shards:
            self._step_of(key, sh)

    def _call(self, key, args, shard: Optional[_Shard] = None) -> tuple:
        """One step's outputs, of the whole batch or of ``shard``'s rows: a
        replay of the key's graph on the card (captured first if the key
        was not warmed), the run function itself on the CPU."""
        step = self._step_of(key, shard)
        return (self._build_run(key, shard)(args) if step is None
                else step(args))

    def _sharded_call(self, key, args_of: Callable) -> List[tuple]:
        """Every shard's step outputs, in slot order. ``args_of(shard,
        rows)`` gives a shard's arguments (``rows`` is its slice of the
        batch); each shard's arguments are staged, its graph replayed and
        its outputs copied under its own device, and every shard is queued
        before this returns: nothing here waits for a device."""
        b = int(key[0])
        _check_slot_divisible(b, self.mesh, "sharded-engine")
        per = b // len(self._shards)
        outs = []
        for i, sh in enumerate(self._shards):
            with _on_device(sh.device):
                outs.append(self._call(
                    key, args_of(sh, slice(i * per, (i + 1) * per)), sh))
        return outs

    def _mega_parts(self, key):
        """``(run, inputs)`` of a shape key's whole-batch step, for
        capture: the serving layer's fused megastep captures it next to
        the other wing's. The megastep is single-device."""
        if self.mesh is not None:
            raise ValueError(
                "the fused megastep does not compose with a mesh-attached "
                "engine")
        return self._build_run(key), self._inputs(key)


@dataclasses.dataclass
class ClosedLoopResult:
    label_pred: np.ndarray
    pwm: np.ndarray
    latency_ms: float
    energy_mj: float
    breakdown: Dict[str, Any]
    realtime: bool
    sustained_rate_hz: float
    # Pre-actuation classifier logits, (1, num_classes).
    logits: Optional[np.ndarray] = None


class BatchedClosedLoop(_SlotSharding):
    """Batched event-window -> actuation engine with per-stream accounting.

    The event wing of the :class:`~repro_torch.core.engine.InferenceEngine`
    protocol. One call voxelizes and infers a whole
    :class:`~repro_torch.core.events.PaddedEventBatch` on ``device``
    (``None`` = ``cuda``; without a card only ``device="cpu"`` works).
    ``duration_us`` is the one-bin-width-per-engine contract (pinned at
    construction or latched from the first validated window).

    The network runs layer-serial: the conv scans through kernel K1 and
    fc1/fc2 through kernel K2 (the JAX package's ``fuse_fc=True``; its
    unfused path computes the same function, so the port has this one).

    Carried state is a dict of slot-major (B, ...) f32 membrane tensors on
    the device, one per LIF layer: ``init_state(B)`` is the cold start,
    ``infer(batch, state)`` returns ``(results, new_state)``, and feeding
    ``new_state`` back chains windows into one uninterrupted scan.

    With ``mesh`` (a :class:`~repro_torch.distributed.mesh.Mesh`; see
    :meth:`attach_mesh`) the slots are sharded over the mesh's slot axis:
    ``device=None`` then means the mesh's first device, the state comes
    back as :class:`~repro_torch.distributed.sharding.ShardedTensor`
    planes, and every row equals the unsharded engine's bit for bit.
    """

    modality = "event"

    def __init__(
        self,
        params,
        cfg: SNNConfig,
        *,
        model: Optional[KrakenModel] = None,
        window_ms: float = 300.0,
        duration_us: Optional[int] = None,
        device=None,
        mesh: Optional[Mesh] = None,
    ):
        if device is None and isinstance(mesh, Mesh):
            device = mesh.device_list[0]
        self.device = resolve_device(device)
        self.params = {name: {k: v.to(self.device, torch.float32)
                              for k, v in layer.items()}
                       for name, layer in params.items()}
        self.cfg = cfg
        self.model = model or KrakenModel()
        self.window_ms = window_ms
        self.duration_us = duration_us
        sizes = cfg.spatial_sizes()
        # SNE executes conv1/conv2/fc1/fc2; tile plans sized by each layer's
        # output volume against SNE's neuron capacity.
        self.plans = plan_network(
            [("conv1", sizes["conv1"]), ("conv2", sizes["conv2"]),
             ("fc1", sizes["fc1"]), ("fc2", sizes["fc2"])],
            SNE_NEURON_CAPACITY,
        )
        self.fanouts = (
            9.0 * cfg.conv1_features,         # 3x3 kernel into conv1 features
            9.0 * cfg.conv2_features,
            float(cfg.hidden),
            float(cfg.num_classes),
        )
        self._graphs = GraphCache(self.device)
        self._zero_state: Dict[int, Dict[str, torch.Tensor]] = {}
        if mesh is not None:
            self.attach_mesh(mesh)

    @classmethod
    def from_config(cls, params, cfg: SNNConfig, config: EngineConfig, *,
                    model: Optional[KrakenModel] = None, device=None):
        """Construct from the :class:`EngineConfig` surface (its serving
        fields belong to ``StreamEngine``; ``mesh`` shards the slots).
        Both values of ``fuse_fc`` run fc1/fc2 through K2: they name two
        executions of one function in the JAX package, and the port has
        the fused one only."""
        return cls(params, cfg, model=model, window_ms=config.window_ms,
                   duration_us=config.duration_us, device=device,
                   mesh=config.mesh)

    # -- InferenceEngine protocol ----------------------------------------

    def init_state(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """The zero carried state for ``batch_size`` slots, on the device.

        On a mesh-attached engine it comes back slot-sharded when
        ``batch_size`` divides over the slot axis; an indivisible size
        (the 1-slot scratch state a checkpoint restore splices into) stays
        plain tensors on the engine's device: it is only sliced and
        spliced, never inferred."""
        state = snn_init_state(self.cfg, batch_size, device=self.device)
        if self.mesh is not None and \
                batch_size % _mesh_slot_info(self.mesh)[1] == 0:
            state = _slot_shard_to_mesh(state, self.mesh)
        return state

    def _zero_state_for(self, batch_size: int):
        st = self._zero_state.get(batch_size)
        if st is None:
            st = self._zero_state[batch_size] = self.init_state(batch_size)
        return st

    def validate(self, window: ev.EventWindow) -> None:
        """Submission-time check: latch/enforce the engine bin width."""
        if self.duration_us is None:
            self.duration_us = window.duration_us
        elif window.duration_us != self.duration_us:
            raise ValueError(
                f"window duration {window.duration_us} != engine duration "
                f"{self.duration_us} (one bin width per engine)")

    def prepare(self, items: Sequence[Optional[ev.EventWindow]], *,
                batch_size: int) -> ev.PaddedEventBatch:
        """Pad one window per slot into the engine's fixed batch buffer,
        with event counts padded to power-of-two buckets."""
        bucket = ev.next_pow2(max(
            (w.num_events for w in items if w is not None), default=1))
        return ev.pad_event_windows(
            items, max_events=bucket, batch_size=batch_size,
            duration_us=self.duration_us)

    def shape_key(self, batch: ev.PaddedEventBatch):
        return (batch.batch_size, batch.max_events, batch.duration_us)

    def _run(self, events: torch.Tensor, duration_us: int,
             state: Dict[str, torch.Tensor], params):
        """Voxelize + infer + readout on the device. ``events`` is the
        (5, B, N) int32 stack of x, y, t, p, valid. Returns one packed
        (B, 1 + channels + classes + 4) f32 tensor -- prediction, PWM,
        logits, per-layer rates -- and the new state."""
        cfg = self.cfg
        x, y, t, p, valid = events
        vox = ev.voxelize_batch(
            x, y, t, p, valid.bool(), duration_us=duration_us,
            time_bins=cfg.time_bins, height=cfg.height, width=cfg.width)
        out = snn_apply(params, vox, cfg, mode="layer_serial",
                        state=state)
        logits = snn_logits(out, cfg) * 10.0
        rates = out["firing_rates_per_stream"]
        packed = torch.cat([
            torch.argmax(logits, -1).float()[:, None],
            pwm_from_logits(logits), logits,
            torch.stack([rates[k].float() for k in SNN_STATE_LAYERS], 1),
        ], dim=1)
        return packed, out["state"]

    def _build_run(self, key, shard: Optional[_Shard] = None) -> Callable:
        """The step of a shape key ``(batch_size, max_events,
        duration_us)``: ``run((events, state))`` -> ``(packed, *new
        state planes in SNN_STATE_LAYERS order)``, f32 tensors that
        :meth:`_mega_split` takes apart. The same function is captured on
        the card and called on the CPU; given a shard, it runs with the
        shard's weights."""
        duration_us = int(key[2])
        params = self.params if shard is None else shard.weights

        def run(args):
            events, state = args
            with torch.no_grad():
                packed, new_state = self._run(events, duration_us, state,
                                              params)
            return (packed, *(new_state[k] for k in SNN_STATE_LAYERS))

        return run

    def _inputs(self, key, shard: Optional[_Shard] = None):
        """Fresh static buffers shaped like a step's arguments ``(events,
        state)``, for capture: the whole batch's on the engine's device,
        or a shard's rows on its device."""
        b, n_ev, _ = key
        if shard is not None:
            b //= len(self._shards)
        device = self.device if shard is None else shard.device
        events = torch.zeros((5, b, n_ev), dtype=torch.int32, device=device)
        return events, snn_init_state(self.cfg, b, device=device)

    def warmup(self, shape_keys) -> None:
        """Prepare each shape key before serving: on the card, capture its
        CUDA graph (the eager call before the capture builds the kernels),
        so no window pays for it mid-stream; on the CPU, record it. A key
        is ``(batch_size, max_events[, duration_us])``; the 2-tuple form
        uses the engine's latched ``duration_us``."""
        for key in shape_keys:
            key = tuple(key)
            if len(key) == 2:
                if self.duration_us is None:
                    raise ValueError(
                        "2-tuple shape key needs a latched duration_us; "
                        "pass (batch, max_events, duration_us) or pin "
                        "duration_us at construction")
                key = (*key, self.duration_us)
            if len(key) != 3:
                raise ValueError(
                    f"shape key must be (batch_size, max_events[, "
                    f"duration_us]), got {key}")
            self._prepare(tuple(int(k) for k in key))

    # -- cross-wing megastep adapters ------------------------------------
    # The serving layer's fused megastep (EngineConfig.megastep) captures
    # this wing's run function (``_mega_parts``) NEXT TO the frame wing's
    # in one CUDA graph, so one replay launches both wings' kernels. The
    # run is exactly what this wing's own graph captures, which keeps the
    # fused step's bits.

    def _mega_args(self, batch: ev.PaddedEventBatch, state):
        """The concrete arguments matching :meth:`_mega_parts`'s inputs:
        the batch's event arrays as one (5, B, N) int32 tensor (in a
        pinned staging buffer of the key on the card) and the state
        (``None`` = the cached zero state, as the stateless dispatch)."""
        if state is None:
            state = self._zero_state_for(batch.batch_size)
        return self._events(batch, slice(None), self._graphs,
                            self.device), state

    def _events(self, batch: ev.PaddedEventBatch, rows: slice,
                graphs: GraphCache, device: torch.device) -> torch.Tensor:
        """Slots ``rows`` of the batch's event arrays as one (5, R, N)
        int32 tensor: on the card in the next pinned staging buffer of the
        key in ``graphs``, on the CPU a host tensor."""
        arrays = (batch.x, batch.y, batch.t, batch.p, batch.valid)
        if device.type != "cuda":
            return torch.from_numpy(np.stack(
                [a[rows].astype(np.int32) for a in arrays]))
        events = graphs.staging(self.shape_key(batch),
                                (5, *batch.x[rows].shape), torch.int32)
        host = events.numpy()
        for i, a in enumerate(arrays):
            host[i] = a[rows]
        return events

    def _mega_split(self, out, batch: ev.PaddedEventBatch, state):
        """Split a step's outputs into the ``(pending, new_state)`` pair
        :meth:`infer_dispatch` returns (on the card, views of one fresh
        copy, which no later step writes)."""
        return (batch, out[0]), dict(zip(SNN_STATE_LAYERS, out[1:]))

    def _account(self, num_events: int,
                 rates: Dict[str, float]) -> Dict[str, Any]:
        """Kraken latency/energy for one stream's window (pure float math)."""
        cfg = self.cfg
        t = cfg.time_bins
        sizes = cfg.spatial_sizes()
        vol = lambda s: float(np.prod(sizes[s]))
        layer_in_spikes = (
            float(num_events),                        # into conv1
            rates["conv1"] * vol("conv1") * t,        # into conv2
            rates["conv2"] * vol("conv2") * t,        # into fc1
            rates["fc1"] * vol("fc1") * t,            # into fc2
        )
        acct = self.model.closed_loop(
            events=float(num_events),
            layer_in_spikes=layer_in_spikes,
            layer_fanout=self.fanouts,
            layer_passes=[p.passes for p in self.plans],
        )
        acct["firing_rates"] = dict(rates)
        return acct

    def infer_dispatch(self, batch: ev.PaddedEventBatch, state=None):
        """Queue a padded batch on the device without waiting for it.

        Returns a pending handle for :meth:`infer_collect` -- or, with
        ``state``, ``(pending, new_state)``, where ``new_state`` is a dict
        of device tensors the caller can feed to the next dispatch with no
        host round-trip. On the card the event arrays go up in one copy
        from a pinned staging buffer, so the copy does not wait for
        earlier device work, and the key's graph is replayed (captured
        first if the key was not warmed).
        """
        if self.mesh is not None:
            pending, new_state = self._dispatch_sharded(batch, state)
        else:
            out = self._call(self.shape_key(batch),
                             self._mega_args(batch, state))
            pending, new_state = self._mega_split(out, batch, state)
        return pending if state is None else (pending, new_state)

    def _dispatch_sharded(self, batch: ev.PaddedEventBatch, state):
        """:meth:`infer_dispatch` on a mesh: each shard's event rows go up
        from its own pinned staging buffer, its block of the state (placed
        slot-major first if it is not on the mesh yet) is its state, and
        its graph is replayed on its device. Returns ``((batch, [packed
        per shard]), new sharded state)``."""
        key = self.shape_key(batch)
        _check_slot_divisible(batch.batch_size, self.mesh, "sharded-engine")
        if state is None:
            state = self._zero_state_for(batch.batch_size)
        state = _slot_shard_to_mesh(state, self.mesh)

        def args_of(sh: _Shard, rows: slice):
            return (self._events(batch, rows, sh.graphs, sh.device),
                    {k: a.blocks[sh.pos] for k, a in state.items()})

        outs = self._sharded_call(key, args_of)
        new_state = {k: _from_shards(self.mesh, [o[1 + i] for o in outs])
                     for i, k in enumerate(SNN_STATE_LAYERS)}
        return (batch, [o[0] for o in outs]), new_state

    def infer_collect(self, pending) -> List[Optional[ClosedLoopResult]]:
        """Fetch a dispatched batch's outputs and account each stream.

        The only point that waits for the device: one device-to-host copy,
        or on a mesh one a shard, in slot order.
        """
        batch, packed = pending
        arr = _host_rows(packed)
        c = self.cfg.num_classes
        preds = arr[:, 0].astype(np.int32)
        pwm = arr[:, 1:1 + PWM_CHANNELS]
        logits = arr[:, 1 + PWM_CHANNELS:1 + PWM_CHANNELS + c]
        rates = arr[:, 1 + PWM_CHANNELS + c:]

        results: List[Optional[ClosedLoopResult]] = []
        for b in range(batch.batch_size):
            if not batch.occupied[b]:
                results.append(None)
                continue
            # A real-but-quiet window (zero events) is still occupied and
            # gets a result; only window=None slots yield None.
            n_ev = int(batch.num_events[b])
            acct = self._account(
                n_ev, {k: float(rates[b, i])
                       for i, k in enumerate(SNN_STATE_LAYERS)})
            latency = float(acct["total_time_ms"])
            # Double-buffered acquisition: the sustained period is
            # max(window period, preprocessing + inference).
            proc_ms = (acct["stages"]["preprocessing"]["time_ms"]
                       + acct["stages"]["snn_inference"]["time_ms"])
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
        """Host-serializable copy of one slot's carried state."""
        return export_state_slot(state, slot)

    def import_state(self, state, slot: int, payload):
        """Splice an exported carry back into row ``slot``."""
        return import_state_slot(state, slot, payload)

    def infer(self, batch: ev.PaddedEventBatch, state=None):
        """Dispatch + collect back to back. With ``state`` returns
        ``(results, new_state)``; without it, the results of a run from
        the zero state."""
        if state is None:
            return self.infer_collect(self.infer_dispatch(batch))
        pending, new_state = self.infer_dispatch(batch, state)
        return self.infer_collect(pending), new_state

    def infer_windows(self, windows: Sequence[Optional[ev.EventWindow]],
                      *, max_events: Optional[int] = None,
                      batch_size: Optional[int] = None,
                      duration_us: Optional[int] = None,
                      ) -> List[Optional[ClosedLoopResult]]:
        """Convenience: pad a window list and run it as one batch."""
        if not windows and not batch_size:
            return []
        if max_events is None:
            counts = [w.num_events for w in windows if w is not None]
            max_events = ev.next_pow2(max(counts) if counts else 1)
        batch = ev.pad_event_windows(
            windows, max_events=max_events, batch_size=batch_size,
            duration_us=duration_us)
        return self.infer(batch)


class ClosedLoopPipeline:
    """The paper's single-window loop: a B=1 view of the batched engine.

    Event counts are padded to power-of-two buckets (padding never changes
    a result; voxel sums are exact).
    """

    def __init__(
        self,
        params,
        cfg: SNNConfig,
        *,
        model: Optional[KrakenModel] = None,
        window_ms: float = 300.0,
        device=None,
    ):
        self.batched = BatchedClosedLoop(
            params, cfg, model=model, window_ms=window_ms, device=device)

    params = property(lambda self: self.batched.params)
    cfg = property(lambda self: self.batched.cfg)
    model = property(lambda self: self.batched.model)
    window_ms = property(lambda self: self.batched.window_ms)
    plans = property(lambda self: self.batched.plans)
    fanouts = property(lambda self: self.batched.fanouts)

    def __call__(self, window: ev.EventWindow) -> ClosedLoopResult:
        return self.batched.infer_windows([window])[0]
