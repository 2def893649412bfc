"""One captured CUDA graph per shape key: the port's counterpart of the JAX
package's AOT executable cache (``BatchedClosedLoop._executable``,
``FrameTCNEngine._executable`` and the serving layer's megastep cache).

An engine describes the step of a shape key as ``(run, inputs)``: ``run``
maps a tree (tuples, dicts) of device tensors shaped like ``inputs`` to a
tuple tree of tensors of one dtype, and ``inputs`` are static device
buffers made for the key. On the card, :class:`GraphCache` captures
``run(inputs)`` once per key and serves each later call by copying the
call's arguments into ``inputs`` and replaying the graph, so one replay
launches all of a step's kernels. On the CPU it holds nothing and records
the keys it was asked for; the engine then calls ``run`` on the arguments
themselves.

A replay overwrites the graph's static outputs, so :meth:`CapturedStep.__call__`
hands back copies: a caller may hold a step's result (a pipelined pending
readout, a parked carry) while later steps replay the same graph. The
graph ends by gathering its outputs into one flat buffer, so the copy is
one operation and the results are views of it.

The kernel wrappers count their launches when Python calls them, which a
replay does not. Each captured step keeps the tally of the launches it
captured and adds it to the wrappers' counters on every replay; the
capture itself queues nothing that runs, so it leaves the counters as it
found them.
"""
from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import fc_lif_scan, lif_scan, ternary_matmul, \
    wkv6_scan

__all__ = ["CapturedStep", "GraphCache", "HostStaging", "capture", "load",
           "launch_counts"]

# Every kernel launch counter: (module, attribute).
_COUNTERS = ((lif_scan, "launches"), (fc_lif_scan, "launches"),
             (fc_lif_scan, "currents_launches"),
             (ternary_matmul, "launches"), (wkv6_scan, "launches"))


def launch_counts() -> Tuple[int, ...]:
    """The kernel launch counters, in a fixed order."""
    return tuple(getattr(m, a) for m, a in _COUNTERS)


def _set_counts(counts: Sequence[int]) -> None:
    for (m, a), n in zip(_COUNTERS, counts):
        setattr(m, a, n)


def load(static, args) -> None:
    """Copy ``args`` into ``static``, two trees of tensors of one structure
    (tuples, lists, dicts by key), on the current stream."""
    if isinstance(static, torch.Tensor):
        static.copy_(args, non_blocking=True)
    elif isinstance(static, dict):
        for k, v in static.items():
            load(v, args[k])
    else:
        for s, a in zip(static, args, strict=True):
            load(s, a)


def _leaves(tree) -> list:
    """The tensors of a tuple tree, depth first."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for sub in tree for t in _leaves(sub)]


def _rebuild(tree, leaves):
    """``tree``'s structure with its tensors taken in turn from the
    iterator ``leaves``."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    return tuple(_rebuild(sub, leaves) for sub in tree)


class CapturedStep:
    """One shape key's captured step: its static inputs, the graph, its
    outputs (a tuple tree, gathered in the flat static buffer ``flat``),
    the launch tally of each kernel counter, the capture's wall time and
    the bytes its memory pool grew by."""

    def __init__(self, inputs, graph: torch.cuda.CUDAGraph, outputs,
                 flat: torch.Tensor, tally: Tuple[int, ...],
                 capture_ms: float, pool_bytes: int):
        self.inputs = inputs
        self.graph = graph
        self.outputs = outputs
        self.flat = flat
        self.tally = tally
        self.capture_ms = capture_ms
        self.pool_bytes = pool_bytes

    def __call__(self, args):
        """Load ``args``, replay, and return the outputs as views of one
        copy of the flat buffer (fresh memory, which later replays never
        touch)."""
        load(self.inputs, args)
        self.graph.replay()
        _set_counts([n + t for n, t in zip(launch_counts(), self.tally)])
        fresh = self.flat.clone()
        views, at = [], 0
        for t in _leaves(self.outputs):
            views.append(fresh[at:at + t.numel()].view(t.shape))
            at += t.numel()
        return _rebuild(self.outputs, iter(views))


def capture(run: Callable, inputs, pool=None) -> CapturedStep:
    """Capture ``run(inputs)`` in a CUDA graph on the current device,
    after one eager call on a side stream that builds the kernels, sets
    their attributes and lets cuDNN pick its algorithms outside the
    capture. A failure raises: there is no eager path behind a capture.

    The garbage collector is held off for the capture. A dead engine is
    cyclic garbage (its stream handles point back at it) that only a
    collector pass frees, and freeing its graphs, events and pinned
    buffers inside a capture invalidates the capture. (A collection at
    every capture instead would cost each resize or rebuild a pass over
    the whole heap.)"""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(inputs)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    # torch.cuda.graph empties the allocator's cache on entry; do it first
    # so that the reserved bytes grow by the graph's pool alone.
    torch.cuda.empty_cache()
    before = launch_counts()
    reserved = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    # The capture stream is the current device's own: torch.cuda.graph's
    # default is one process-wide stream made on whichever device was
    # current at the first capture, and a shard's step of another device
    # captured on it failed to capture or replayed wrong rows (four
    # H100s).
    stream = torch.cuda.Stream()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool, stream=stream):
            outputs = run(inputs)
            leaves = _leaves(outputs)
            if len({t.dtype for t in leaves}) != 1:
                raise TypeError(f"a captured step's outputs must share one "
                                f"dtype, got {[t.dtype for t in leaves]}")
            flat = torch.cat([t.reshape(-1) for t in leaves])
    finally:
        if collecting:
            gc.enable()
    capture_ms = (time.perf_counter() - t0) * 1e3
    tally = tuple(a - b for a, b in zip(launch_counts(), before))
    _set_counts(before)
    return CapturedStep(inputs, graph, outputs, flat, tally, capture_ms,
                        torch.cuda.memory_reserved() - reserved)


class GraphCache:
    """One :class:`CapturedStep` per key on a CUDA ``device``; on the CPU,
    only the keys. A mesh-attached engine keeps one cache per shard (two
    shards on one device still have two caches, pools and sets of staging
    buffers); a capture or a staging buffer's turn runs with the cache's
    device current, and a replay is the caller's to run there.

    The graphs of one cache share one memory pool, so an engine that sees
    several event-count buckets holds one step's intermediates, not one
    per key. That is safe because a cache's graphs replay one at a time on
    the current stream and never overlap, and each replay's output is
    copied out before the next replay is queued; the static inputs and
    outputs of every graph stay referenced here, so no capture reuses
    them.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.steps: Dict[Hashable, CapturedStep] = {}
        self._seen: set = set()
        self._pool = None
        self._staging: Dict[Hashable, HostStaging] = {}

    def keys(self) -> set:
        """Keys with a graph (card), or warmed or served (CPU)."""
        return set(self.steps) if self.device.type == "cuda" \
            else set(self._seen)

    def get(self, key: Hashable, parts: Callable[[], tuple]
            ) -> Optional[CapturedStep]:
        """The key's captured step, captured from ``parts()`` = ``(run,
        inputs)`` on first use; ``None`` on the CPU."""
        if self.device.type != "cuda":
            self._seen.add(key)
            return None
        step = self.steps.get(key)
        if step is None:
            with torch.cuda.device(self.device):
                if self._pool is None:
                    self._pool = torch.cuda.graph_pool_handle()
                step = self.steps[key] = capture(*parts(), pool=self._pool)
        return step

    def staging(self, key: Hashable, shape: Tuple[int, ...],
                dtype: torch.dtype) -> torch.Tensor:
        """The next pinned host buffer of the key's inputs (card only),
        free to write."""
        stage = self._staging.get(key)
        if stage is None:
            stage = self._staging[key] = HostStaging(shape, dtype)
        with torch.cuda.device(self.device):
            return stage.next()


class HostStaging:
    """Pinned host buffers for one key's inputs, used in turn.

    The copy to the device reads a buffer after the host has moved on, so
    a buffer is written again only once the copy that read it has run: an
    event is recorded on the current stream when the next buffer is taken
    (after the previous call queued its copy) and waited on before the
    buffer comes round again. With two buffers a pipelined engine one step
    deep never waits.
    """

    TURNS = 2

    def __init__(self, shape: Tuple[int, ...], dtype: torch.dtype):
        self._bufs = [torch.empty(shape, dtype=dtype, pin_memory=True)
                      for _ in range(self.TURNS)]
        self._done = [torch.cuda.Event() for _ in range(self.TURNS)]
        self._i = -1

    def next(self) -> torch.Tensor:
        """The next buffer, free to write."""
        if self._i >= 0:
            self._done[self._i].record()
        self._i = (self._i + 1) % self.TURNS
        self._done[self._i].synchronize()
        return self._bufs[self._i]
