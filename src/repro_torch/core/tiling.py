"""Capacity-constrained tiled execution planning -- SNE's TDM mode on TPU.

Paper, Sec. III: "neural networks that exceed SNE's output neuron capacity
are executed on the accelerator in a tiled way, and the SNE is used in a
time-domain-multiplexing fashion. The preprocessing step performed on the
cluster is necessary to assemble a single input event stream from multiple
output tiles and create the tiled input streams for the tiles of the
successive layer."

The transferable mechanism is: *given a fixed on-engine capacity, split a
layer's output neurons into tiles that fit, execute tiles sequentially
(time-multiplexed), and re-assemble the output stream between layers*.

On TPU the capacity constraint is VMEM bytes instead of SNE's output-neuron
count. The same planner drives both:

  * the SNE-faithful path (``capacity_kind='neurons'``, SNE's 8192-neuron
    engine) used by the closed-loop pipeline's latency model, and
  * the Pallas ``lif_scan`` kernel's BlockSpec chooser
    (``capacity_kind='vmem_bytes'``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

__all__ = ["TilePlan", "plan_layer_tiles", "plan_network", "SNE_NEURON_CAPACITY"]

# SNE engine capacity (Di Mauro et al. 2022: 8 slices x 1024 neurons).
SNE_NEURON_CAPACITY = 8192


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Tiling of one layer's output volume (H, W, C) into engine passes."""

    layer: str
    shape: Tuple[int, int, int]          # output (H, W, C)
    tile: Tuple[int, int, int]           # per-pass tile (h, w, c)
    grid: Tuple[int, int, int]           # number of tiles per dim
    passes: int                          # total sequential engine passes
    neurons_per_pass: int
    utilization: float                   # neurons_per_pass / capacity

    @property
    def tiled(self) -> bool:
        return self.passes > 1


def _split(n: int, max_piece: int) -> Tuple[int, int]:
    """Split extent n into ceil(n/p) pieces of size p <= max_piece, p | tiles
    chosen to minimize waste."""
    pieces = math.ceil(n / max_piece)
    piece = math.ceil(n / pieces)
    return piece, pieces


def plan_layer_tiles(
    layer: str,
    shape: Tuple[int, int, int],
    capacity: int = SNE_NEURON_CAPACITY,
    *,
    bytes_per_neuron: int = 1,
    capacity_kind: str = "neurons",
) -> TilePlan:
    """Plan the TDM tiling of one layer.

    Channel-first splitting (SNE maps output feature maps to slices), then
    spatial if a single channel plane still exceeds capacity.

    Args:
      shape: (H, W, C) output volume.
      capacity: neuron count (``capacity_kind='neurons'``) or VMEM byte
        budget (``'vmem_bytes'``, divided by ``bytes_per_neuron``).
    """
    h, w, c = shape
    cap = capacity if capacity_kind == "neurons" else capacity // bytes_per_neuron
    if cap <= 0:
        raise ValueError("capacity too small")

    plane = h * w
    if plane * c <= cap:
        tile, grid = (h, w, c), (1, 1, 1)
    elif plane <= cap:
        cmax = cap // plane
        cpiece, cgrid = _split(c, cmax)
        tile, grid = (h, w, cpiece), (1, 1, cgrid)
    else:
        # Split a single channel spatially (rows first, then columns).
        hmax = max(cap // w, 1)
        hpiece, hgrid = _split(h, hmax)
        if hpiece * w <= cap:
            tile, grid = (hpiece, w, 1), (hgrid, 1, c)
        else:
            wpiece, wgrid = _split(w, max(cap, 1))
            tile, grid = (1, wpiece, 1), (h, wgrid, c)

    passes = grid[0] * grid[1] * grid[2]
    neurons = tile[0] * tile[1] * tile[2]
    return TilePlan(
        layer=layer, shape=shape, tile=tile, grid=grid, passes=passes,
        neurons_per_pass=neurons, utilization=neurons / cap,
    )


def plan_network(
    layer_shapes: Sequence[Tuple[str, Tuple[int, int, int]]],
    capacity: int = SNE_NEURON_CAPACITY,
    **kw,
) -> List[TilePlan]:
    """Plan every layer of a network; list order == execution order."""
    return [plan_layer_tiles(name, shape, capacity, **kw)
            for name, shape in layer_shapes]
