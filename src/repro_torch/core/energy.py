"""Kraken/ColibriES energy & latency model (paper Tables I and III).

The paper's evaluation axes are energy and latency measured on silicon at
VDD = 0.65 V. Silicon cannot be measured in this container, so we model the
three Kraken power domains with the paper's measured idle/active powers and
workload-proportional stage latencies, calibrated such that the paper's
nominal DVS-Gesture workload (300 ms window) reproduces Table III:

    stage                 time        P_idle   P_active   energy
    Data acquisition (FC)   1.5 ms     3.5 mW    3.8 mW   0.006 mJ
    Preprocessing (cluster) 131  ms    6.5 mW   34   mW   4.6  mJ
    SNN inference (SNE)     32   ms    7.7 mW   44   mW   1.4  mJ
    Total                   164.5 ms  17.7 mW   35.6 mW   7.7  mJ

Latency scaling laws (documented modelling choices):
  * acquisition time  ~ events / uDMA interface rate,
  * preprocessing time ~ sum over layers of (input spikes x engine passes),
    i.e. the cluster re-assembles each layer's input stream once per tile
    pass of SNE's time-domain-multiplexed execution,
  * SNE inference time ~ synaptic operations (events x fanout), SNE being
    energy/latency-proportional to synops (Di Mauro et al. 2022).

Total energy follows the paper's note (b): sum of active-stage energy plus
idle energy of the inactive domains during each stage (sequential stages;
the FC is always on).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Sequence, Tuple

from repro_torch.core.tiling import TilePlan

__all__ = [
    "PowerDomain",
    "KRAKEN_DOMAINS",
    "CUTIE_DOMAIN",
    "FRAME_DOMAINS",
    "StageExecution",
    "pipeline_energy",
    "KrakenModel",
    "NOMINAL",
    "NOMINAL_FRAME",
]


@dataclasses.dataclass(frozen=True)
class PowerDomain:
    name: str
    p_idle_mw: float
    p_active_mw: float


# Paper Table III, VDD = 0.65 V. These three domains are the *event-wing*
# accounting set: the paper's measured pipeline powers FC + cluster + SNE
# (CUTIE is power-gated during the event experiments, so it contributes no
# idle cross-term -- keeping this dict as-is preserves the Table III
# calibration bitwise).
KRAKEN_DOMAINS: Dict[str, PowerDomain] = {
    "fc": PowerDomain("fc", 3.5, 3.8),
    "cluster": PowerDomain("cluster", 6.5, 34.0),
    "sne": PowerDomain("sne", 7.7, 44.0),
}

# Kraken's second accelerator domain. The paper evaluates only the event
# wing ("the first step of full-system evaluation"), so CUTIE's figures are
# extrapolated from the CUTIE silicon results (Scherer et al., 2022: fully
# ternary MACs, ~10x the energy efficiency of the cluster on dense CNNs)
# at the same 0.65 V operating point -- documented modelling, not paper
# measurement.
CUTIE_DOMAIN = PowerDomain("cutie", 1.6, 14.0)

# Frame-wing accounting set: FC + cluster + CUTIE (SNE power-gated), the
# mirror image of the event wing's domain set.
FRAME_DOMAINS: Dict[str, PowerDomain] = {
    "fc": KRAKEN_DOMAINS["fc"],
    "cluster": KRAKEN_DOMAINS["cluster"],
    "cutie": CUTIE_DOMAIN,
}


@dataclasses.dataclass(frozen=True)
class StageExecution:
    """One sequential pipeline stage: ``domain`` active, others idle."""

    name: str
    domain: str
    time_ms: float


def pipeline_energy(
    stages: Sequence[StageExecution],
    domains: Mapping[str, PowerDomain] = KRAKEN_DOMAINS,
) -> Dict[str, object]:
    """Energy accounting per the paper's Table III conventions.

    Returns a dict with per-stage active energy, total time, total energy
    (active + idle-of-inactive), idle power, and average power.
    """
    total_ms = sum(s.time_ms for s in stages)
    per_stage = {}
    active_mj = 0.0
    idle_mj = 0.0
    for s in stages:
        act = domains[s.domain].p_active_mw * s.time_ms * 1e-3
        per_stage[s.name] = {
            "time_ms": s.time_ms,
            "active_energy_mj": act,
            "domain": s.domain,
        }
        active_mj += act
        for d in domains.values():
            if d.name != s.domain:
                idle_mj += d.p_idle_mw * s.time_ms * 1e-3
    total_mj = active_mj + idle_mj
    return {
        "stages": per_stage,
        "total_time_ms": total_ms,
        "active_energy_mj": active_mj,
        "idle_energy_mj": idle_mj,
        "total_energy_mj": total_mj,
        "p_idle_mw": sum(d.p_idle_mw for d in domains.values()),
        "p_avg_mw": total_mj / (total_ms * 1e-3) if total_ms else 0.0,
        # Paper Table III note (c) "average total power consumption during
        # inference" = time-weighted mean of the ACTIVE domains' power
        # (35.6 mW for the nominal workload; idle cross-terms excluded).
        "p_avg_active_mw": (active_mj / (total_ms * 1e-3)
                            if total_ms else 0.0),
    }


# ----------------------------------------------------------------------
# Workload -> latency calibration.
#
# Nominal paper workload (300 ms DVS-Gesture window). Event count per
# window is not printed in the paper; 60k events/window (200 kev/s) is the
# DVS-Gesture per-sample average reported by Amir et al. (2017) order of
# magnitude. All three rate constants below are solved so that the nominal
# workload reproduces Table III latencies exactly; other workloads scale
# linearly in their inputs (events, spike x pass traffic, synops).
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NominalWorkload:
    window_ms: float = 300.0
    events: float = 60_000.0
    # Per-layer input spike counts per window for the Table II net at the
    # firing rates our trained SNN exhibits (~5% conv, ~10% fc), plus each
    # layer's engine passes from the tiling planner (conv1 runs in 2 passes:
    # 32*32*16 = 16384 neurons > 8192 capacity).
    layer_in_spikes: Tuple[float, ...] = (60_000.0, 13_107.0, 3_277.0, 819.0)
    layer_passes: Tuple[int, ...] = (2, 1, 1, 1)
    layer_fanout: Tuple[float, ...] = (144.0, 288.0, 512.0, 11.0)
    # Table III targets.
    t_acq_ms: float = 1.5
    t_pre_ms: float = 131.0
    t_sne_ms: float = 32.0

    @property
    def pre_traffic(self) -> float:
        return sum(s * p for s, p in zip(self.layer_in_spikes,
                                         self.layer_passes))

    @property
    def synops(self) -> float:
        return sum(s * f for s, f in zip(self.layer_in_spikes,
                                         self.layer_fanout))


NOMINAL = NominalWorkload()


@dataclasses.dataclass(frozen=True)
class NominalFrameWorkload:
    """Calibration point for the frame wing (modelled, see CUTIE_DOMAIN).

    A 128x128 grayscale frame through the CUTIE-sized TCN: acquisition
    over the parallel camera interface + uDMA, cluster normalization of
    the pixel buffer, then CUTIE's fixed dense schedule. CUTIE latency is
    workload-independent (dense MACs every frame); only switching energy
    varies with operand activity.
    """

    window_ms: float = 300.0
    pixels: float = 128.0 * 128.0
    # Dense MACs of the mirror TCN on a 128x128 input (conv1 147456 +
    # conv2 1179648 + fc1 1048576 + fc2 5632), the calibration anchor.
    macs: float = 2_381_312.0
    t_acq_ms: float = 0.6       # frame DMA (parallel IF is faster than DVS)
    t_pre_ms: float = 9.0       # cluster pixel normalization + packing
    t_cutie_ms: float = 2.2     # CUTIE dense schedule


NOMINAL_FRAME = NominalFrameWorkload()


class KrakenModel:
    """Calibrated latency/energy model of the ColibriES pipeline.

    ``closed_loop`` accounts the event wing (FC + cluster + SNE, paper
    Table III); ``frame_loop`` accounts the frame wing (FC + cluster +
    CUTIE, modelled -- see :data:`CUTIE_DOMAIN`). One instance serves both
    engines of the heterogeneous platform.
    """

    def __init__(self, nominal: NominalWorkload = NOMINAL,
                 nominal_frame: NominalFrameWorkload = NOMINAL_FRAME):
        self.nominal = nominal
        # Solve rate constants against Table III.
        self.acq_events_per_ms = nominal.events / nominal.t_acq_ms
        self.pre_traffic_per_ms = nominal.pre_traffic / nominal.t_pre_ms
        self.sne_synops_per_ms = nominal.synops / nominal.t_sne_ms
        # Frame-wing rate constants (same linear-scaling convention).
        self.nominal_frame = nominal_frame
        self.acq_pixels_per_ms = nominal_frame.pixels / nominal_frame.t_acq_ms
        self.pre_pixels_per_ms = nominal_frame.pixels / nominal_frame.t_pre_ms
        self.cutie_macs_per_ms = nominal_frame.macs / nominal_frame.t_cutie_ms

    # -- stage latencies -------------------------------------------------
    def t_acquisition_ms(self, events: float) -> float:
        return events / self.acq_events_per_ms

    def t_preprocess_ms(
        self,
        layer_in_spikes: Sequence[float],
        plans: Sequence[TilePlan] | None = None,
        layer_passes: Sequence[int] | None = None,
    ) -> float:
        if layer_passes is None:
            if plans is None:
                raise ValueError("need plans or layer_passes")
            layer_passes = [p.passes for p in plans]
        traffic = sum(s * p for s, p in zip(layer_in_spikes, layer_passes))
        return traffic / self.pre_traffic_per_ms

    def t_sne_ms(
        self,
        layer_in_spikes: Sequence[float],
        layer_fanout: Sequence[float],
    ) -> float:
        synops = sum(s * f for s, f in zip(layer_in_spikes, layer_fanout))
        return synops / self.sne_synops_per_ms

    # -- end-to-end ------------------------------------------------------
    def closed_loop(
        self,
        events: float,
        layer_in_spikes: Sequence[float],
        layer_fanout: Sequence[float],
        layer_passes: Sequence[int],
    ) -> Dict[str, object]:
        """Full acquisition -> preprocessing -> inference -> actuation loop.

        Actuation (PWM update) is < 1 us per the paper and accounted as
        zero-time (paper: "negligible compared to data acquisition and
        processing").
        """
        stages = [
            StageExecution("data_acquisition", "fc",
                           self.t_acquisition_ms(events)),
            StageExecution("preprocessing", "cluster",
                           self.t_preprocess_ms(layer_in_spikes,
                                                layer_passes=layer_passes)),
            StageExecution("snn_inference", "sne",
                           self.t_sne_ms(layer_in_spikes, layer_fanout)),
        ]
        out = pipeline_energy(stages)
        out["actuation_latency_us"] = 1.0  # upper bound per paper Sec. III
        return out

    def frame_loop(
        self,
        pixels: float,
        macs: float,
        activity: float = 1.0,
    ) -> Dict[str, object]:
        """Frame-wing loop: acquire -> normalize -> CUTIE infer -> actuate.

        Args:
          pixels: frame pixel count (drives acquisition + preprocessing).
          macs: dense MAC count of the TCN (drives CUTIE latency).
          activity: mean non-zero operand density in [0, 1]; CUTIE's
            switching energy scales with operand activity (Scherer et al.,
            2022), modelled as interpolating the active power between the
            domain's idle floor and its full-activity ceiling.
        """
        activity = min(max(float(activity), 0.0), 1.0)
        cutie = FRAME_DOMAINS["cutie"]
        domains = dict(FRAME_DOMAINS)
        domains["cutie"] = PowerDomain(
            cutie.name, cutie.p_idle_mw,
            cutie.p_idle_mw
            + (cutie.p_active_mw - cutie.p_idle_mw) * activity)
        stages = [
            StageExecution("data_acquisition", "fc",
                           pixels / self.acq_pixels_per_ms),
            StageExecution("preprocessing", "cluster",
                           pixels / self.pre_pixels_per_ms),
            StageExecution("tcn_inference", "cutie",
                           macs / self.cutie_macs_per_ms),
        ]
        out = pipeline_energy(stages, domains)
        out["actuation_latency_us"] = 1.0
        out["cutie_activity"] = activity
        return out
