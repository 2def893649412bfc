"""Deterministic fault injection for the serving/fleet stack.

Port of ``repro.fleet.faults`` (numpy and plain Python: the same seed
draws the same numbers in both packages, so one seed scripts a JAX engine
and a port engine the same way).

Fault tolerance that cannot be rehearsed is folklore. This module makes
every failure mode the recovery layer handles *replayable*: a seeded
:class:`FaultInjector` wraps any
:class:`~repro_torch.core.engine.InferenceEngine` in a
:class:`FaultyEngine` proxy that can, on a deterministic schedule,

  * raise :class:`InjectedFault` from the engine step (``infer`` /
    ``infer_collect``) or from host packing (``prepare``) -- exercising
    the engine's bounded retry and lane-death paths,
  * poison one occupied slot's logits with NaN -- exercising the
    non-finite quarantine path,
  * stall a call for ``stall_ms`` wall milliseconds -- a straggler, not
    a failure (the engine is oblivious; only wall-clock metrics move).

Determinism contract: the injector draws from one
``np.random.default_rng(seed)`` in strict call order -- a fixed number
of draws per decision point regardless of which fault (if any) fires --
so the same seed against the same call sequence replays the same fault
schedule bit-for-bit. Scripted faults (:meth:`FaultInjector.fail_next`,
:meth:`FaultInjector.kill`) consume no randomness and take precedence
over the rates, so tests can pin "the next frame collect fails" exactly.

The proxy is transparent to the engine protocol: attribute reads and
writes delegate to the wrapped engine (``duration_us`` latching included)
and the async split (``infer_dispatch``/``infer_collect``) is exposed
only when the inner engine has it, so ``StreamEngine``'s
``getattr(engine, "infer_dispatch", None)`` capability probe is
preserved.

Typical wiring::

    inj = FaultInjector(FaultConfig(seed=7, step_error_rate=0.05))
    eng = StreamEngine(engines=[inj.wrap(event_engine)],
                       config=EngineConfig(recovery=RecoveryConfig()))
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core._api import FaultConfig

__all__ = ["FaultConfig", "FaultInjector", "FaultyEngine",
           "InjectedFault", "LaneStall"]

_KINDS = ("error", "nan", "stall")


class InjectedFault(RuntimeError):
    """Raised by a :class:`FaultyEngine` when an error fault fires."""


class LaneStall(InjectedFault):
    """An injected stall escalated to a failure (scripted use only)."""


class FaultInjector:
    """Seeded source of fault decisions shared by all wrapped engines.

    ``counters`` tracks what actually fired: ``calls`` (decision
    points), ``errors``, ``nans``, ``stalls``, ``scripted``.
    """

    def __init__(self, config: Optional[FaultConfig] = None):
        if config is None:
            config = FaultConfig()
        if not isinstance(config, FaultConfig):
            raise TypeError(
                f"config must be a FaultConfig, got "
                f"{type(config).__name__}")
        self.config = config
        self._rng = np.random.default_rng(config.seed)
        self._scripted: Deque[Tuple[Optional[str], str, str]] = deque()
        self._killed: set = set()
        self.counters: Dict[str, int] = {
            "calls": 0, "errors": 0, "nans": 0, "stalls": 0,
            "scripted": 0}

    # -- scripted faults (deterministic, no randomness consumed) ---------

    def fail_next(self, modality: Optional[str] = None, *,
                  kind: str = "error", count: int = 1,
                  site: str = "step") -> None:
        """Queue ``count`` scripted faults of ``kind`` for the next
        matching decision points (``modality=None`` matches any lane).
        ``site="step"`` fires at the engine step (``infer`` for sync
        engines, ``infer_collect`` for split engines); ``site="prepare"``
        fires at host packing (``kind`` must be ``"error"`` there)."""
        if kind not in _KINDS:
            raise ValueError(f"kind must be one of {_KINDS}, got {kind!r}")
        if site not in ("step", "prepare"):
            raise ValueError(
                f"site must be 'step' or 'prepare', got {site!r}")
        if site == "prepare" and kind != "error":
            raise ValueError("host packing faults are errors only")
        if count < 1:
            raise ValueError(f"count must be >= 1, got {count}")
        for _ in range(count):
            self._scripted.append((modality, kind, site))

    def kill(self, modality: str) -> None:
        """Every engine call on ``modality`` raises until :meth:`revive`
        -- drives the lane's fail streak past ``dead_after``."""
        self._killed.add(modality)

    def revive(self, modality: str) -> None:
        self._killed.discard(modality)

    def killed(self, modality: str) -> bool:
        return modality in self._killed

    # -- engine wiring ---------------------------------------------------

    def wrap(self, engine: Any) -> "FaultyEngine":
        """Wrap ``engine`` in a fault-injecting proxy bound to this
        injector's seed, schedule, and counters."""
        return FaultyEngine(engine, self)

    # -- decision machinery ----------------------------------------------

    def _pop_scripted(self, modality: str,
                      site: str = "step") -> Optional[str]:
        for i, (mod, kind, at) in enumerate(self._scripted):
            if at == site and (mod is None or mod == modality):
                del self._scripted[i]
                self.counters["scripted"] += 1
                return kind
        return None

    def _decide(self, modality: str) -> Optional[str]:
        """One decision point. Raises :class:`InjectedFault` for error
        faults; returns ``"nan"``/``"stall"``/``None`` otherwise. Always
        draws exactly three uniforms when rates apply, so the stream of
        randomness is a pure function of the call sequence."""
        cfg = self.config
        if cfg.modalities is not None and modality not in cfg.modalities:
            return None
        self.counters["calls"] += 1
        if modality in self._killed:
            self.counters["errors"] += 1
            raise InjectedFault(f"injected: {modality} lane killed")
        action = self._pop_scripted(modality)
        if action is None:
            draws = self._rng.random(3)
            if draws[0] < cfg.step_error_rate:
                action = "error"
            elif draws[1] < cfg.nan_rate:
                action = "nan"
            elif draws[2] < cfg.stall_rate:
                action = "stall"
        if action == "error":
            self.counters["errors"] += 1
            raise InjectedFault(f"injected: {modality} step error")
        return action

    def _apply_stall(self) -> None:
        self.counters["stalls"] += 1
        if self.config.stall_ms > 0:
            time.sleep(self.config.stall_ms / 1e3)

    def _poison(self, results: Sequence[Any]) -> List[Any]:
        """Replace one occupied slot's logits with NaN (rng-chosen among
        occupied slots; one extra draw, only when a nan fault fired)."""
        occ = [i for i, r in enumerate(results)
               if r is not None and getattr(r, "logits", None) is not None]
        if not occ:
            return list(results)
        slot = occ[int(self._rng.integers(len(occ)))]
        out = list(results)
        res = out[slot]
        logits = np.asarray(res.logits)
        out[slot] = dataclasses.replace(
            res, logits=np.full(logits.shape, np.nan, dtype=logits.dtype))
        self.counters["nans"] += 1
        return out


class FaultyEngine:
    """Transparent engine proxy that routes calls through a
    :class:`FaultInjector`. All attributes delegate to the inner engine;
    only the call sites below are intercepted."""

    def __init__(self, inner: Any, injector: FaultInjector):
        object.__setattr__(self, "_inner", inner)
        object.__setattr__(self, "_injector", injector)

    # -- transparent delegation -----------------------------------------

    def __getattr__(self, name: str) -> Any:
        inner = object.__getattribute__(self, "_inner")
        # Expose the async split only when the inner engine has it, so
        # the StreamEngine capability probe sees the true surface. The
        # bound methods are made per lookup, never stored on the proxy: a
        # stored one would be a reference cycle that keeps a replaced
        # engine's graphs and buffers alive until the next gc pass.
        if name in ("infer_dispatch", "infer_collect") and (
                getattr(inner, "infer_dispatch", None) is not None
                and getattr(inner, "infer_collect", None) is not None):
            return object.__getattribute__(self, "_" + name)
        return getattr(inner, name)

    def __setattr__(self, name: str, value: Any) -> None:
        setattr(object.__getattribute__(self, "_inner"), name, value)

    @property
    def inner(self) -> Any:
        return object.__getattribute__(self, "_inner")

    # -- intercepted call sites -----------------------------------------

    def prepare(self, items, **kw):
        inj: FaultInjector = object.__getattribute__(self, "_injector")
        # Host packing only honors scripted faults: random rates target
        # the device step, keeping the per-step draw count at one
        # decision point for either execution mode (sync or split).
        if inj._pop_scripted(self.inner.modality, "prepare") is not None:
            inj.counters["errors"] += 1
            raise InjectedFault(
                f"injected: {self.inner.modality} host packing error")
        return self.inner.prepare(items, **kw)

    def infer(self, batch, state=None):
        inj: FaultInjector = object.__getattribute__(self, "_injector")
        inner = self.inner
        action = inj._decide(inner.modality)
        if action == "stall":
            inj._apply_stall()
        if state is None:
            results = inner.infer(batch)
            if action == "nan":
                results = inj._poison(results)
            return results
        results, new_state = inner.infer(batch, state)
        if action == "nan":
            results = inj._poison(results)
        return results, new_state

    def _infer_dispatch(self, batch, state=None):
        # Dispatch is fault-free by design: the decision point for a
        # split engine sits at collect, where the engine's recovery
        # layer can retry without having advanced any carry.
        inner = self.inner
        if state is None:
            return inner.infer_dispatch(batch)
        return inner.infer_dispatch(batch, state)

    def _infer_collect(self, pending):
        inj: FaultInjector = object.__getattribute__(self, "_injector")
        inner = self.inner
        action = inj._decide(inner.modality)
        if action == "stall":
            inj._apply_stall()
        results = inner.infer_collect(pending)
        if action == "nan":
            results = inj._poison(results)
        return results
