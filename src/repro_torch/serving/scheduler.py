"""Batched request scheduler: fixed-slot batching of LM requests (port of
``repro.serving.scheduler``).

Requests queue up; a fixed number of batch slots decode in lock-step (one
``Model.decode`` call for the whole batch); when every member of a batch
is done, the queue refills the next batch. Prompts are left-aligned and
padded with token 0, which drives the empty slots.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import Model

__all__ = ["Request", "BatchScheduler"]


@dataclasses.dataclass
class Request:
    id: int
    prompt: np.ndarray                 # (P,) int token ids
    max_new_tokens: int = 16
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class BatchScheduler:
    """Lock-step decode over ``max_batch`` slots with refill, on
    ``device`` (the card by default), where ``params`` must lie."""

    def __init__(self, model: Model, params: Any, *, max_batch: int = 4,
                 cache_len: int = 128, device=None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.device = resolve_device(device)
        self.stats: Dict[str, float] = {"batches": 0, "decode_steps": 0,
                                        "tokens": 0, "wall_s": 0.0}

    def _fresh_cache(self):
        return self.model.init_cache(self.max_batch, self.cache_len,
                                     device=self.device)

    def run(self, requests: List[Request]) -> List[Request]:
        """Serve all requests; returns them with ``output`` filled.

        Slots advance in lock-step (shared ``pos``), so a batch drains
        when all its members finish; the queue refills the next batch.
        """
        t0 = time.perf_counter()
        queue = list(requests)
        finished: List[Request] = []
        while queue:
            batch = queue[:self.max_batch]
            queue = queue[self.max_batch:]
            self._run_batch(batch)
            finished.extend(batch)
            self.stats["batches"] += 1
        self.stats["wall_s"] = time.perf_counter() - t0
        return finished

    def _step(self, cache, toks: np.ndarray):
        logits, cache = self.model.decode(
            self.params, cache, torch.from_numpy(toks).to(self.device))
        self.stats["decode_steps"] += 1
        nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
        return nxt.cpu().numpy()[:, None], cache

    def _run_batch(self, batch: List[Request]):
        b = self.max_batch
        cache = self._fresh_cache()
        max_prompt = max(len(r.prompt) for r in batch)
        max_new = max(r.max_new_tokens for r in batch)
        # left-align prompts; pad short ones with token 0
        toks = np.zeros((b, max_prompt), np.int64)
        for i, r in enumerate(batch):
            toks[i, :len(r.prompt)] = r.prompt
        nxt = None
        for i in range(max_prompt):
            nxt, cache = self._step(cache, toks[:, i:i + 1])
        for _ in range(max_new):
            for i, r in enumerate(batch):
                if not r.done and len(r.output) < r.max_new_tokens:
                    r.output.append(int(nxt[i, 0]))
                    self.stats["tokens"] += 1
                    if len(r.output) >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in batch):
                break
            nxt, cache = self._step(cache, nxt.astype(np.int64))
