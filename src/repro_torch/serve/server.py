"""Batched serving: continuous-batching decode over a fixed-size KV cache.

The counterpart of the JAX package's ``repro.serve.server``, with the
same behaviour step for step: request queue -> slot allocator -> prefill
(per request, one token at a time through the batched decode, token 0 in
every other slot) -> batched decode steps.  Slots map onto the batch
dimension of one shared cache with one shared write index; finished
requests free their slot for the next queued prompt (continuous
batching).  Greedy decoding takes ``np.argmax`` of the host float32
logits (the first index on ties); sampling at a temperature draws from a
numpy ``default_rng(seed)``.  Any family of the registry is served: the
cache is ``api.init_cache``'s, so a vlm server's image embeddings
(``img``) and an audio server's encoder output (``enc``) stay at zero,
as the JAX package's ``Server`` leaves them.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (P,) int32
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class Server:
    """Runs on ``device`` (default ``cuda``; raises without a GPU), where
    ``params`` must already be."""

    def __init__(self, cfg: ModelConfig, params, *, slots: int = 4,
                 cache_len: int = 256, temperature: float = 0.0,
                 seed: int = 0, device=None):
        self.cfg = cfg
        self.params = params
        self.slots = slots
        self.cache_len = cache_len
        self.temperature = temperature
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)
        self.cache = api.init_cache(cfg, slots, cache_len, self.device)
        self.active: List[Optional[Request]] = [None] * slots
        self.queue: List[Request] = []
        self._all: List[Request] = []

    def _decode(self, toks: np.ndarray) -> torch.Tensor:
        logits, self.cache = api.decode_step(
            self.cfg, self.params, self.cache,
            torch.from_numpy(toks).to(self.device), device=self.device)
        return logits

    def submit(self, req: Request) -> None:
        self.queue.append(req)
        self._all.append(req)

    def _admit(self) -> None:
        for i in range(self.slots):
            if self.active[i] is None and self.queue:
                req = self.queue.pop(0)
                self.active[i] = req
                # per-slot prefill: feed prompt tokens one step at a time
                for tok in req.prompt[:-1]:
                    t = np.zeros((self.slots, 1), np.int32)
                    t[i, 0] = tok
                    self._decode(t)
                req._next = int(req.prompt[-1])

    def step(self) -> None:
        """One batched decode step for all active slots."""
        self._admit()
        if not any(self.active):
            return
        toks = np.zeros((self.slots, 1), np.int32)
        for i, req in enumerate(self.active):
            if req is not None:
                toks[i, 0] = getattr(req, "_next", 0)
        logits = self._decode(toks).float().cpu().numpy()
        for i, req in enumerate(self.active):
            if req is None:
                continue
            if self.temperature > 0:
                z = logits[i] / self.temperature
                z = z - z.max()
                prob = np.exp(z) / np.exp(z).sum()
                nxt = int(self.rng.choice(len(prob), p=prob))
            else:
                nxt = int(np.argmax(logits[i]))
            req.out.append(nxt)
            req._next = nxt
            if len(req.out) >= req.max_new:
                req.done = True
                self.active[i] = None   # free slot (continuous batching)

    def run_until_drained(self, max_steps: int = 10_000) -> List[Request]:
        for _ in range(max_steps):
            self.step()
            if not self.queue and not any(self.active):
                break
        return [r for r in self._all if r.done]
