"""Data pipeline: deterministic, resumable.

A copy of the JAX package's ``repro.train.data`` (numpy only; the port
imports nothing of ``repro``): the same ``DataConfig`` (fields, defaults
and ``repr``, so a checkpoint's config hash agrees across the packages)
and the same draws, so a cursor gives the same batch, bit for bit, in
either package.  A seeded token-stream source with an explicit cursor
that is checkpointed with the model (restart-exact).  Sources: synthetic
LM stream (zipf-mixture, default), or a binary token file memory-mapped
and chunked.  Batches are numpy arrays on the host; the train step moves
them to its device.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class DataConfig:
    kind: str = "synthetic"       # "synthetic" | "tokens"
    path: Optional[str] = None    # for kind="tokens": int32 binary file
    seed: int = 0
    batch: int = 8
    seq: int = 512


class DataState:
    """Explicit cursor: (epoch, step) — serialized into checkpoints."""

    def __init__(self, step: int = 0):
        self.step = step

    def to_dict(self):
        return {"step": self.step}

    @classmethod
    def from_dict(cls, d):
        return cls(int(d["step"]))


class DataSource:
    def __init__(self, cfg: DataConfig, model: ModelConfig):
        self.cfg = cfg
        self.model = model
        if cfg.kind == "tokens":
            if not cfg.path:
                raise ValueError("kind='tokens' needs a path")
            self._tokens = np.memmap(cfg.path, dtype=np.int32, mode="r")
        else:
            self._tokens = None

    def batch_at(self, state: DataState) -> Dict[str, np.ndarray]:
        """Deterministic batch for a given cursor (restart-exact)."""
        c, m = self.cfg, self.model
        if self._tokens is not None:
            n = c.batch * (c.seq + 1)
            total = len(self._tokens) - n - 1
            off = (state.step * n) % max(total, 1)
            flat = np.asarray(self._tokens[off:off + n]).reshape(
                c.batch, c.seq + 1)
        else:
            g = np.random.default_rng(
                np.random.PCG64(c.seed * 1_000_003 + state.step))
            # zipf-mixture synthetic stream: hot tokens + uniform tail
            hot = g.zipf(1.5, size=(c.batch, c.seq + 1)) % max(m.vocab // 8, 2)
            uni = g.integers(0, m.vocab, (c.batch, c.seq + 1))
            pick = g.random((c.batch, c.seq + 1)) < 0.7
            flat = np.where(pick, hot, uni).astype(np.int32)
        batch = {"tokens": flat[:, :-1].astype(np.int32),
                 "labels": flat[:, 1:].astype(np.int32)}
        if m.family == "vlm":
            g2 = np.random.default_rng(state.step + 17)
            batch["img"] = g2.standard_normal(
                (c.batch, m.n_img_tokens, m.d_model)).astype(np.float32)
        if m.family == "audio":
            g2 = np.random.default_rng(state.step + 23)
            batch["frames"] = g2.standard_normal(
                (c.batch, m.n_audio_frames, m.d_model)).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        st = DataState(0)
        while True:
            yield self.batch_at(st)
            st.step += 1
