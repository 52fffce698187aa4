"""Serve and prefill steps over the model API.

The counterparts of the JAX package's ``repro.train.step``
``make_serve_step`` and ``make_prefill_step``; ``make_train_step`` waits
for the training slice.  PyTorch runs eagerly, so a step is a plain
function (no ``jit``).
"""
from __future__ import annotations

from repro_torch.models import api
from repro_torch.models.config import ModelConfig


def make_serve_step(cfg: ModelConfig, device=None):
    """(params, cache, tokens (B,1)) -> (logits (B,V), cache)."""

    def serve_step(params, cache, tokens):
        return api.decode_step(cfg, params, cache, tokens, device=device)

    return serve_step


def make_prefill_step(cfg: ModelConfig, device=None):
    """Inference-prefill: full forward, no cache, returns last-token logits."""

    def prefill_step(params, batch):
        logits, _ = api.forward_logits(cfg, params, batch, device=device)
        return logits[:, -1]

    return prefill_step
