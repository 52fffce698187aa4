"""Public model API: parameters, caches, inputs, forward and decode.

The counterpart of the JAX package's ``repro.models.api`` for serving:

  abstract_params / init_params          (never drift: one tree fn)
  init_cache / make_inputs
  loss_fn(cfg, params, batch)            causal-LM cross entropy
  forward_logits(cfg, params, batch)     cache-free forward (prefill)
  decode_step(cfg, params, cache, tokens) one-token serve step

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or another device), and raise without a GPU: nothing falls back to the
CPU.  ``prefill`` (a prompt written into the cache in one call) waits
because the JAX package's version masks the prompt's own keys
(``ROADMAP.md`` §3).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

from .config import ModelConfig
from .params import abstract_leaf, init_leaf
from .zoo import cache_tree, forward, param_tree


def _to(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (a tensor, or anything numpy reads) as a tensor on ``dev``."""
    if isinstance(x, torch.Tensor):
        return x.to(dev, dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=dev)


def _check_params(params, dev: torch.device) -> None:
    at = params["embed"].device
    if at.type != dev.type or dev.index not in (None, at.index):
        raise ValueError(f"params are on {at}, not on {dev}: make them "
                         f"there (init_params, convert.params_from_numpy)")


def abstract_params(cfg: ModelConfig):
    """The parameter tree as shape-only tensors on the ``meta`` device."""
    return param_tree(cfg, abstract_leaf(getattr(torch, cfg.param_dtype)))


def init_params(cfg: ModelConfig, seed: int, device=None):
    """Random parameters from ``seed`` on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    return param_tree(cfg, init_leaf(seed, getattr(torch, cfg.param_dtype),
                                     dev))


def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None):
    """A zeroed decode cache on ``device`` (default ``cuda``; ``meta``
    gives a shape-only one) for any family: every leaf in the compute
    dtype (K/V, SSM conv and state, vlm ``img``, audio ``enc``), ``idx``
    a 0-d int32 tensor.  The vlm ``img`` and audio ``enc`` start at zero,
    as the JAX package leaves them; a caller with an image or an encoded
    clip writes it in."""
    dev = resolve_device(device)
    dt = getattr(torch, cfg.compute_dtype)
    leaf = lambda name, shape, spec, sc: torch.zeros(
        shape, dtype=torch.int32 if name == "idx" else dt, device=dev)
    return cache_tree(cfg, leaf, batch, cache_len)


def make_inputs(cfg: ModelConfig, kind: str, batch: int, seq: int,
                rng: np.random.Generator, device=None
                ) -> Dict[str, torch.Tensor]:
    """Concrete random inputs from a numpy generator: the same draws, in
    the same order, as the JAX package's ``make_inputs``.  ``tokens``
    (and ``labels`` for ``kind="train"``) int32; for a train or prefill
    batch the vlm family adds ``img`` (B, n_img_tokens, d) and the audio
    family ``frames`` (B, n_audio_frames, d), standard normal in the
    compute dtype (rounded to float32 first, as ``jnp.asarray`` rounds a
    float64 array to bfloat16)."""
    dev = resolve_device(device)
    out = {"tokens": torch.as_tensor(
        rng.integers(0, cfg.vocab, (batch, seq)), dtype=torch.int32,
        device=dev)}
    if kind == "train":
        out["labels"] = torch.as_tensor(
            rng.integers(0, cfg.vocab, (batch, seq)), dtype=torch.int32,
            device=dev)
    if kind in ("train", "prefill"):
        dt = getattr(torch, cfg.compute_dtype)
        for fam, key, n in (("vlm", "img", cfg.n_img_tokens),
                            ("audio", "frames", cfg.n_audio_frames)):
            if cfg.family == fam:
                out[key] = torch.from_numpy(rng.standard_normal(
                    (batch, n, cfg.d_model)).astype(np.float32)).to(dev, dt)
    return out


def loss_fn(cfg: ModelConfig, params, batch, device=None) -> torch.Tensor:
    """Mean next-token cross entropy over the labels ``>= 0`` (0-d float32
    tensor).  ``params`` must already be on ``device`` (default
    ``cuda``).  The gold logit is gathered: the JAX package takes it by a
    masked reduction, which keeps a sharded vocabulary sharded; nothing
    is sharded here."""
    dev = resolve_device(device)
    _check_params(params, dev)
    batch = {k: _to(v, dev) for k, v in batch.items()}
    logits, _ = forward(cfg, params, batch, cache=None)
    labels = batch["labels"].long()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((logz - gold) * mask) / torch.clamp(torch.sum(mask),
                                                         min=1.0)


def forward_logits(cfg: ModelConfig, params, batch, device=None):
    """Cache-free forward (prefill): (logits (B, S, vocab), None).
    ``params`` must already be on ``device`` (default ``cuda``)."""
    dev = resolve_device(device)
    _check_params(params, dev)
    batch = {k: _to(v, dev) for k, v in batch.items()}
    return forward(cfg, params, batch, cache=None)


def decode_step(cfg: ModelConfig, params, cache, tokens, device=None):
    """One decode step: tokens (B, 1) -> (logits (B, vocab), new cache).
    ``params`` and ``cache`` must already be on ``device``."""
    dev = resolve_device(device)
    _check_params(params, dev)
    tokens = _to(tokens, dev, torch.int32)
    logits, new_cache = forward(cfg, params, {"tokens": tokens}, cache=cache)
    return logits[:, -1], new_cache
