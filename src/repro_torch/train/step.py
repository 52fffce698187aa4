"""Train, serve and prefill steps over the model API.

The counterparts of the JAX package's ``repro.train.step``.  PyTorch runs
eagerly, so a step is a plain function (no ``jit``).

The train step takes its gradient through the einsum/blocked attention
route (:func:`repro_torch.models.common.einsum_route`), as the JAX
package trains through XLA attention: the flash kernel (K2) has no
backward, and its wrapper refuses inputs that need a gradient.

With a ``mesh`` the steps run SPMD on every rank of it: parameters and
optimizer state are DTensors (``api.init_params(..., mesh=)``,
``optim.init_opt``), a batch is whole arrays or DTensors, and the
outputs are DTensors placed as the inputs (the loss, grad norm and step
plain tensors, the same on every rank; the prefill's logits a DTensor).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models.common import einsum_route
from repro_torch.models.config import ModelConfig
from repro_torch.train.optim import (OptConfig, OptState, apply_updates,
                                     tree_items, tree_map)


def value_and_grad(cfg: ModelConfig, params, batch, device=None, mesh=None
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """(loss, gradient tree of ``params``), as ``jax.value_and_grad`` of
    the JAX package's train-step loss.  With ``cfg.cast_params_bf16`` the
    float32 leaves are cast to bf16 once and the gradient lands on the
    float32 leaves.  A leaf the loss does not reach (the hybrid family's
    ``layers.mamba.ln``) gets a zero gradient of its own shape, dtype and
    placement, as JAX gives it."""
    with torch.enable_grad(), einsum_route():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        used = leaves
        if cfg.cast_params_bf16:
            # one cast per step (in the JAX package, the FSDP gathers and
            # gradient reduce-scatters at this boundary move bf16)
            used = tree_map(lambda p: p.to(torch.bfloat16)
                            if p.dtype == torch.float32 else p, leaves)
        loss = api.loss_fn(cfg, used, batch, device=device, mesh=mesh)
        flat = [p for _, p in tree_items(leaves)]
        raw = torch.autograd.grad(loss, flat, allow_unused=True)
    # zeros for an unread leaf; of a DTensor, a DTensor placed as it
    grads = iter(torch.zeros_like(p) if g is None else g
                 for g, p in zip(raw, flat))
    return loss.detach(), tree_map(lambda _: next(grads), leaves)


def make_train_step(cfg: ModelConfig, opt: OptConfig, device=None,
                    mesh=None):
    """(params, opt_state, batch) -> (params, opt_state, metrics), with
    ``metrics`` holding 0-d tensors ``loss``, ``grad_norm`` and ``step``.
    New tensors come out; the inputs stay as they were.  Runs on
    ``device`` (default ``cuda``, which raises without a GPU)."""
    dev = resolve_device(device)

    def train_step(params, opt_state: OptState, batch: Dict[str, Any]):
        loss, grads = value_and_grad(cfg, params, batch, device=dev,
                                     mesh=mesh)
        params, opt_state, gnorm = apply_updates(opt, params, grads,
                                                 opt_state)
        metrics = {"loss": loss, "grad_norm": gnorm, "step": opt_state.step}
        return params, opt_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig, device=None, mesh=None):
    """(params, cache, tokens (B,1)) -> (logits (B,V), cache).

    With a ``mesh`` the decode runs SPMD as the JAX package's decode
    cell splits it (``api.decode_step(mesh=)``): the weights stay split
    by ``param_pspecs``, the cache by ``cache_pspecs`` (``cache`` holds
    such DTensors and comes back placed as it came), ``tokens`` a
    DTensor or a whole array, which each rank cuts by ``P(DP, None)``;
    the logits come out a DTensor."""

    def serve_step(params, cache, tokens):
        return api.decode_step(cfg, params, cache, tokens, device=device,
                               mesh=mesh)

    return serve_step


def make_prefill_step(cfg: ModelConfig, device=None, mesh=None):
    """Inference-prefill: full forward, no cache, returns last-token logits
    (B, vocab); on a mesh a DTensor, the vocabulary split as the head."""

    def prefill_step(params, batch):
        logits, _ = api.forward_logits(cfg, params, batch, device=device,
                                       mesh=mesh)
        return logits[:, -1]

    return prefill_step
