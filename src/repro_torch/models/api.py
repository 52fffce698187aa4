"""Public model API: parameters, caches, inputs, forward and decode.

The counterpart of the JAX package's ``repro.models.api``:

  abstract_params / init_params / param_pspecs   (never drift: one tree fn)
  init_cache / cache_pspecs
  input_specs / input_pspecs / make_inputs
  loss_fn(cfg, params, batch, mesh=None)         causal-LM cross entropy
  forward_logits(cfg, params, batch, mesh=None)  cache-free forward (prefill)
  decode_step(cfg, params, cache, tokens, mesh=None)  one-token serve step
  prefill(cfg, params, batch, cache)             a prompt into the cache
                                                 (wrong for S > 1: R4)

With a ``mesh`` (a ``DeviceMesh`` over ``("pod",) "data", "model"``
axes), ``params`` are DTensors placed by ``param_pspecs`` (see
:func:`repro_torch.parallel.sharding.distribute`) and every rank of the
mesh makes the same call; the batch may be whole arrays, which each rank
cuts to its own shard by ``input_pspecs``, or DTensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(or another device), and raise without a GPU: nothing falls back to the
CPU.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device

from repro_torch.parallel.sharding import (P, distribute, placements,
                                           resolve_pspec)

from .common import local_map, unit_dims_whole
from .config import ModelConfig
from .params import abstract_leaf, init_leaf, spec_leaf
from .zoo import DP, cache_tree, forward, param_tree


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


def init_params(cfg: ModelConfig, seed: int, device=None, mesh=None):
    """Random parameters from ``seed`` on ``device`` (default ``cuda``).
    With a ``mesh``, each leaf is drawn whole on ``device``, as on one
    device (the card's generator draws other numbers than the host's),
    and each rank keeps its block of it (DTensors placed by
    ``param_pspecs``)."""
    dev = resolve_device(device)
    init = init_leaf(seed, getattr(torch, cfg.param_dtype), dev)
    if mesh is None:
        return param_tree(cfg, init)

    def leaf(name, shape, spec, scale):
        spec = resolve_pspec(spec, mesh, shape)
        return distribute(init(name, shape, spec, scale), mesh,
                          placements(spec, mesh))
    return param_tree(cfg, leaf)


def param_pspecs(cfg: ModelConfig):
    """The parameter tree's sharding specs (specs and ``Alt``s)."""
    return param_tree(cfg, spec_leaf())


def cache_pspecs(cfg: ModelConfig, batch: int = 1, cache_len: int = 128):
    """The decode cache's sharding specs."""
    return cache_tree(cfg, lambda n, s, spec, sc: spec, batch, cache_len)


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


def input_specs(cfg: ModelConfig, kind: str, global_batch: int,
                seq_len: int) -> Dict[str, torch.Tensor]:
    """Shape-only stand-ins (``meta`` tensors) for every model input of a
    ``kind`` ("train", "prefill" or "decode") batch."""
    i32 = torch.int32
    dt = getattr(torch, cfg.compute_dtype)
    b = global_batch
    meta = lambda shape, dtype: torch.empty(shape, dtype=dtype,  # noqa: E731
                                            device="meta")
    if kind in ("train", "prefill"):
        out = {"tokens": meta((b, seq_len), i32)}
        if kind == "train":
            out["labels"] = meta((b, seq_len), i32)
        if cfg.family == "vlm":
            out["img"] = meta((b, cfg.n_img_tokens, cfg.d_model), dt)
        if cfg.family == "audio":
            out["frames"] = meta((b, cfg.n_audio_frames, cfg.d_model), dt)
        return out
    if kind == "decode":
        return {"tokens": meta((b, 1), i32)}
    raise ValueError(kind)


def input_pspecs(cfg: ModelConfig, kind: str) -> Dict[str, P]:
    """The inputs' sharding specs: the batch dim over ``DP``."""
    out = {"tokens": P(DP, None)}
    if kind == "train":
        out["labels"] = P(DP, None)
    if kind in ("train", "prefill"):
        if cfg.family == "vlm":
            out["img"] = P(DP, None, None)
        if cfg.family == "audio":
            out["frames"] = P(DP, None, None)
    return out


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


def _batch_on(cfg: ModelConfig, batch, dev: torch.device, mesh,
              kind: str):
    """The batch as tensors on ``dev``; with a mesh, as DTensors placed by
    ``input_pspecs`` (a DTensor keeps its placements), a dim of size 1
    whole (``common.unit_dims_whole``)."""
    if mesh is None:
        return {k: _to(v, dev) for k, v in batch.items()}
    from torch.distributed.tensor import DTensor
    specs = input_pspecs(cfg, kind)
    out = {}
    for k, v in batch.items():
        if not isinstance(v, DTensor):
            v = _to(v, dev)
            spec = resolve_pspec(specs.get(k, P()), mesh, v.shape)
            v = distribute(v, mesh, placements(spec, mesh))
        out[k] = v.redistribute(mesh, unit_dims_whole(v, v.placements))
    return out


def loss_fn(cfg: ModelConfig, params, batch, device=None,
            mesh=None) -> torch.Tensor:
    """Mean next-token cross entropy over the labels ``>= 0`` (0-d float32
    tensor, the same on every rank of a mesh).  ``params`` must already
    be on ``device`` (default ``cuda``).  The gold logit is taken by a
    masked reduction over the vocabulary, as the JAX package takes it.
    Logits split over the vocabulary stay split: each rank reduces its
    own block and the mesh all-reduces (B, S) figures
    (:func:`_vocab_parallel_nll`), as GSPMD reduces over the split
    vocabulary in the JAX package."""
    dev = resolve_device(device)
    _check_params(params, dev)
    batch = _batch_on(cfg, batch, dev, mesh, "train")
    logits, _ = forward(cfg, params, batch, cache=None, mesh=mesh)
    labels = batch["labels"]
    lf = logits.float()
    if _vocab_dims(lf):
        nll, labels = _vocab_parallel_nll(lf, labels)
    else:
        logz = torch.logsumexp(lf, dim=-1)
        vidx = _vocab_iota(lf)
        gold = torch.sum(torch.where(vidx == labels[..., None], lf, 0.0),
                         dim=-1)
        nll = logz - gold
    mask = (labels >= 0).float()
    loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return loss.full_tensor() if mesh is not None else loss


def _vocab_dims(lf) -> list:
    """The mesh dims of more than one rank that split the vocabulary
    (the last dim) of the DTensor ``lf``; none for a plain tensor."""
    if not hasattr(lf, "placements"):
        return []
    return [i for i, p in enumerate(lf.placements)
            if p.is_shard() and p.dim == lf.ndim - 1
            and lf.device_mesh.size(i) > 1]


def _all_reduce(t: torch.Tensor, op: str, groups) -> torch.Tensor:
    """``t`` reduced by ``op`` over each process group of ``groups`` in
    turn, through the functional collective that DTensor calls too (so
    that ``dist.stage_through_host`` routes it on gloo ranks sharing a
    card)."""
    import torch.distributed._functional_collectives as funcol
    for g in groups:
        t = funcol.wait_tensor(funcol.all_reduce(t, op, g))
    return t


class _NLL(torch.autograd.Function):
    """Per-token ``logsumexp(lf) - lf[label]`` (B, S) of one rank's block
    ``lf`` (B, S, Vl) of float32 logits, the vocabulary split over
    ``groups``; ``lo`` is the block's first vocabulary index.  The
    running max, the sum of exponentials and the gold logit are
    all-reduced as (B, S) tensors; the gradient is the block's softmax
    less its one-hot, and needs no collective."""

    @staticmethod
    def forward(ctx, lf, labels, lo: int, groups):
        m = _all_reduce(lf.amax(dim=-1), "max", groups)
        # one block-sized temporary at a time, here and in the backward
        se = _all_reduce((lf - m[..., None]).exp_().sum(dim=-1), "sum",
                         groups)
        logz = m + torch.log(se)
        # labels < 0, and labels in another rank's block, hit nothing
        idx = labels.long() - lo
        hit = (idx >= 0) & (idx < lf.shape[-1])
        idx = torch.where(hit, idx, 0)[..., None]
        gold = torch.where(hit, lf.gather(-1, idx)[..., 0], 0.0)
        gold = _all_reduce(gold, "sum", groups)
        ctx.save_for_backward(lf, logz, idx, hit)
        return logz - gold

    @staticmethod
    def backward(ctx, g):
        lf, logz, idx, hit = ctx.saved_tensors
        grad = (lf - logz[..., None]).exp_()
        grad.scatter_add_(-1, idx, -hit.to(grad.dtype)[..., None])
        return grad.mul_(g[..., None]), None, None, None


def _vocab_parallel_nll(lf, labels):
    """(per-token cross entropy (B, S), the labels placed as it): of the
    DTensor logits ``lf`` (B, S, V) split over the vocabulary, each rank
    on its own block of it, which no collective gathers.  Uneven splits
    take each rank's first index from DTensor's own chunking."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = lf.device_mesh
    vdims = _vocab_dims(lf)
    # the per-token figures keep the batch's and the sequence's splits
    rows = [p if p in (Shard(0), Shard(1)) else Replicate()
            for p in lf.placements]
    labels = labels.redistribute(mesh, rows)
    # this rank's first vocabulary index: DTensor's chunks (those of
    # torch.chunk), mesh dim by mesh dim
    lo, n = 0, lf.shape[-1]
    for i in vdims:
        c = -(-n // mesh.size(i))
        start = min(mesh.get_coordinate()[i] * c, n)
        lo, n = lo + start, min(c, n - start)
    groups = [mesh.get_group(i) for i in vdims]
    nll = local_map(lambda ll, lb: _NLL.apply(ll, lb, lo, groups), rows, lf,
                    labels)
    return nll, labels


def _vocab_iota(lf: torch.Tensor) -> torch.Tensor:
    """Each logit's vocabulary index, shaped to broadcast against ``lf``
    (B, S, V); with a DTensor, placed as ``lf``'s vocabulary dim."""
    v = lf.shape[-1]
    iota = torch.arange(v, dtype=torch.int32, device=lf.device)
    if not hasattr(lf, "placements"):
        return iota
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = lf.device_mesh
    pl = tuple(Shard(0) if getattr(p, "dim", None) == lf.ndim - 1
               else Replicate() for p in lf.placements)
    return DTensor.from_local(iota, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, pl)


def forward_logits(cfg: ModelConfig, params, batch, device=None, mesh=None):
    """Cache-free forward (prefill): (logits (B, S, vocab), None).
    ``params`` must already be on ``device`` (default ``cuda``).  With a
    mesh the logits are a DTensor."""
    dev = resolve_device(device)
    _check_params(params, dev)
    batch = _batch_on(cfg, batch, dev, mesh, "prefill")
    return forward(cfg, params, batch, cache=None, mesh=mesh)


def decode_step(cfg: ModelConfig, params, cache, tokens, device=None,
                mesh=None):
    """One decode step: tokens (B, 1) -> (logits (B, vocab), new cache).
    ``params`` and ``cache`` must already be on ``device``.  With a
    ``mesh`` they are DTensors placed by ``param_pspecs`` and
    ``cache_pspecs``, the tokens a DTensor or a whole array (each rank
    cuts its rows), and the logits and new cache come out as DTensors."""
    dev = resolve_device(device)
    _check_params(params, dev)
    tokens = _batch_on(cfg, {"tokens": _to(tokens, dev, torch.int32)},
                       dev, mesh, "decode")["tokens"]
    logits, new_cache = forward(cfg, params, {"tokens": tokens}, cache=cache,
                                mesh=mesh)
    return logits[:, -1], new_cache


def prefill(cfg: ModelConfig, params, batch, cache, device=None):
    """Run the prompt through the model writing into the cache: (the last
    token's logits (B, vocab), new cache), as the JAX package's
    ``prefill`` does.

    Defect R4, kept for parity: it is wrong for a prompt of S > 1
    tokens.  The attention block masks the cache slots past the write
    index as it stood BEFORE the write (``valid = kpos <= idx``), so
    every prompt token sees only the keys up to the first one, not the
    prompt before it.  S calls of :func:`decode_step` give the right
    logits; the serving path uses those, and nothing in the port calls
    this function."""
    dev = resolve_device(device)
    _check_params(params, dev)
    batch = _batch_on(cfg, batch, dev, None, "prefill")
    logits, new_cache = forward(cfg, params, batch, cache=cache)
    return logits[:, -1], new_cache
