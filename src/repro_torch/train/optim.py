"""AdamW with bf16-or-fp32 moments, cosine schedule, global-norm clip.

The counterpart of the JAX package's ``repro.train.optim``: the same
``OptConfig`` (the same fields, defaults and ``repr``, so a checkpoint's
config hash agrees across the packages), the same update and the same
float32 arithmetic.  The schedule and the bias corrections are computed
in float32 from the int32 step, as the JAX package computes them, on the
step's device: no host sync, and one dtype on every device.

Parameter, gradient and moment trees are nested dicts of tensors.  The
update is functional: :func:`apply_updates` returns new tensors and
leaves its inputs as they were, so a caller that drops a step's result
(a non-finite loss) keeps its old state whole.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor      # 0-d int32, on the parameters' device
                            # (on a mesh a replicated DTensor)


def tree_items(tree, path: Tuple[str, ...] = ()
               ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested dict in sorted key order: the order in
    which JAX flattens a dict, so sums over leaves add in the same order
    as the JAX package's."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from tree_items(v, path + (k,))
        else:
            yield path + (k,), v


def tree_map(fn, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of nested dicts, tuples, lists and named
    tuples of one structure, a dict's in ``tree_items``'s order;
    ``is_leaf`` stops the descent early."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
               for i, v in enumerate(tree)]
        return type(tree)(*out) if hasattr(tree, "_fields") \
            else type(tree)(out)
    return fn(tree, *rest)


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


def _like(local: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``local`` as the block of a tensor placed as ``ref``."""
    if not isinstance(ref, DTensor):
        return local
    return DTensor.from_local(local, ref.device_mesh, ref.placements,
                              run_check=False, shape=ref.shape,
                              stride=ref.stride())


def init_opt(cfg: OptConfig, params) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    z = lambda p: _like(torch.zeros(_local(p).shape, dtype=dt,  # noqa: E731
                                    device=p.device), p)
    first = next(tree_items(params))[1]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if isinstance(first, DTensor):
        mesh = first.device_mesh
        step = DTensor.from_local(step, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    return OptState(tree_map(z, params), tree_map(z, params), step)


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine to 0.1 of ``cfg.lr``; float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares (a DTensor
    leaf's over all its shards); a plain 0-d tensor."""
    total = None
    for _, g in tree_items(tree):
        sq = torch.sum(g.to(torch.float32) ** 2)
        if isinstance(sq, DTensor):
            sq = sq.full_tensor()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, st: OptState
                  ) -> Tuple[Dict[str, Any], OptState, torch.Tensor]:
    """One AdamW step: (new params, new state, global grad norm), all new
    tensors.  Weight decay applies to every leaf, as in the JAX
    package."""
    grads = tree_map(lambda g, p: g.redistribute(p.device_mesh, p.placements)
                     if isinstance(p, DTensor) else g, grads, params)
    step_l = _local(st.step) + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step_l)
    b1, b2 = cfg.b1, cfg.b2
    sf = step_l.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)

    def upd(p, g, m, v):
        return tuple(_like(o, r) for o, r in zip(
            _upd(_local(p), _local(g), _local(m), _local(v)), (p, m, v)))

    def _upd(p, g, m, v):
        g = g.to(torch.float32) * scale
        m32 = m.to(torch.float32) * b1 + (1 - b1) * g
        v32 = v.to(torch.float32) * b2 + (1 - b2) * g * g
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        newp = p.to(torch.float32) - lr * delta
        return newp.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, params, grads, st.mu, st.nu)
    pick = lambda i: tree_map(lambda t: t[i], out,
                              is_leaf=lambda t: isinstance(t, tuple))
    return pick(0), OptState(pick(1), pick(2), _like(step_l, st.step)), gn
