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


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure, called in
    ``tree_items``'s order."""
    out = {}
    for k in sorted(tree):
        args = (tree[k], *(r[k] for r in rest))
        out[k] = tree_map(fn, *args) if isinstance(tree[k], dict) \
            else fn(*args)
    return out


def init_opt(cfg: OptConfig, params) -> OptState:
    dt = getattr(torch, cfg.moment_dtype)
    z = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = next(tree_items(params))[1].device
    return OptState(tree_map(z, params), tree_map(z, params),
                    torch.zeros((), dtype=torch.int32, device=dev))


def schedule(cfg: OptConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine to 0.1 of ``cfg.lr``; float32."""
    s = step.to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup)
                       / max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's float32 sum of squares."""
    total = None
    for _, g in tree_items(tree):
        sq = torch.sum(g.to(torch.float32) ** 2)
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: OptConfig, params, grads, st: OptState
                  ) -> Tuple[Dict[str, Any], OptState, torch.Tensor]:
    """One AdamW step: (new params, new state, global grad norm), all new
    tensors.  Weight decay applies to every leaf, as in the JAX
    package."""
    step = st.step + 1
    gn = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gn, min=1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, sf)
    bc2 = 1 - torch.pow(b2, sf)

    def upd(p, g, m, v):
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
    pick = lambda i: tree_map(lambda t: t[i], out)
    # tree_map stops at dicts, so the (p, m, v) tuples are its leaves
    return pick(0), OptState(pick(1), pick(2), step), gn
