"""Mixture-of-Experts layer: top-k routing with capacity-based sort dispatch.

The counterpart of the JAX package's ``repro.models.moe``, step for step:
tokens split into dispatch groups; in each group every (token, choice)
copy is sorted by expert (stable), takes the next free slot of its
expert's ``cap`` slots or is dropped into the sink slot ``E * cap``;
tokens are gathered into (E, cap, d) slots, run through their expert's
SwiGLU FFN, and gathered back (a dropped copy reads a zero row).  Only
int index maps are scattered; token data moves through gathers and the
expert matmuls, so the work is ~T·k·cap·d·ff, not a dense all-expert
product.  Nothing is sharded on one device: the JAX package's sharding
anchors (``mesh``, ``shard_act``) are left out (``ROADMAP.md`` §1,
item 5).
"""
from __future__ import annotations

from typing import Tuple

import torch

from .common import rmsnorm
from .config import ModelConfig

#: dispatch groups (the JAX package aligns them with its batch shards);
#: must divide the token count, so it shrinks for tiny batches
MOE_GROUPS = 32


def top_k_routing(router_logits: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., E) -> weights (..., k) float32, softmaxed over the top k, and
    ids (..., k) int64.

    Ordered as ``jax.lax.top_k``: by value, descending, and among equal
    values the lower expert first (``torch.topk`` promises no order on
    ties, so a stable descending sort picks them)."""
    ids = torch.argsort(router_logits, dim=-1, descending=True,
                        stable=True)[..., :k]
    vals = torch.gather(router_logits, -1, ids)
    return torch.softmax(vals.float(), dim=-1), ids


def _dispatch_groups(t: int) -> int:
    g = MOE_GROUPS
    while t % g:
        g //= 2
    return max(g, 1)


def _grouped_moe(cfg: ModelConfig, p: dict, xg: torch.Tensor) -> torch.Tensor:
    """Grouped dispatch: xg (G, Tg, d) -> (G, Tg, d) float32."""
    g_, tg, d = xg.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    dev = xg.device
    garange = torch.arange(g_, device=dev)[:, None]

    logits = torch.einsum("gtd,de->gte", xg, p["router"].to(xg.dtype))
    w, ids = top_k_routing(logits, k)                      # (G, Tg, k)

    # Python floats, as the JAX package computes it
    cap = max(int(cfg.capacity_factor * tg * k / e + 1), 4)
    flat_e = ids.reshape(g_, tg * k)
    flat_tok = torch.arange(tg, device=dev).repeat_interleave(k)[None] \
        .expand(g_, tg * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = torch.gather(flat_e, 1, order)
    stok = torch.gather(flat_tok, 1, order)
    # first sorted position of each copy's expert: its rank among them
    first = torch.searchsorted(se, se, side="left")
    pos_in_e = torch.arange(tg * k, device=dev)[None] - first
    keep_sorted = pos_in_e < cap
    slot_sorted = torch.where(keep_sorted, se * cap + pos_in_e, e * cap)

    # index maps only: each copy's slot, and each slot's token (tg, the
    # zero pad row, for empty slots; every dropped copy writes tg into the
    # sink slot e * cap, so its duplicates agree)
    slot = torch.zeros((g_, tg * k), dtype=torch.int64, device=dev) \
        .scatter(1, order, slot_sorted).reshape(g_, tg, k)
    inv_tok = torch.full((g_, e * cap + 1), tg, dtype=torch.int64,
                         device=dev).scatter(
        1, slot_sorted, torch.where(keep_sorted, stok, tg))

    # dispatch: a batched gather from the zero-padded tokens
    xt_pad = torch.cat([xg, xg.new_zeros((g_, 1, d))], dim=1)
    xe = xt_pad[garange, inv_tok[:, :-1]].reshape(g_, e, cap, d)

    gate = torch.einsum("gecd,edf->gecf", xe, p["w1"].to(xe.dtype))
    up = torch.einsum("gecd,edf->gecf", xe, p["w3"].to(xe.dtype))
    z = torch.nn.functional.silu(gate.float()).to(xe.dtype) * up
    ye = torch.einsum("gecf,efd->gecd", z, p["w2"].to(xe.dtype))

    # combine: gather back (dropped copies hit the zero pad row)
    yf = torch.cat([ye.reshape(g_, e * cap, d), ye.new_zeros((g_, 1, d))],
                   dim=1)
    contrib = yf[garange, slot.reshape(g_, tg * k)].reshape(g_, tg, k, d)
    return torch.einsum("gtkd,gtk->gtd", contrib.float(), w.float())


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  p: router (d, E), w1/w3 (E, d, f),
    w2 (E, f, d) + optional shared expert (w1s/w3s/w2s)."""
    b, s, d = x.shape
    t = b * s
    g = _dispatch_groups(t)
    out = _grouped_moe(cfg, p, x.reshape(g, t // g, d)).reshape(b, s, d)

    if cfg.moe_shared > 0:
        xt = x.reshape(t, d)
        gs = torch.einsum("td,df->tf", xt, p["w1s"].to(xt.dtype))
        us = torch.einsum("td,df->tf", xt, p["w3s"].to(xt.dtype))
        zs = torch.nn.functional.silu(gs.float()).to(xt.dtype) * us
        out = out + torch.einsum("tf,fd->td", zs, p["w2s"].to(xt.dtype)
                                 ).float().reshape(b, s, d)
    return out.to(x.dtype)


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    y = rmsnorm(x, p["ln"], cfg.norm_eps)
    return x + moe_ffn(cfg, p, y)
