"""Mixture-of-Experts layer: top-k routing with capacity-based sort dispatch.

The counterpart of the JAX package's ``repro.models.moe``, step for step:
tokens split into dispatch groups; in each group every (token, choice)
copy is sorted by expert (stable), takes the next free slot of its
expert's ``cap`` slots or is dropped into the sink slot ``E * cap``;
tokens are gathered into (E, cap, d) slots, run through their expert's
SwiGLU FFN, and gathered back (a dropped copy reads a zero row).  Only
int index maps are scattered; token data moves through gathers and the
expert matmuls, so the work is ~T·k·cap·d·ff, not a dense all-expert
product.

On a mesh (``mesh`` given, DTensor ``x``) the dispatch groups align with
the batch shards over the data axes, so the routing, the sort, the
searchsorted and the index scatters stay local to a data shard (they run
on each rank's groups through ``local_map``: DTensor has no rules for
them).  The experts split over the model axis (expert parallelism) when
their count divides it and ``moe_mode`` is not ``"ftp"``; otherwise
each expert's FFN splits its hidden dim over it.  The JAX package's
sharding anchors (``shard_act``) hold the slots, the hidden activations
and the expert outputs where its version holds them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.parallel.sharding import P

from .common import (is_sharded, local_map, replicated, rmsnorm, rows_whole,
                     shard_act, weight)
from .config import ModelConfig

U = P.UNCONSTRAINED
DPG = ("pod", "data")

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


def _route(cfg: ModelConfig, xg: torch.Tensor, router: torch.Tensor):
    """Routing and slot assignment of groups xg (G, Tg, d): (weights
    (G, Tg, k) float32, each copy's slot (G, Tg, k) and each slot's token
    (G, E * cap + 1), int64).  A copy past its expert's ``cap`` slots is
    dropped into the sink slot ``E * cap``."""
    g_, tg, d = xg.shape
    e, k = cfg.moe_experts, cfg.moe_top_k
    dev = xg.device

    logits = torch.einsum("gtd,de->gte", xg, router.to(xg.dtype))
    w, ids = top_k_routing(logits, k)                      # (G, Tg, k)

    cap = _capacity(cfg, tg)
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
    return w, slot, inv_tok


def _capacity(cfg: ModelConfig, tg: int) -> int:
    # Python floats, as the JAX package computes it
    return max(int(cfg.capacity_factor * tg * cfg.moe_top_k
                   / cfg.moe_experts + 1), 4)


def _dispatch(cfg: ModelConfig, xg: torch.Tensor, inv_tok: torch.Tensor):
    """Tokens into slots: a batched gather from the zero-padded groups,
    (G, Tg, d) -> (G, E, cap, d)."""
    g_, tg, d = xg.shape
    garange = torch.arange(g_, device=xg.device)[:, None]
    xt_pad = torch.cat([xg, xg.new_zeros((g_, 1, d))], dim=1)
    return xt_pad[garange, inv_tok[:, :-1]].reshape(
        g_, cfg.moe_experts, _capacity(cfg, tg), d)


def _combine(ye: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Expert outputs back to the copies: (G, E, cap, d) -> (G, Tg, k, d);
    dropped copies read the zero pad row."""
    g_, e, cap, d = ye.shape
    garange = torch.arange(g_, device=ye.device)[:, None]
    yf = torch.cat([ye.reshape(g_, e * cap, d), ye.new_zeros((g_, 1, d))],
                   dim=1)
    return yf[garange, slot.reshape(g_, -1)].reshape(*slot.shape, d)


def _grouped_moe(cfg: ModelConfig, p: dict, xg: torch.Tensor,
                 mesh=None) -> torch.Tensor:
    """Grouped dispatch: xg (G, Tg, d) -> (G, Tg, d) float32."""
    e = cfg.moe_experts
    if mesh is None:
        w, slot, inv_tok = _route(cfg, xg, p["router"])
        xe = _dispatch(cfg, xg, inv_tok)
    else:
        router = replicated(p["router"])
        w, slot, inv_tok = local_map(
            lambda a, r: _route(cfg, a, r), (xg.placements,) * 3, xg,
            router)
        xe = local_map(lambda a, i: _dispatch(cfg, a, i), xg.placements,
                       xg, inv_tok)

    # anchors: expert-parallel (e over model) when the expert count
    # divides, else TP on the hidden dims; d stays model-sharded through
    # the combine either way
    mode = getattr(cfg, "moe_mode", "auto")
    ep = mesh is not None and "model" in mesh.mesh_dim_names \
        and e % mesh.size(mesh.mesh_dim_names.index("model")) == 0 \
        and mode != "ftp"
    if mode == "ep":
        ep = True
    espec = P(DPG, "model", U, U) if ep else P(DPG, U, U, "model")
    dspec = P(DPG, U, U, "model")
    xe = shard_act(xe, P(DPG, "model", U, U) if ep else P(DPG, U, U, U),
                   mesh)

    gate = torch.einsum("gecd,edf->gecf", xe, weight(p["w1"], xe.dtype))
    up = torch.einsum("gecd,edf->gecf", xe, weight(p["w3"], xe.dtype))
    z = torch.nn.functional.silu(gate.float()).to(xe.dtype) * up
    z = shard_act(z, espec, mesh)
    # contiguous: DTensor views the local block of z in the product
    ye = torch.einsum("gecf,efd->gecd", z.contiguous(),
                      weight(p["w2"], xe.dtype))
    ye = shard_act(ye, dspec, mesh)

    if mesh is None:
        contrib = _combine(ye, slot)
    else:
        contrib = local_map(_combine, ye.placements, ye, slot)
    contrib = shard_act(contrib, dspec, mesh)
    return torch.einsum("gtkd,gtk->gtd", contrib.float(), w.float())


def moe_ffn(cfg: ModelConfig, p: dict, x: torch.Tensor,
            mesh=None) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d).  p: router (d, E), w1/w3 (E, d, f),
    w2 (E, f, d) + optional shared expert (w1s/w3s/w2s)."""
    b, s, d = x.shape
    t = b * s
    g = _dispatch_groups(t)
    if mesh is None:
        out = _grouped_moe(cfg, p, x.reshape(g, t // g, d))
        out = out.reshape(b, s, d)
    else:
        # groups align with the (pod, data) batch shards: each rank's
        # rows are whole groups, so the dispatch is local
        gspec = P(DPG, None, None)
        xr = rows_whole(x)
        n = 1
        for i, pl in enumerate(xr.placements):
            if getattr(pl, "dim", None) == 0:
                n *= mesh.size(i)
        if g % n:
            xr, n = replicated(xr), 1
        xg = local_map(lambda a: a.reshape(g // n, t // g, d),
                       xr.placements, xr)
        xg = shard_act(xg, gspec, mesh)
        out = _grouped_moe(cfg, p, xg, mesh)
        out = shard_act(out, gspec, mesh)
        out = local_map(lambda a: a.reshape(-1, s, d), out.placements, out)

    if cfg.moe_shared > 0:
        xt = rows_whole(x)
        gs = torch.einsum("bsd,df->bsf", xt, weight(p["w1s"], xt.dtype))
        us = torch.einsum("bsd,df->bsf", xt, weight(p["w3s"], xt.dtype))
        zs = torch.nn.functional.silu(gs.float()).to(xt.dtype) * us
        out = out + torch.einsum("bsf,fd->bsd", zs,
                                 weight(p["w2s"], xt.dtype)).float()
    return out.to(x.dtype)


def moe_block(cfg: ModelConfig, p: dict, x: torch.Tensor,
              mesh=None) -> torch.Tensor:
    y = rmsnorm(x, p["ln"], cfg.norm_eps)
    out = moe_ffn(cfg, p, y, mesh)
    if is_sharded(x):
        out = out.redistribute(x.device_mesh, x.placements)
    return x + out
