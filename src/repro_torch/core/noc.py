"""Phases 2 & 3: bufferless deflection routing (paper §4, §6.2.1).

The PyTorch counterpart of the JAX package's ``repro.core.noc``.

Phase 2 (arbitration): per router — eject the oldest deliverable flit (S11),
optionally admit an injection flit (S12), then assign output ports in
age-priority order with PMDR preference lists (S9), deflecting losers,
and pop the send queue.  The whole phase is
:func:`repro_torch.kernels.ops.phase2_router`: one launch of the
hand-written fused router kernel on the card, its plain version on the
CPU.

Phase 3 (transfer): a pure gather — input port p of node n reads the
opposite output port of its neighbour in direction p — then ``deliver``
moves the ejected flit into the ROB and the pending-completion queue.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..kernels import ops as kops
from .cache import argmax, argmin, set_where, where
from .config import SimConfig
from .state import (
    F_NFL, F_OSRC, F_PKT, F_SRC, F_TAG, F_TYP, F_VALID, I32,
    R_CNT, R_NFL, R_OSRC, R_PKT, R_SRC, R_TAG, R_TYP,
    P_VALID, Geometry, NodeCtx, SimState, bump_all,
)

#: larger than any node id or packet counter (pkt wraps at 2**30)
BIG = 1 << 30


class ArbResult(NamedTuple):
    out: torch.Tensor        # (Nl, 4, NUM_F) outgoing flits (age already bumped)
    ej_port: torch.Tensor    # (Nl,) int64
    has_ej: torch.Tensor     # (Nl,) bool
    n_deflected: torch.Tensor
    n_injected: torch.Tensor


def phase2(s: SimState, cfg: SimConfig,
           ctx: NodeCtx) -> Tuple[SimState, ArbResult]:
    """Eject, inject, arbitrate and route for every router, then pop the
    send queues and count injections and deflections: one launch of the
    fused router kernel on the card, its plain version
    (:func:`repro_torch.kernels.ref.phase2_router_ref`) on the CPU."""
    r = kops.phase2_router(s.inp, s.rob, s.pc, s.q_desc, s.q_head, s.q_size,
                           s.q_fid, ctx.node_id, ctx.node_r, ctx.node_c,
                           ctx.valid_port, s.knob_ej_age, s.stats,
                           cols=cfg.cols)
    s = s._replace(q_head=r.q_head, q_size=r.q_size, q_fid=r.q_fid,
                   stats=r.stats)
    return s, ArbResult(r.out, r.ej_port, r.has_ej, r.n_deflected,
                        r.n_injected)


def transfer_global(geo: Geometry, out: torch.Tensor) -> torch.Tensor:
    """Single-device phase-3 transfer: global neighbour gather.  ``geo``
    holds tensors on ``out``'s device (:func:`state.geometry_to`)."""
    moved = out[geo.gather_node, geo.gather_port[None, :]]   # (N, 4, F)
    return where(geo.valid_port[:, :, None], moved, 0)


def deliver(s: SimState, cfg: SimConfig, ctx: NodeCtx, arb: ArbResult,
            inp_next: torch.Tensor) -> SimState:
    """Shared phase-3 tail: hop stats, ejection into ROB, completions.

    Per-node order (identical in the serial golden model):

    1. *Promotion* — if the pending-completion queue has a free slot and
       the ROB holds a parked completion, the parked completion with the
       smallest ``(src, pkt)`` moves to the queue tail and its ROB slot is
       freed.
    2. *Ejected flit* — a single-flit packet (or the flit completing a
       multi-flit packet) becomes a pending completion: appended at the
       queue tail when a slot is free, otherwise *parked* in the ROB.
    """
    node = ctx.node
    depth = cfg.pc_depth

    # ---- promotion: oldest parked completion -> pending-queue tail ----
    rob = s.rob
    rob_valid = rob[:, :, R_NFL] > 0
    pc_cnt = (s.pc[:, :, P_VALID] > 0).sum(dim=1, dtype=I32)
    parked = rob_valid & (rob[:, :, R_CNT] >= rob[:, :, R_NFL])
    # deterministic pick: smallest (src, pkt); pkt is a per-source
    # counter, so the pair is unique among parked slots
    src_k = where(parked, rob[:, :, R_SRC], BIG)
    min_src = src_k.amin(dim=1)
    pkt_k = where(parked & (rob[:, :, R_SRC] == min_src[:, None]),
                  rob[:, :, R_PKT], BIG)
    psel = argmin(pkt_k)
    can_prom = parked.any(dim=1) & (pc_cnt < depth)
    prow = rob[node, psel]
    prom_pc = torch.stack([torch.ones_like(pc_cnt), prow[:, R_TYP],
                           prow[:, R_SRC], prow[:, R_OSRC], prow[:, R_TAG]],
                          dim=-1)
    tail0 = torch.clamp(pc_cnt, 0, depth - 1)
    pc = set_where(s.pc, (node, tail0), can_prom[:, None], prom_pc)
    rob = set_where(rob, (node, psel), can_prom[:, None], 0)
    pc_cnt = pc_cnt + can_prom.to(I32)

    # ---- ejection into ROB / pending queue ----
    f = s.inp[node, arb.ej_port]                             # (Nl, F) pre-arb flit
    he = arb.has_ej
    stats = bump_all(s.stats, [("hops", arb.out[:, :, F_VALID]),
                               ("flits_delivered", he)])
    single = he & (f[:, F_NFL] == 1)
    multi = he & (f[:, F_NFL] > 1)

    rob_valid = rob[:, :, R_NFL] > 0                         # post promotion
    m = (rob_valid & (rob[:, :, R_SRC] == f[:, None, F_SRC])
         & (rob[:, :, R_PKT] == f[:, None, F_PKT]))          # (Nl, K)
    has_match = m.any(dim=1)
    slot = where(has_match, argmax(m), argmax(~rob_valid))
    newslot = multi & ~has_match
    init_row = torch.stack([f[:, F_SRC], f[:, F_PKT], f[:, F_TYP], f[:, F_TAG],
                            f[:, F_OSRC], f[:, F_NFL],
                            torch.zeros_like(pc_cnt)], dim=-1)
    cur = rob[node, slot]
    row = where(newslot[:, None], init_row, cur)
    cnt = row[:, R_CNT] + multi.to(I32)
    row[:, R_CNT] = cnt
    complete_m = multi & (cnt >= row[:, R_NFL])
    full_row = row                    # snapshot before the zeroing below

    completion = single | complete_m
    to_pc = completion & (pc_cnt < depth)
    to_park = completion & ~to_pc
    # a completed slot is freed when its completion enters the queue, and
    # kept (count == total: the "parked" marker) when the queue is full
    row = where((complete_m & ~to_park)[:, None], 0, row)
    rob = set_where(rob, (node, slot), multi[:, None], row)

    # park a single-flit completion in a fresh slot (guaranteed free by
    # phase2's ejection gate)
    park_idx = argmax(~(rob[:, :, R_NFL] > 0))
    one = torch.ones_like(pc_cnt)
    park_row = torch.stack([f[:, F_SRC], f[:, F_PKT], f[:, F_TYP], f[:, F_TAG],
                            f[:, F_OSRC], one, one], dim=-1)
    rob = set_where(rob, (node, park_idx), (single & to_park)[:, None],
                    park_row)

    row_pc = torch.stack([
        to_pc.to(I32),
        where(single, f[:, F_TYP], full_row[:, R_TYP]),
        where(single, f[:, F_SRC], full_row[:, R_SRC]),
        where(single, f[:, F_OSRC], full_row[:, R_OSRC]),
        where(single, f[:, F_TAG], full_row[:, R_TAG]),
    ], dim=-1)
    row_pc = row_pc * to_pc[:, None].to(I32)
    tail = torch.clamp(pc_cnt, 0, depth - 1)
    pc = set_where(pc, (node, tail), to_pc[:, None], row_pc)

    return s._replace(inp=inp_next, rob=rob, pc=pc, stats=stats)


def phase3(s: SimState, cfg: SimConfig, geo: Geometry, ctx: NodeCtx,
           arb: ArbResult) -> SimState:
    return deliver(s, cfg, ctx, arb, transfer_global(geo, arb.out))
