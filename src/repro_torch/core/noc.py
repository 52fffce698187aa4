"""Phases 2 & 3: bufferless deflection routing (paper §4, §6.2.1).

The PyTorch counterpart of the JAX package's ``repro.core.noc``.

Phase 2 (arbitration): per router — eject the oldest deliverable flit (S11),
optionally admit an injection flit (S12), then assign output ports in
age-priority order with PMDR preference lists (S9), deflecting losers.
The port assignment is :func:`repro_torch.kernels.ops.arbitrate`: the
hand-written CUDA kernel on the card, its plain version on the CPU.

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
    F_AGE, F_DST, F_NFL, F_OSRC, F_PKT, F_SRC, F_TAG, F_TYP, F_VALID,
    I32, Q_DST, Q_NFL, Q_OSRC, Q_PKT, Q_TAG, Q_TYP,
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


def rob_accepts(s: SimState, flits: torch.Tensor) -> torch.Tensor:
    """S10: (Nl, P) bool — can each flit be ejected into the ROB."""
    nfl = flits[..., F_NFL]
    src = flits[..., F_SRC]
    pkt = flits[..., F_PKT]
    rob_valid = s.rob[:, :, R_NFL] > 0                      # (Nl, K)
    m = (rob_valid[:, None, :]
         & (s.rob[:, None, :, R_SRC] == src[:, :, None])
         & (s.rob[:, None, :, R_PKT] == pkt[:, :, None]))   # (Nl, P, K)
    has_match = m.any(dim=-1)
    has_free = (~rob_valid).any(dim=-1)
    return (nfl == 1) | has_match | has_free[:, None]


def phase2(s: SimState, cfg: SimConfig,
           ctx: NodeCtx) -> Tuple[SimState, ArbResult]:
    dev = ctx.node_id.device
    node, nid = ctx.node, ctx.node_id
    vp = ctx.valid_port
    ports = torch.arange(4, dtype=I32, device=dev)

    inp = s.inp
    valid_in = inp[:, :, F_VALID] > 0

    # ---- ejection (S11): oldest (age desc, port asc) deliverable flit.
    #      With an empty pending-completion queue any deliverable flit may
    #      eject; once it is occupied, only flits aged past knob_ej_age
    #      eject — into spare queue capacity while a slot is free, and
    #      into a free ROB slot (the completion parks) when it is full.
    #      pc_depth=1 keeps the paper's exact single-register bar. ----
    acc = rob_accepts(s, inp)
    pc_cnt = (s.pc[:, :, P_VALID] > 0).sum(dim=1, dtype=I32)
    pc_empty = pc_cnt == 0
    if cfg.pc_depth > 1:
        pc_has_slot = pc_cnt < cfg.pc_depth
        rob_free = (s.rob[:, :, R_NFL] == 0).any(dim=1)
        # single-flit packets need a free ROB slot to park in; a
        # completing multi-flit packet parks in its own (matched) slot
        park_ok = (inp[:, :, F_NFL] > 1) | rob_free[:, None]
        old_enough = inp[:, :, F_AGE] >= s.knob_ej_age
        ej_ok = (pc_empty[:, None]
                 | (old_enough & (pc_has_slot[:, None] | park_ok)))
    else:
        ej_ok = pc_empty[:, None]
    want_ej = valid_in & (inp[:, :, F_DST] == nid[:, None]) & acc & ej_ok
    ej_key = where(want_ej, inp[:, :, F_AGE] * 4 + (3 - ports), -1)
    ej_port = argmax(ej_key)
    has_ej = ej_key.amax(dim=1) >= 0
    is_ej = (ports[None, :] == ej_port[:, None]) & has_ej[:, None]
    remaining = valid_in & ~is_ej

    # ---- injection (S12) ----
    n_rem = remaining.sum(dim=1, dtype=I32)
    n_vp = vp.sum(dim=1, dtype=I32)
    qp = cfg.send_queue
    head = s.q_desc[node, s.q_head % qp]                     # (Nl, 6)
    can_inj = (s.q_size > 0) & (n_rem < n_vp)
    inj = torch.stack([
        can_inj.to(I32), torch.zeros_like(nid), nid, head[:, Q_DST],
        head[:, Q_OSRC], head[:, Q_TYP], head[:, Q_TAG], head[:, Q_PKT],
        s.q_fid, head[:, Q_NFL],
    ], dim=-1)

    cand = torch.cat([where(remaining[:, :, None], inp, 0),
                      inj[:, None, :]], dim=1)
    cand_valid = cand[:, :, F_VALID] > 0                     # (Nl, 5)

    # ---- age-priority arbitration (paper Fig. 3 "Priority Sort" + port
    #      selection): the CUDA kernel on the card, the plain version on
    #      the CPU ----
    dst = cand[:, :, F_DST]
    dst_r = where(dst >= 0, dst // cfg.cols, 0)
    dst_c = where(dst >= 0, dst % cfg.cols, 0)
    dr_ = dst_r - ctx.node_r[:, None]
    dc_ = dst_c - ctx.node_c[:, None]
    wanted_eject = cand_valid & (dst == nid[:, None])
    age = cand[:, :, F_AGE].contiguous()
    assigned, deflect = kops.arbitrate(age, cand_valid, wanted_eject,
                                       dc_, dr_, vp)

    # ---- move candidates to their output ports: the ports are distinct,
    #      so at most one candidate lands on each port (a gather) ----
    cand = cand.clone()
    cand[:, :, F_AGE] = age + deflect.to(I32)
    oh = ((assigned[:, :, None] == ports[None, None, :])
          & cand_valid[:, :, None])                          # (Nl, 5, 4)
    taken = oh.any(dim=1)                                    # (Nl, 4)
    out = where(taken[:, :, None], cand[node[:, None], argmax(oh)], 0)
    out[:, :, F_VALID] = taken.to(I32)

    # ---- pop the send queue on injection ----
    injected = can_inj
    q_fid = s.q_fid + injected.to(I32)
    pkt_done = injected & (q_fid >= head[:, Q_NFL])
    q_head = where(pkt_done, (s.q_head + 1) % qp, s.q_head)
    q_size = where(pkt_done, s.q_size - 1, s.q_size)
    q_fid = where(pkt_done, 0, q_fid)

    n_defl = (deflect & cand_valid).sum(dtype=I32)
    stats = bump_all(s.stats, [("injected", injected),
                               ("deflections", n_defl)])
    s = s._replace(q_head=q_head, q_size=q_size, q_fid=q_fid, stats=stats)
    return s, ArbResult(out, ej_port, has_ej, n_defl,
                        injected.sum(dtype=I32))


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
