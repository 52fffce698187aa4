"""Phases 2 and 3 of a cycle: bufferless deflection routing by plain ops.

Phase 2 is a frozen copy of the port's ``kernels/ref.py``
(``arbitrate_ref``, ``phase2_router_ref``): ejection, injection,
age-priority port assignment with PMDR preferences, deflection and the
send-queue pop for every router at once, in eager PyTorch and no
hand-written kernel.  Phase 3 is a frozen copy of the port's
``core/noc.py``: the neighbour gather, then delivery into the ROB and the
pending-completion queue.
"""
from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from .cache import argmax, argmin, set_where, where
from .config import Config
from .state import (F_AGE, F_DST, F_NFL, F_OSRC, F_PKT, F_SRC, F_TAG, F_TYP,
                    F_VALID, I32, P_VALID, Q_DST, Q_NFL, Q_OSRC,
                    Q_PKT, Q_TAG, Q_TYP, R_CNT, R_NFL, R_OSRC, R_PKT, R_SRC,
                    R_TAG, R_TYP, STAT_INDEX, Ctx, Geometry, SimState,
                    bump_all)

#: larger than any node id or packet counter
BIG = 1 << 30
STAT_DEFLECTIONS, STAT_INJECTED = (STAT_INDEX["deflections"],
                                   STAT_INDEX["injected"])


def arbitrate_ref(age: torch.Tensor, valid: torch.Tensor, we: torch.Tensor,
                  dc: torch.Tensor, dr: torch.Tensor,
                  vp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Age-priority greedy port assignment for all routers at once.

    Args:
      age:   (N, S) int32 candidate flit ages (S=5: 4 input ports +
             injection).
      valid: (N, S) bool candidate present.
      we:    (N, S) bool candidate wanted to eject but was refused.
      dc:    (N, S) int32 dst_col - col (sign gives the desired X direction).
      dr:    (N, S) int32 dst_row - row.
      vp:    (N, 4) bool port physically exists (mesh edges).

    Returns:
      assigned: (N, S) int32 port index in 0..3, or -1 for invalid
                candidates.
      deflect:  (N, S) bool — candidate did not get its first preference
                (or had been refused ejection).
    """
    n, s_ = age.shape
    dev = age.device
    ports = torch.arange(4, dtype=I32, device=dev)
    slot = torch.arange(s_, dtype=I32, device=dev)

    # priority key: age desc, slot asc (injection = last slot, loses ties)
    key = torch.where(valid, age * 8 + (s_ + 2 - slot), -1)

    # PMDR preference scores (S9): lower = preferred.  A desired direction
    # only scores if the port exists.
    score = (10 + ports).expand(n, s_, 4).clone()
    score[:, :, 1] = torch.where(dc > 0, 0, score[:, :, 1])
    score[:, :, 3] = torch.where(dc < 0, 0, score[:, :, 3])
    score[:, :, 2] = torch.where(dr > 0, 1, score[:, :, 2])
    score[:, :, 0] = torch.where(dr < 0, 1, score[:, :, 0])
    score = torch.where(vp[:, None, :], score, 1000)
    first_pref = torch.argmin(score, dim=2)

    taken = torch.zeros((n, 4), dtype=torch.bool, device=dev)
    done = ~valid
    assigned = torch.full((n, s_), -1, dtype=I32, device=dev)
    deflect = torch.zeros((n, s_), dtype=torch.bool, device=dev)
    for _ in range(s_):
        kk = torch.where(done, -1, key)
        best = torch.argmax(kk, dim=1)          # first index of the max
        has = kk.amax(dim=1) >= 0
        bscore = torch.take_along_dim(score, best[:, None, None], dim=1)[:, 0]
        eff = bscore + taken.to(I32) * 10000
        port = torch.argmin(eff, dim=1)         # ties -> lowest port
        onehot_b = (slot[None, :] == best[:, None]) & has[:, None]
        onehot_p = (ports[None, :] == port[:, None]) & has[:, None]
        assigned = torch.where(onehot_b, port[:, None].to(I32), assigned)
        fp = torch.take_along_dim(first_pref, best[:, None], dim=1)[:, 0]
        wej = torch.take_along_dim(we, best[:, None], dim=1)[:, 0]
        defl = wej | (port != fp)
        deflect = torch.where(onehot_b, defl[:, None], deflect)
        taken = taken | onehot_p
        done = done | onehot_b
    return assigned, deflect


class Phase2Out(NamedTuple):
    """What Phase 2 computes for every router (``N`` of them)."""

    out: torch.Tensor          # (N, 4, NUM_F) int32 outgoing flits (age bumped)
    ej_port: torch.Tensor      # (N,) int64 ejected port (0 when none)
    has_ej: torch.Tensor       # (N,) bool
    q_head: torch.Tensor       # (N,) int32 send queue after the pop
    q_size: torch.Tensor       # (N,) int32
    q_fid: torch.Tensor        # (N,) int32
    stats: torch.Tensor        # (NUM_STATS,) int32, injected/deflections bumped
    n_deflected: torch.Tensor  # () int32
    n_injected: torch.Tensor   # () int32


@functools.lru_cache(maxsize=None)
def _phase2_stat_index(device: torch.device) -> torch.Tensor:
    return torch.tensor([STAT_INJECTED, STAT_DEFLECTIONS], device=device)


def phase2_router_ref(inp: torch.Tensor, rob: torch.Tensor, pc: torch.Tensor,
                      q_desc: torch.Tensor, q_head: torch.Tensor,
                      q_size: torch.Tensor, q_fid: torch.Tensor,
                      node_id: torch.Tensor, node_r: torch.Tensor,
                      node_c: torch.Tensor, valid_port: torch.Tensor,
                      knob_ej_age: torch.Tensor, stats: torch.Tensor,
                      cols: int) -> Phase2Out:
    """Phase 2 of one cycle for every router (paper S9-S12), in int32.

    Args are the state's leaves in the compute domain (``inp`` (N, 4,
    NUM_F), ``rob`` (N, K, NUM_R), ``pc`` (N, pc_depth, NUM_P), ``q_desc``
    (N, send_queue + 1, NUM_Q), ``q_head``/``q_size``/``q_fid`` (N,),
    ``stats`` (NUM_STATS,), the 0-d ``knob_ej_age``), the routers' node
    ids, rows and columns (N,), their existing ports ``valid_port`` (N, 4)
    bool, and the mesh's column count.

    Per router: eject the oldest deliverable flit (S11), admit the send
    queue's head flit when a port is free (S12), assign output ports in
    age order (:func:`arbitrate_ref`), move each candidate to its port
    with its age bumped if it was deflected, pop the send queue, and add
    the injections and deflections to ``stats``.
    """
    dev = inp.device
    n = inp.shape[0]
    depth = pc.shape[1]
    qp = q_desc.shape[1] - 1
    node = torch.arange(n, device=dev)
    nid, vp = node_id, valid_port
    ports = torch.arange(4, dtype=I32, device=dev)
    valid_in = inp[:, :, F_VALID] > 0

    # ---- ejection (S11): oldest (age desc, port asc) deliverable flit.
    #      With an empty pending-completion queue any deliverable flit may
    #      eject; once it is occupied, only flits aged past knob_ej_age
    #      eject — into spare queue capacity while a slot is free, and
    #      into a free ROB slot (the completion parks) when it is full.
    #      pc_depth=1 keeps the paper's exact single-register bar. ----
    # S10: can each flit be ejected into the ROB
    rob_valid = rob[:, :, R_NFL] > 0                         # (N, K)
    match = (rob_valid[:, None, :]
             & (rob[:, None, :, R_SRC] == inp[:, :, F_SRC, None])
             & (rob[:, None, :, R_PKT] == inp[:, :, F_PKT, None]))
    acc = ((inp[:, :, F_NFL] == 1) | match.any(dim=-1)
           | (~rob_valid).any(dim=-1)[:, None])
    pc_cnt = (pc[:, :, P_VALID] > 0).sum(dim=1, dtype=I32)
    pc_empty = pc_cnt == 0
    if depth > 1:
        pc_has_slot = pc_cnt < depth
        rob_free = (rob[:, :, R_NFL] == 0).any(dim=1)
        # single-flit packets need a free ROB slot to park in; a
        # completing multi-flit packet parks in its own (matched) slot
        park_ok = (inp[:, :, F_NFL] > 1) | rob_free[:, None]
        old_enough = inp[:, :, F_AGE] >= knob_ej_age
        ej_ok = (pc_empty[:, None]
                 | (old_enough & (pc_has_slot[:, None] | park_ok)))
    else:
        ej_ok = pc_empty[:, None]
    want_ej = valid_in & (inp[:, :, F_DST] == nid[:, None]) & acc & ej_ok
    ej_key = (inp[:, :, F_AGE] * 4 + (3 - ports)).masked_fill(~want_ej, -1)
    ej_port = torch.argmax(ej_key, dim=1)    # first index; 0 when none
    has_ej = ej_key.amax(dim=1) >= 0
    is_ej = (ports[None, :] == ej_port[:, None]) & has_ej[:, None]
    remaining = valid_in & ~is_ej

    # ---- injection (S12) ----
    n_rem = remaining.sum(dim=1, dtype=I32)
    n_vp = vp.sum(dim=1, dtype=I32)
    head = q_desc[node, q_head % qp]                         # (N, NUM_Q)
    can_inj = (q_size > 0) & (n_rem < n_vp)
    inj = torch.stack([
        can_inj.to(I32), torch.zeros_like(nid), nid, head[:, Q_DST],
        head[:, Q_OSRC], head[:, Q_TYP], head[:, Q_TAG], head[:, Q_PKT],
        q_fid, head[:, Q_NFL],
    ], dim=-1)

    cand = torch.cat([inp.masked_fill(~remaining[:, :, None], 0),
                      inj[:, None, :]], dim=1)
    cand_valid = cand[:, :, F_VALID] > 0                     # (N, 5)

    # ---- age-priority arbitration (paper Fig. 3 "Priority Sort" + port
    #      selection) ----
    dst = cand[:, :, F_DST]
    dst_pos = dst >= 0
    dst_r = torch.where(dst_pos, dst // cols, 0)
    dst_c = torch.where(dst_pos, dst % cols, 0)
    dr_ = dst_r - node_r[:, None]
    dc_ = dst_c - node_c[:, None]
    wanted_eject = cand_valid & (dst == nid[:, None])
    age = cand[:, :, F_AGE].contiguous()
    assigned, deflect = arbitrate_ref(age, cand_valid, wanted_eject,
                                      dc_, dr_, vp)

    # ---- move candidates to their output ports: the ports are distinct,
    #      so at most one candidate lands on each port (a gather) ----
    cand[:, :, F_AGE] = age + deflect.to(I32)
    oh = ((assigned[:, :, None] == ports[None, None, :])
          & cand_valid[:, :, None])                          # (N, 5, 4)
    taken = oh.any(dim=1)                                    # (N, 4)
    src = torch.argmax(oh.view(torch.uint8), dim=1)          # first slot
    out = cand[node[:, None], src].masked_fill(~taken[:, :, None], 0)
    out[:, :, F_VALID] = taken.to(I32)

    # ---- pop the send queue on injection ----
    injected = can_inj
    q_fid = q_fid + injected.to(I32)
    pkt_done = injected & (q_fid >= head[:, Q_NFL])
    q_head = torch.where(pkt_done, (q_head + 1) % qp, q_head)
    q_size = torch.where(pkt_done, q_size - 1, q_size)
    q_fid = q_fid.masked_fill(pkt_done, 0)

    n_defl = (deflect & cand_valid).sum(dtype=I32)
    n_inj = injected.sum(dtype=I32)
    stats = stats.index_add(0, _phase2_stat_index(dev),
                            torch.stack([n_inj, n_defl]))
    return Phase2Out(out, ej_port, has_ej, q_head, q_size, q_fid, stats,
                     n_defl, n_inj)


def phase2(s: SimState, cfg: Config, ctx: Ctx) -> Tuple[SimState, Phase2Out]:
    """Eject, inject, arbitrate and route for every router."""
    r = phase2_router_ref(s.inp, s.rob, s.pc, s.q_desc, s.q_head, s.q_size,
                          s.q_fid, ctx.node_id, ctx.node_r, ctx.node_c,
                          ctx.valid_port, s.knob_ej_age, s.stats,
                          cols=cfg.cols)
    s = s._replace(q_head=r.q_head, q_size=r.q_size, q_fid=r.q_fid,
                   stats=r.stats)
    return s, r


def transfer_global(geo: Geometry, out: torch.Tensor) -> torch.Tensor:
    """Phase-3 transfer: input port p of node n reads the opposite output
    port of its neighbour in direction p."""
    moved = out[geo.gather_node, geo.gather_port[None, :]]   # (N, 4, F)
    return where(geo.valid_port[:, :, None], moved, 0)


def deliver(s: SimState, cfg: Config, ctx: Ctx, arb: Phase2Out,
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


def phase3(s: SimState, cfg: Config, geo: Geometry, ctx: Ctx,
           arb: Phase2Out) -> SimState:
    return deliver(s, cfg, ctx, arb, transfer_global(geo, arb.out))
