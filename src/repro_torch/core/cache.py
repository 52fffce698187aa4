"""Phase 1: LSPD cache / directory / migration FSM over all nodes at once.

The PyTorch counterpart of the JAX package's ``repro.core.cache``: rules
S1..S14 of the serial golden model as masked dense tensor ops, leaf for
leaf the same.  Directory accesses are always performed by the tag's
home node, which makes the ``home`` directory layout fully local.

Every update is out of place (a phase returns new tensors and never
writes into its input state), because later reads in the same phase see
the pre-update values, as in the JAX code.  Masked-off rows of a gather
or scatter are routed to explicit sink slots (the directory's last
entry, the send queue's slot ``send_queue``) or clipped, because a torch
index out of range raises where JAX clamps.
"""
from __future__ import annotations

import functools
from typing import List, NamedTuple, Tuple, Union

import torch

from .config import (
    FLITS_OF,
    INSTALL_L1_ONLY,
    INSTALL_L2,
    MSG_B2,
    MSG_DA,
    MSG_DR,
    MSG_DU,
    MSG_MIG_ACK,
    MSG_NACK,
    MSG_RA,
    MSG_REQ,
    MSG_REQ_FWD,
    MSG_WB,
    ST_DONE,
    ST_IDLE,
    ST_L1_WAIT,
    ST_L2_WAIT,
    ST_WAIT_DATA,
    ST_WAIT_DIR,
    ST_WAIT_MEM,
    SimConfig,
)
from .state import (
    I32,
    NodeCtx,
    P_OSRC,
    P_SRC,
    P_TAG,
    P_TYP,
    P_VALID,
    SimState,
    bump_all,
)

BIG = 1 << 30
Value = Union[torch.Tensor, int]

#: S14 — worst-case packets a handler may enqueue, by message type
#: (REQ, RA, NACK, DA, DR, DU, WB, B2, MIG_ACK, REQ_FWD)
NEED_OF = (2, 1, 0, 1, 1, 0, 0, 3, 0, 2)


@functools.lru_cache(maxsize=None)
def _table(values: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=I32, device=device)


def argmax(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """First index of the maximum along ``dim`` (int64).  Bool masks are
    read as 0/1, so this is the first True (0 when there is none), as
    ``jnp.argmax`` gives."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    return torch.argmax(x, dim=dim)


def argmin(x: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """First index of the minimum along ``dim`` (int64)."""
    if x.dtype == torch.bool:
        x = x.view(torch.uint8)
    return torch.argmin(x, dim=dim)


def _fits(cond: torch.Tensor, t: torch.Tensor) -> bool:
    """Does ``cond`` broadcast to ``t``'s shape without growing it?"""
    cs, ts = cond.shape, t.shape
    if cs == ts:
        return True
    k = len(ts) - len(cs)
    return k >= 0 and all(c == 1 or c == s for c, s in zip(cs, ts[k:]))


def where(cond: torch.Tensor, a: Value, b: Value) -> torch.Tensor:
    """``torch.where`` that takes a Python int for either branch without
    making a tensor of it: ``masked_fill`` is one op where a wrapped
    scalar costs three (the CPU and the launch count both feel it)."""
    if isinstance(a, int) and isinstance(b, torch.Tensor) and _fits(cond, b):
        return b.masked_fill(cond, a)
    if isinstance(b, int) and isinstance(a, torch.Tensor) and _fits(cond, a):
        return a.masked_fill(~cond, b)
    return torch.where(cond, a, b)


def set_where(t: torch.Tensor, idx, mask: torch.Tensor,
              val: Value) -> torch.Tensor:
    """Out-of-place ``t.at[idx].set(where(mask, val, t[idx]))``: a copy of
    ``t`` whose entries at ``idx`` take ``val`` where ``mask`` holds.  The
    index rows must be distinct (one per node) wherever ``mask`` holds."""
    out = t.clone()
    out[idx] = where(mask, val, t[idx])
    return out


class Desc(NamedTuple):
    """A packet descriptor slot: one potential enqueue per node."""

    valid: torch.Tensor  # (Nl,) bool
    typ: Value
    dst: Value
    osrc: Value
    tag: Value


def empty_desc(n: int, device) -> Desc:
    z = torch.zeros(n, dtype=I32, device=device)
    return Desc(torch.zeros(n, dtype=torch.bool, device=device), z, z, z, z)


def merge_desc(a: Desc, b: Desc) -> Desc:
    """Merge two descriptor sets with disjoint valid masks (``a``'s fields
    are tensors; ``b``'s may be Python ints)."""
    pick = b.valid
    return Desc(a.valid | b.valid,
                where(pick, b.typ, a.typ),
                where(pick, b.dst, a.dst),
                where(pick, b.osrc, a.osrc),
                where(pick, b.tag, a.tag))


def dir_home_v(cfg: SimConfig, tag: torch.Tensor,
               central: torch.Tensor) -> torch.Tensor:
    """Home node of a directory entry; ``central`` is the per-scenario
    knob (``SimState.knob_central``)."""
    home = where(tag >= 0, tag % cfg.num_nodes, 0)
    return where(central > 0, 0, home)


def dir_read(dir_loc: torch.Tensor, cfg: SimConfig, ctx: NodeCtx,
             tag: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Directory lookup — only ever executed by the tag's home node.
    Masked-off rows read the sink slot."""
    if cfg.dir_layout == "flat":
        idx = where(mask & (tag >= 0), tag, dir_loc.shape[0] - 1)
        return dir_loc[idx]
    col = where(mask & (tag >= 0), tag // cfg.num_nodes,
                dir_loc.shape[1] - 1)
    return dir_loc[ctx.node, col]


def dir_write(dir_loc: torch.Tensor, cfg: SimConfig, ctx: NodeCtx,
              tag: torch.Tensor, val: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    # masked-off rows are routed to the sink slot and write its current
    # value back, so the sink stays at its initial -1 (dir_read discards
    # sink values via the same mask)
    eff = mask & (tag >= 0)
    if cfg.dir_layout == "flat":
        idx = (where(eff, tag, dir_loc.shape[0] - 1),)
    else:
        idx = (ctx.node, where(eff, tag // cfg.num_nodes,
                               dir_loc.shape[1] - 1))
    return set_where(dir_loc, idx, eff, val)


# --------------------------------------------------------------------------
# cache probes
# --------------------------------------------------------------------------

def l2_probe(s: SimState, cfg: SimConfig, ctx: NodeCtx, tag2: torch.Tensor):
    """Returns (set_idx, hit_way, hit) for an L2 associative probe."""
    si = where(tag2 >= 0, tag2 % cfg.cache.l2_sets, 0)
    tags = s.l2_tag[ctx.node, si]                  # (Nl, W2)
    hm = (tags == tag2[:, None]) & (tag2[:, None] >= 0)
    return si, argmax(hm), hm.any(dim=1)


def l1_probe(s: SimState, cfg: SimConfig, ctx: NodeCtx, addr: torch.Tensor):
    ca = cfg.cache
    tag1 = where(addr >= 0, addr >> ca.l1_shift, -1)
    si = where(tag1 >= 0, tag1 % ca.l1_sets, 0)
    tags = s.l1_tag[ctx.node, si]
    hm = (tags == tag1[:, None]) & (tag1[:, None] >= 0)
    return tag1, si, argmax(hm), hm.any(dim=1)


# --------------------------------------------------------------------------
# installs (S3, S5)
# --------------------------------------------------------------------------

class L2Install(NamedTuple):
    l2_tag: torch.Tensor
    l2_mig: torch.Tensor
    l2_last: torch.Tensor
    l2_streak: torch.Tensor
    ok: torch.Tensor            # install succeeded (or already present)
    did: torch.Tensor           # wrote a new block (touch needed)
    touch_set: torch.Tensor
    touch_way: torch.Tensor
    desc_duv: Desc              # remote victim dir delete
    desc_dun: Desc              # remote new-owner dir update
    dirw_vic: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # tag, val, mask
    dirw_new: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
    n_local_updates: torch.Tensor
    n_drops: torch.Tensor


def install_l2(s: SimState, cfg: SimConfig, ctx: NodeCtx, mask: torch.Tensor,
               tag2: torch.Tensor) -> L2Install:
    """S5 — masked L2 install with victim eviction + directory maintenance."""
    node, nid = ctx.node, ctx.node_id
    si, _, present_any = l2_probe(s, cfg, ctx, where(mask, tag2, -1))
    present = mask & present_any
    need = mask & ~present

    tags = s.l2_tag[node, si]                        # (Nl, W2)
    migf = s.l2_mig[node, si]
    lru = s.l2_lru[node, si]
    inv = tags < 0
    has_inv = inv.any(dim=1)
    inv_way = argmax(inv)
    lru_key = lru + migf * BIG
    lru_way = argmin(lru_key)
    all_mig = (migf > 0).all(dim=1)
    vic_way = where(has_inv, inv_way, lru_way)
    fail = need & ~has_inv & all_mig
    do = need & ~fail
    vic_valid = do & ~has_inv
    vtag = tags[node, vic_way]

    # victim directory delete (S4)
    homev = dir_home_v(cfg, vtag, s.knob_central)
    vlocal = vic_valid & (homev == nid)
    vremote = vic_valid & ~vlocal
    cur_v = dir_read(s.dir_loc, cfg, ctx, vtag, vlocal)
    vval = where(cur_v == nid, -1, cur_v)
    desc_duv = Desc(vremote, MSG_DU, homev, -1, vtag)

    # write the new block
    at = (node, si, vic_way)
    l2_tag = set_where(s.l2_tag, at, do, tag2)
    l2_mig = set_where(s.l2_mig, at, do, 0)
    l2_last = set_where(s.l2_last, at, do, -1)
    l2_streak = set_where(s.l2_streak, at, do, 0)

    # new-owner directory update
    homen = dir_home_v(cfg, tag2, s.knob_central)
    nlocal = do & (homen == nid)
    nremote = do & ~nlocal
    desc_dun = Desc(nremote, MSG_DU, homen, nid, tag2)

    return L2Install(
        l2_tag, l2_mig, l2_last, l2_streak,
        ok=present | do, did=do,
        touch_set=si, touch_way=vic_way,
        desc_duv=desc_duv, desc_dun=desc_dun,
        dirw_vic=(vtag, vval, vlocal),
        dirw_new=(tag2, nid, nlocal),
        n_local_updates=vlocal.sum(dtype=I32) + nlocal.sum(dtype=I32),
        n_drops=fail.sum(dtype=I32),
    )


class L1Install(NamedTuple):
    l1_tag: torch.Tensor
    l1_owner: torch.Tensor
    touch_set: torch.Tensor
    touch_way: torch.Tensor
    touch: torch.Tensor         # mask: a touch happened
    desc_wb: Desc
    n_wb_sent: torch.Tensor
    n_wb_miss: torch.Tensor


def install_l1(s: SimState, cfg: SimConfig, ctx: NodeCtx, mask: torch.Tensor,
               addr: torch.Tensor, owner: torch.Tensor) -> L1Install:
    """S3 — masked L1 install with victim write-back."""
    ca = cfg.cache
    node, nid = ctx.node, ctx.node_id
    tag1, si, hw, present_any = l1_probe(s, cfg, ctx,
                                         where(mask, addr, -1))
    present = mask & present_any
    need = mask & ~present

    tags = s.l1_tag[node, si]
    lru = s.l1_lru[node, si]
    inv = tags < 0
    has_inv = inv.any(dim=1)
    inv_way = argmax(inv)
    lru_way = argmin(lru)
    vic_way = where(has_inv, inv_way, lru_way)
    vic_valid = need & ~has_inv
    vtag1 = tags[node, vic_way]
    vowner = s.l1_owner[node, si, vic_way]
    vtag2 = where(vtag1 >= 0, vtag1 >> (ca.l2_shift - ca.l1_shift), -1)

    # local write-back: does our own L2 still hold the victim's block?
    wb_local = vic_valid & (vowner == nid)
    _, _, l2has = l2_probe(s, cfg, ctx, where(wb_local, vtag2, -1))
    n_wb_miss = (wb_local & ~l2has).sum(dtype=I32)
    wb_remote = vic_valid & (vowner >= 0) & (vowner != nid)
    desc_wb = Desc(wb_remote, MSG_WB, vowner, nid, vtag2)

    way = where(present, hw, vic_way)
    w = present | need
    at = (node, si, way)
    l1_tag = set_where(s.l1_tag, at, w, tag1)
    l1_owner = set_where(s.l1_owner, at, w, owner)
    return L1Install(l1_tag, l1_owner, si, way, w, desc_wb,
                     wb_remote.sum(dtype=I32), n_wb_miss)


# --------------------------------------------------------------------------
# send-queue commit (S2)
# --------------------------------------------------------------------------

def commit_queue(s: SimState, cfg: SimConfig, ctx: NodeCtx,
                 descs: List[Desc], bumps: List[Tuple[str, torch.Tensor]]
                 ) -> SimState:
    """Append descriptors (in slot order = serial enqueue order) to the
    per-node packet ring buffer; whole packets are dropped when full.
    Then add the phase's statistic increments ``bumps`` and the drops.

    Descriptor d_i lands at ring offset equal to the number of earlier
    accepted descriptors; rejected or invalid rows are routed to the sink
    slot (index ``send_queue``), which is never read.  The descriptors are
    written in slot order, one row per node each, so where several rows
    of a node land in the sink the last one stays there, as in the JAX
    package's single scatter.
    """
    n = s.q_size.shape[0]
    node = ctx.node
    qp = cfg.send_queue
    flits = _table(FLITS_OF, s.q_size.device)
    q_size, pkt_ctr = s.q_size, s.pkt_ctr

    q_desc = s.q_desc.clone()
    off = torch.zeros(n, dtype=I32, device=q_size.device)
    drops = 0
    for d in descs:
        ok = d.valid & (q_size + off < qp)
        drops = drops + (d.valid & ~ok).sum(dtype=I32)
        pkt = (pkt_ctr + off) & (cfg.pkt_wrap - 1)
        row = torch.stack(
            [d.typ, d.dst, d.osrc, d.tag, pkt,
             flits[torch.clamp(d.typ, 0, len(FLITS_OF) - 1)]], dim=-1)
        pos = where(ok, (s.q_head + q_size + off) % qp, qp)
        q_desc[node, pos] = row
        off = off + ok.to(I32)

    stats = bump_all(s.stats, bumps + [("send_drop", drops)])
    return s._replace(q_desc=q_desc, q_size=q_size + off,
                      pkt_ctr=pkt_ctr + off, stats=stats)


# --------------------------------------------------------------------------
# phase 1a — inbound completion handlers
# --------------------------------------------------------------------------

def _l1_install_would_wb(s: SimState, cfg: SimConfig, ctx: NodeCtx,
                         mask: torch.Tensor, addr: torch.Tensor) -> torch.Tensor:
    """Need probe: would :func:`install_l1` send a remote victim
    write-back?  Pure reads — mirrors install_l1's victim selection
    (first invalid way, else LRU) without the install scatters."""
    node = ctx.node
    _, si, _, present_any = l1_probe(s, cfg, ctx, where(mask, addr, -1))
    need_i = mask & ~present_any
    tags = s.l1_tag[node, si]
    has_inv = (tags < 0).any(dim=1)
    lru_way = argmin(s.l1_lru[node, si])
    vowner = s.l1_owner[node, si, lru_way]
    return need_i & ~has_inv & (vowner >= 0) & (vowner != ctx.node_id)


def _l2_install_du_count(s: SimState, cfg: SimConfig, ctx: NodeCtx,
                         mask: torch.Tensor, tag2: torch.Tensor) -> torch.Tensor:
    """Need probe: how many remote directory updates (DU packets) would
    :func:`install_l2` enqueue?  Pure reads — mirrors install_l2's
    victim selection (invalid way, else non-migrating LRU, else fail)
    without the install scatters."""
    node, nid = ctx.node, ctx.node_id
    si, _, present_any = l2_probe(s, cfg, ctx, where(mask, tag2, -1))
    need_i = mask & ~present_any
    tags = s.l2_tag[node, si]
    migf = s.l2_mig[node, si]
    has_inv = (tags < 0).any(dim=1)
    lru_key = s.l2_lru[node, si] + migf * BIG
    lru_way = argmin(lru_key)
    all_mig = (migf > 0).all(dim=1)
    do = need_i & ~(~has_inv & all_mig)           # install fails when every
    vic_valid = do & ~has_inv                     # way is pinned migrating
    vtag = tags[node, lru_way]
    duv = vic_valid & (dir_home_v(cfg, vtag, s.knob_central) != nid)
    dun = do & (dir_home_v(cfg, tag2, s.knob_central) != nid)
    return duv.to(I32) + dun.to(I32)


def phase1a(s: SimState, cfg: SimConfig, ctx: NodeCtx) -> SimState:
    n = ctx.node_id.shape[0]
    dev = ctx.node_id.device
    node, nid = ctx.node, ctx.node_id
    bumps = []   # (statistic, increment), added once by commit_queue

    # the handler always serves the *head* of the pending-completion queue
    # (FIFO; depth 1 = the paper's single S14 register)
    head = s.pc[:, 0]
    pc_valid = head[:, P_VALID] > 0
    typ = head[:, P_TYP]
    src = head[:, P_SRC]
    osrc = head[:, P_OSRC]
    tag = head[:, P_TAG]

    p_req = pc_valid & ((typ == MSG_REQ) | (typ == MSG_REQ_FWD))
    p_ra = pc_valid & (typ == MSG_RA)
    p_da = pc_valid & (typ == MSG_DA)
    p_dr = pc_valid & (typ == MSG_DR)
    p_b2 = pc_valid & (typ == MSG_B2)
    p_wb = pc_valid & (typ == MSG_WB)
    p_ack = pc_valid & (typ == MSG_MIG_ACK)

    # shared L2 probe on the completion tag (masked by the head's message
    # type, not by the fire decision — the exact-need gate below must see
    # the probe before deciding whether the handler fires this cycle)
    probe_mask = p_req | p_wb | p_ack
    si, hw, l2hit_any = l2_probe(s, cfg, ctx,
                                 where(probe_mask, tag, -1))
    hit_at = (node, si, hw)

    # S14: backpressure — defer until the send queue can hold the response.
    # pc_depth=1 gates on the worst-case NEED table; with a queue
    # (pc_depth > 1) the head is gated on the EXACT number of packets this
    # handler will enqueue.
    if cfg.pc_depth > 1:
        req_hit_p = p_req & l2hit_any
        mig_ok_p = (req_hit_p & (s.knob_mig > 0) & (osrc != nid)
                    & (s.l2_mig[hit_at] == 0))
        streak_p = where(s.l2_last[hit_at] == osrc,
                         s.l2_streak[hit_at] + 1, 1)
        trig_p = mig_ok_p & (streak_p >= s.knob_mig_thr)
        ra_ok_p = p_ra & (s.st == ST_WAIT_DATA)
        ra_wb_p = _l1_install_would_wb(s, cfg, ctx, ra_ok_p, s.pend_addr)
        b2_du_p = _l2_install_du_count(s, cfg, ctx, p_b2, tag)
        dr_req_p = p_dr & (s.st == ST_WAIT_DIR) & (osrc >= 0)
        need = (p_req.to(I32) + trig_p.to(I32)        # RA/NACK/FWD + B2
                + ra_wb_p.to(I32)                     # RA victim WB
                + p_da.to(I32)                        # DR reply
                + dr_req_p.to(I32)                    # REQ to owner
                + p_b2.to(I32)                        # MIG_ACK
                + b2_du_p)                            # install_l2 DUs
    else:
        need = _table(NEED_OF, dev)[torch.clamp(typ, 0, 9)]
    valid = pc_valid & (s.q_size + need <= cfg.send_queue)
    if cfg.pc_depth > 1:
        # guaranteed drain: a FULL queue must make progress every cycle —
        # the head fires even without space; response packets that do not
        # fit are dropped whole by commit_queue (send_drop) and recovered
        # by the requester's req_timeout retry.
        pc_full = ((s.pc[:, :, P_VALID] > 0).sum(dim=1, dtype=I32)
                   >= cfg.pc_depth)
        valid = valid | (pc_valid & pc_full)

    is_req = valid & p_req
    is_ra = valid & p_ra
    is_nack = valid & (typ == MSG_NACK)
    is_da = valid & p_da
    is_dr = valid & p_dr
    is_du = valid & (typ == MSG_DU)
    is_wb = valid & p_wb
    is_b2 = valid & p_b2
    is_ack = valid & p_ack
    l2hit = (is_req | is_wb | is_ack) & l2hit_any

    d0 = empty_desc(n, dev)
    d1 = d0
    d2 = d0

    st, ctr, imode = s.st, s.ctr, s.install_mode
    l2_tag, l2_mig = s.l2_tag, s.l2_mig
    l2_last, l2_streak = s.l2_last, s.l2_streak
    fwd_tag, fwd_dst, fwd_ptr = s.fwd_tag, s.fwd_dst, s.fwd_ptr
    dir_loc = s.dir_loc

    # ---- REQ / REQ_FWD: remote access service + migration trigger ----
    req_hit = is_req & l2hit
    req_miss = is_req & ~l2hit
    bumps.append(("req_rcvd", is_req))
    bumps.append(("reply_sent", req_hit))
    d0 = merge_desc(d0, Desc(req_hit, MSG_RA, osrc, osrc, tag))

    mig_ok = (req_hit & (s.knob_mig > 0) & (osrc != nid)
              & (l2_mig[hit_at] == 0))
    streak_new = where(l2_last[hit_at] == osrc,
                       l2_streak[hit_at] + 1, 1)
    l2_last = set_where(l2_last, hit_at, mig_ok, osrc)
    l2_streak = set_where(l2_streak, hit_at, mig_ok, streak_new)
    trig = mig_ok & (streak_new >= s.knob_mig_thr)
    l2_mig = set_where(l2_mig, hit_at, trig, 1)
    d1 = merge_desc(d1, Desc(trig, MSG_B2, osrc, nid, tag))
    bumps.append(("migrations", trig))

    fwd_hm = (fwd_tag == tag[:, None]) & req_miss[:, None]
    fwd_found = fwd_hm.any(dim=1)
    fwd_to = fwd_dst[node, argmax(fwd_hm)]
    redir = req_miss & fwd_found & (fwd_to >= 0) & (fwd_to != nid)
    trap = req_miss & ~redir
    d0 = merge_desc(d0, Desc(redir, MSG_REQ_FWD, fwd_to, osrc, tag))
    d0 = merge_desc(d0, Desc(trap, MSG_NACK, osrc, osrc, tag))
    bumps.append(("redirection", redir))
    bumps.append(("trap", trap))

    # ---- RA (data reply) ----
    ra_ok = is_ra & (st == ST_WAIT_DATA)
    bumps.append(("reply_rcvd", ra_ok))
    bumps.append(("stray", is_ra & ~ra_ok))
    ins1 = install_l1(s, cfg, ctx, ra_ok, s.pend_addr, src)
    d0 = merge_desc(d0, ins1.desc_wb)
    bumps.append(("wb_sent", ins1.n_wb_sent))
    bumps.append(("wb_miss", ins1.n_wb_miss))
    st = where(ra_ok, ST_IDLE, st)

    # ---- NACK (trap reply) ----
    nk_ok = is_nack & (st == ST_WAIT_DATA)
    bumps.append(("stray", is_nack & ~nk_ok))
    st = where(nk_ok, ST_WAIT_MEM, st)
    ctr = where(nk_ok, cfg.mem_cycles, ctr)
    imode = where(nk_ok, INSTALL_L1_ONLY, imode)
    bumps.append(("mem_req", nk_ok))

    # ---- DA (directory lookup at home, S6 reserve-on-miss) ----
    bumps.append(("dir_search", is_da))
    owner0 = dir_read(dir_loc, cfg, ctx, tag, is_da)
    reserve = is_da & ((owner0 < 0) | (owner0 == osrc))
    owner_rep = where(reserve, -1, owner0)
    d0 = merge_desc(d0, Desc(is_da, MSG_DR, osrc, owner_rep, tag))

    # ---- DR (directory reply) ----
    dr_ok = is_dr & (st == ST_WAIT_DIR)
    bumps.append(("stray", is_dr & ~dr_ok))
    dr_owner = osrc
    dr_req = dr_ok & (dr_owner >= 0)
    dr_mem = dr_ok & (dr_owner < 0)
    d0 = merge_desc(d0, Desc(dr_req, MSG_REQ, dr_owner, nid, tag))
    bumps.append(("req_made", dr_req))
    st = where(dr_req, ST_WAIT_DATA, st)
    if cfg.pc_depth > 1:   # arm the transaction timeout (see phase1b)
        ctr = where(dr_req, cfg.req_timeout, ctr)
    st = where(dr_mem, ST_WAIT_MEM, st)
    ctr = where(dr_mem, cfg.mem_cycles, ctr)
    imode = where(dr_mem, INSTALL_L2, imode)
    bumps.append(("mem_req", dr_mem))

    # ---- DU (directory update) ----
    bumps.append(("dir_update", is_du))
    du_cur = dir_read(dir_loc, cfg, ctx, tag, is_du)
    du_val = where(osrc < 0,
                   where(du_cur == src, -1, du_cur),
                   osrc)

    # ---- WB (L1 victim write-back arriving at the block's L2 home) ----
    wb_hit = is_wb & l2hit
    bumps.append(("wb_rcvd", is_wb))
    bumps.append(("wb_miss", is_wb & ~l2hit))

    # ---- B2 (migration arrival) ----
    bumps.append(("migrations_done", is_b2))
    s_tmp = s._replace(l2_tag=l2_tag, l2_mig=l2_mig, l2_last=l2_last,
                       l2_streak=l2_streak)
    ins2 = install_l2(s_tmp, cfg, ctx, is_b2, tag)
    l2_tag, l2_mig = ins2.l2_tag, ins2.l2_mig
    l2_last, l2_streak = ins2.l2_last, ins2.l2_streak
    d0 = merge_desc(d0, ins2.desc_duv)
    d1 = merge_desc(d1, ins2.desc_dun)
    ack_osrc = where(ins2.ok, nid, -1)
    d2 = merge_desc(d2, Desc(is_b2, MSG_MIG_ACK, src, ack_osrc, tag))
    bumps.append(("dir_update", ins2.n_local_updates))
    bumps.append(("l2_install_drop", ins2.n_drops))

    # ---- MIG_ACK (S13) ----
    ak_succ = is_ack & (osrc >= 0) & l2hit & (l2_mig[hit_at] > 0)
    l2_tag = set_where(l2_tag, hit_at, ak_succ, -1)
    l2_mig = set_where(l2_mig, hit_at, ak_succ, 0)
    ak_ins = is_ack & (osrc >= 0)
    p = fwd_ptr % cfg.fwd_entries
    fwd_tag = set_where(fwd_tag, (node, p), ak_ins, tag)
    fwd_dst = set_where(fwd_dst, (node, p), ak_ins, osrc)
    fwd_ptr = where(ak_ins, p + 1, fwd_ptr)
    ak_fail = is_ack & (osrc < 0) & l2hit
    l2_mig = set_where(l2_mig, hit_at, ak_fail, 0)
    l2_streak = set_where(l2_streak, hit_at, ak_fail, 0)

    # ---- directory scatters (disjoint per entry — one handler per node,
    # same entry ⇒ same home ⇒ same node) ----
    da_res = is_da & reserve
    mA = da_res | is_du | ins2.dirw_vic[2]
    idxA = where(da_res, tag, where(is_du, tag, ins2.dirw_vic[0]))
    valA = where(da_res, osrc,
                 where(is_du, du_val, ins2.dirw_vic[1]))
    dir_loc = dir_write(dir_loc, cfg, ctx, idxA, valA, mA)
    dir_loc = dir_write(dir_loc, cfg, ctx, *ins2.dirw_new)

    # ---- single 1a LRU touch site (serial: ≤1 touch per node in 1a) ----
    l2touch = req_hit | wb_hit | ins2.did
    l1touch = ins1.touch
    clock = s.lru_clock + (l2touch | l1touch).to(I32)
    tsi = where(ins2.did, ins2.touch_set, si)
    twy = where(ins2.did, ins2.touch_way, hw)
    l2_lru = set_where(s.l2_lru, (node, tsi, twy), l2touch, clock)
    l1_lru = set_where(s.l1_lru, (node, ins1.touch_set, ins1.touch_way),
                       l1touch, clock)

    s = s._replace(
        st=st, ctr=ctr, install_mode=imode, lru_clock=clock,
        l1_tag=ins1.l1_tag, l1_owner=ins1.l1_owner, l1_lru=l1_lru,
        l2_tag=l2_tag, l2_lru=l2_lru, l2_mig=l2_mig, l2_last=l2_last,
        l2_streak=l2_streak, dir_loc=dir_loc,
        fwd_tag=fwd_tag, fwd_dst=fwd_dst, fwd_ptr=fwd_ptr,
        # pop the served head: shift the queue down one slot (depth 1:
        # this zeroes the register)
        pc=where(valid[:, None, None],
                 torch.cat([s.pc[:, 1:], torch.zeros_like(s.pc[:, :1])],
                           dim=1),
                 s.pc),
    )
    return commit_queue(s, cfg, ctx, [d0, d1, d2], bumps)


# --------------------------------------------------------------------------
# phase 1b — trace-driven FSM
# --------------------------------------------------------------------------

def _next_addr(s: SimState, ctx: NodeCtx, tr_ptr: torch.Tensor):
    m = s.trace.shape[1]
    ptr = torch.clamp(tr_ptr, 0, m - 1)
    # trace stays in its storage dtype (read-only (N, M) block) — widen
    # after the gather, not the whole tensor
    a = s.trace[ctx.node, ptr].to(I32)
    exhausted = (tr_ptr >= m) | (a < 0)
    return where(exhausted, -1, a), exhausted


def phase1b(s: SimState, cfg: SimConfig, ctx: NodeCtx) -> SimState:
    n = ctx.node_id.shape[0]
    dev = ctx.node_id.device
    ca = cfg.cache
    node, nid = ctx.node, ctx.node_id
    bumps = []   # (statistic, increment), added once by commit_queue
    st, ctr = s.st, s.ctr

    d0 = empty_desc(n, dev)
    d1 = d0
    d2 = d0

    addr, exhausted = _next_addr(s, ctx, s.tr_ptr)

    # S14: per-state send-queue space requirements gate FSM "fire" points
    space = cfg.send_queue - s.q_size

    # ---- IDLE: consume one trace address ----
    idle = st == ST_IDLE
    go_done = idle & exhausted
    consume = idle & ~exhausted
    _, si1, hw1, l1hit_any = l1_probe(s, cfg, ctx,
                                      where(consume, addr, -1))
    l1hit = consume & l1hit_any
    l1miss = consume & ~l1hit_any
    bumps.append(("l1_hits", l1hit))
    bumps.append(("l1_misses", l1miss))
    tr_ptr = s.tr_ptr + consume.to(I32)
    pend_addr = where(l1miss, addr, s.pend_addr)
    st = where(go_done, ST_DONE, st)
    st = where(l1miss, ST_L1_WAIT, st)
    ctr = where(l1miss, cfg.l1_miss_cycles, ctr)

    # ---- L1_WAIT: countdown then local-L2 probe / directory ----
    l1w = s.st == ST_L1_WAIT
    ctr = where(l1w, ctr - 1, ctr)
    l1w_fire0 = l1w & (ctr <= 0)
    l1w_fire = l1w_fire0 & (space >= 1)
    ctr = where(l1w_fire0 & ~l1w_fire, 1, ctr)
    tag2 = where(s.pend_addr >= 0, s.pend_addr >> ca.l2_shift, -1)
    _, _, l2hit_any = l2_probe(s, cfg, ctx, where(l1w_fire, tag2, -1))
    l2hit = l1w_fire & l2hit_any
    l2miss = l1w_fire & ~l2hit_any
    bumps.append(("l2_local_hits", l2hit))
    bumps.append(("l2_local_misses", l2miss))
    st = where(l2hit, ST_L2_WAIT, st)
    ctr = where(l2hit, cfg.l2_hit_cycles, ctr)

    home = dir_home_v(cfg, tag2, s.knob_central)
    inline = l2miss & (home == nid)           # S8
    remote = l2miss & ~inline
    bumps.append(("dir_search", inline))
    owner0 = dir_read(s.dir_loc, cfg, ctx, tag2, inline)
    inl_req = inline & (owner0 >= 0) & (owner0 != nid)
    inl_mem = inline & ~inl_req
    d0 = merge_desc(d0, Desc(inl_req, MSG_REQ, owner0, nid, tag2))
    bumps.append(("req_made", inl_req))
    st = where(inl_req, ST_WAIT_DATA, st)
    st = where(inl_mem, ST_WAIT_MEM, st)
    ctr = where(inl_mem, cfg.mem_cycles, ctr)
    imode = where(inl_mem, INSTALL_L2, s.install_mode)
    bumps.append(("mem_req", inl_mem))
    dir_loc = dir_write(s.dir_loc, cfg, ctx, tag2, nid, inl_mem)  # reserve (S6)

    d0 = merge_desc(d0, Desc(remote, MSG_DA, home, nid, tag2))
    st = where(remote, ST_WAIT_DIR, st)
    if cfg.pc_depth > 1:   # arm the transaction timeout
        ctr = where(remote | inl_req, cfg.req_timeout, ctr)

    # ---- L2_WAIT: countdown then move block into L1 ----
    l2w = s.st == ST_L2_WAIT
    ctr = where(l2w, ctr - 1, ctr)
    l2w_fire0 = l2w & (ctr <= 0)
    l2w_fire = l2w_fire0 & (space >= 1)
    ctr = where(l2w_fire0 & ~l2w_fire, 1, ctr)
    si2f, hw2f, l2f_hit = l2_probe(s, cfg, ctx,
                                   where(l2w_fire, tag2, -1))
    l2f_touch = l2w_fire & l2f_hit

    # ---- WAIT_MEM: countdown then install ----
    wm = s.st == ST_WAIT_MEM
    ctr = where(wm, ctr - 1, ctr)
    wm_fire0 = wm & (ctr <= 0)
    wm_fire = wm_fire0 & (space >= 3)
    ctr = where(wm_fire0 & ~wm_fire, 1, ctr)
    wm_wait = wm & ~wm_fire0
    wm_l2 = wm_fire & (s.install_mode == INSTALL_L2)
    wm_l1o = wm_fire & (s.install_mode == INSTALL_L1_ONLY)

    ins2 = install_l2(s._replace(dir_loc=dir_loc), cfg, ctx, wm_l2, tag2)
    d0 = merge_desc(d0, ins2.desc_duv)
    d1 = merge_desc(d1, ins2.desc_dun)
    bumps.append(("dir_update", ins2.n_local_updates))
    bumps.append(("l2_install_drop", ins2.n_drops))
    dir_loc = dir_write(dir_loc, cfg, ctx, *ins2.dirw_vic)
    dir_loc = dir_write(dir_loc, cfg, ctx, *ins2.dirw_new)

    # ---- WAIT_DIR / WAIT_DATA transaction timeout (pc_depth > 1 only):
    #      restart with a fresh DA to the tag's home — retransmit-once
    #      recovery for responses the guaranteed drain had to drop; a
    #      stale duplicate response later lands in `stray` ----
    if cfg.pc_depth > 1:
        wt = (s.st == ST_WAIT_DIR) | (s.st == ST_WAIT_DATA)
        ctr = where(wt, ctr - 1, ctr)
        rt_fire0 = wt & (ctr <= 0)
        rt_fire = rt_fire0 & (space >= 1)
        ctr = where(rt_fire0 & ~rt_fire, 1, ctr)
        d0 = merge_desc(d0, Desc(rt_fire, MSG_DA, home, nid, tag2))
        st = where(rt_fire, ST_WAIT_DIR, st)
        ctr = where(rt_fire, cfg.req_timeout, ctr)

    # ---- hit-under-miss (S7) in WAIT_DIR / WAIT_DATA / counting WAIT_MEM ----
    waiting = (s.st == ST_WAIT_DIR) | (s.st == ST_WAIT_DATA) | wm_wait
    h_addr, h_exh = _next_addr(s, ctx, tr_ptr)
    h_try = waiting & ~h_exh
    _, hsi, hhw, hum_hit_any = l1_probe(s, cfg, ctx,
                                        where(h_try, h_addr, -1))
    hum = h_try & hum_hit_any
    bumps.append(("l1_hits", hum))
    tr_ptr = tr_ptr + hum.to(I32)

    # ---- touch site 2 (first 1b touch: IDLE L1 hit | L2_WAIT L2 touch |
    #      install_l2 new-block touch | hit-under-miss L1 touch) ----
    t2_l1 = l1hit | hum
    t2_l2 = l2f_touch | ins2.did
    clock = s.lru_clock + (t2_l1 | t2_l2).to(I32)
    t2_l1_at = (node, where(l1hit, si1, hsi),
                where(l1hit, hw1, hhw))
    l1_lru = set_where(s.l1_lru, t2_l1_at, t2_l1, clock)
    t2_l2_at = (node, where(l2f_touch, si2f, ins2.touch_set),
                where(l2f_touch, hw2f, ins2.touch_way))
    l2_lru = set_where(s.l2_lru, t2_l2_at, t2_l2, clock)

    # ---- install_l1 (touch site 3): L2_WAIT refill, WAIT_MEM installs ----
    il1_mask = l2w_fire | wm_fire
    il1_owner = where(wm_l1o, -1, nid)
    s_mid2 = s._replace(
        l1_lru=l1_lru, l2_lru=l2_lru, lru_clock=clock,
        l2_tag=ins2.l2_tag, l2_mig=ins2.l2_mig, l2_last=ins2.l2_last,
        l2_streak=ins2.l2_streak,
    )
    ins1 = install_l1(s_mid2, cfg, ctx, il1_mask, s.pend_addr, il1_owner)
    d2 = merge_desc(d2, ins1.desc_wb)
    bumps.append(("wb_sent", ins1.n_wb_sent))
    bumps.append(("wb_miss", ins1.n_wb_miss))
    clock = clock + ins1.touch.to(I32)
    l1_lru = set_where(l1_lru, (node, ins1.touch_set, ins1.touch_way),
                       ins1.touch, clock)
    st = where(il1_mask, ST_IDLE, st)

    s = s._replace(
        st=st, ctr=ctr, tr_ptr=tr_ptr, pend_addr=pend_addr,
        install_mode=imode, lru_clock=clock,
        l1_tag=ins1.l1_tag, l1_lru=l1_lru, l1_owner=ins1.l1_owner,
        l2_tag=ins2.l2_tag, l2_lru=l2_lru, l2_mig=ins2.l2_mig,
        l2_last=ins2.l2_last, l2_streak=ins2.l2_streak,
        dir_loc=dir_loc,
    )
    return commit_queue(s, cfg, ctx, [d0, d1, d2], bumps)
