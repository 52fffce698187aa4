"""Plain PyTorch versions of the port's kernels.

``arbitrate_ref`` is the semantic definition of the paper's Phase-2 router
arbitration (age-priority sort + PMDR port selection + deflection), the
counterpart of the JAX package's ``repro.kernels.ref.arbitrate_ref``.  On
the CPU the simulator calls it directly; on CUDA the hand-written kernel
in :mod:`repro_torch.kernels.router_phase` runs instead and must match it
bit for bit.

``attention_ref`` is the plain version of the flash-attention kernel
(:mod:`repro_torch.kernels.flash_attention`), the counterpart of
``repro.kernels.ref.attention_ref``: the kernel must stay within
``tests/test_kernels.py``'s tolerances of it (1e-5 in float32, 5e-2 in
bfloat16).

``phase2_router_ref`` is the plain version of the fused Phase-2 router
kernel (:func:`repro_torch.kernels.router_phase.phase2_router_cuda`): all
of ``noc.phase2`` for every router at once — ejection, injection, the
arbitration above, the move of each candidate to its output port, the
send-queue pop and the two statistics.  The kernel must match it bit for
bit.

``random_arb_case`` and ``random_phase2_case`` make seeded inputs with
numpy, so the kernels can be held against these versions without the test
suite.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

I32 = torch.int32

# The state's field indices and statistics slots (``core.state``), copied
# so that this module imports nothing of ``core`` (``core.noc`` imports
# the dispatch that imports this module); a test holds the copies equal.
F_VALID, F_AGE, F_SRC, F_DST, F_OSRC, F_TYP, F_TAG, F_PKT, F_FID, F_NFL = range(10)
NUM_F = 10
Q_TYP, Q_DST, Q_OSRC, Q_TAG, Q_PKT, Q_NFL = range(6)
NUM_Q = 6
R_SRC, R_PKT, R_TYP, R_TAG, R_OSRC, R_NFL, R_CNT = range(7)
NUM_R = 7
P_VALID, P_TYP, P_SRC, P_OSRC, P_TAG = range(5)
NUM_P = 5
NUM_STATS = 25
STAT_DEFLECTIONS, STAT_INJECTED = 19, 21


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


def random_arb_case(rng: np.random.Generator, n: int):
    """Seeded arbitration inputs for ``n`` routers, as numpy arrays:
    ``(age, valid, we, dc, dr, vp)`` with the bufferless invariant (no
    router has more candidates than existing ports)."""
    age = rng.integers(0, 64, (n, 5)).astype(np.int32)
    vp = rng.random((n, 4)) < 0.85
    vp |= np.sum(vp, 1, keepdims=True) == 0
    valid = rng.random((n, 5)) < 0.6
    # bufferless invariant: candidates <= valid ports
    for i in range(n):
        nv = int(vp[i].sum())
        idx = np.where(valid[i])[0]
        for j in idx[nv:]:
            valid[i, j] = False
    we = (rng.random((n, 5)) < 0.2) & valid
    dc = rng.integers(-3, 4, (n, 5)).astype(np.int32)
    dr = rng.integers(-3, 4, (n, 5)).astype(np.int32)
    return age, valid, we, dc, dr, vp


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


#: flits a packet can have (``core.config.FLITS_OF``'s values)
_PACKET_FLITS = np.array([1, 4, 16], np.int32)


def random_phase2_case(rng: np.random.Generator, n: int, K: int,
                       pc_depth: int, send_queue: int, rows: int,
                       cols: int) -> Dict[str, np.ndarray]:
    """Seeded Phase-2 inputs for ``n`` routers of a ``rows`` x ``cols``
    mesh (router ``i`` is node ``i % (rows * cols)``), as numpy arrays
    keyed by :func:`phase2_router_ref`'s argument names.

    Every field stays inside the range the state can hold, and flits
    arrive only on existing ports, so no router has more candidates than
    ports.  The draws cover: flits addressed to the router itself,
    multi-flit packets that match a ROB slot (sources and packet ids come
    from small pools), full ROBs, full pending queues, empty send queues,
    ejection ages on both sides of ``knob_ej_age``, edge routers with
    missing ports, and head rows of empty queues that hold a -1
    destination.
    """
    nn = rows * cols
    nid = (np.arange(n) % nn).astype(np.int32)
    r, c = nid // cols, nid % cols
    vp = np.stack([r > 0, c < cols - 1, r < rows - 1, c > 0], axis=1)
    pool = min(nn, 4)
    ri = lambda lo, hi, shape: rng.integers(lo, hi, shape).astype(np.int32)  # noqa: E731

    inp = np.zeros((n, 4, NUM_F), np.int32)
    nfl = rng.choice(_PACKET_FLITS, (n, 4))
    inp[..., F_VALID] = 1
    inp[..., F_AGE] = ri(0, 12, (n, 4))
    inp[..., F_SRC] = ri(0, pool, (n, 4))
    inp[..., F_DST] = np.where(rng.random((n, 4)) < 0.5, nid[:, None],
                               ri(0, nn, (n, 4)))
    inp[..., F_OSRC] = ri(0, nn, (n, 4))
    inp[..., F_TYP] = ri(0, 10, (n, 4))
    inp[..., F_TAG] = ri(0, 1 << 14, (n, 4))
    inp[..., F_PKT] = ri(0, pool, (n, 4))
    inp[..., F_FID] = (rng.random((n, 4)) * nfl).astype(np.int32)
    inp[..., F_NFL] = nfl
    inp *= ((rng.random((n, 4)) < 0.7) & vp)[:, :, None]

    rob = np.zeros((n, K, NUM_R), np.int32)
    rnfl = rng.choice(_PACKET_FLITS, (n, K))
    rob[..., R_SRC] = ri(0, pool, (n, K))
    rob[..., R_PKT] = ri(0, pool, (n, K))
    rob[..., R_TYP] = ri(0, 10, (n, K))
    rob[..., R_TAG] = ri(0, 1 << 14, (n, K))
    rob[..., R_OSRC] = ri(0, nn, (n, K))
    rob[..., R_NFL] = rnfl
    rob[..., R_CNT] = (rng.random((n, K)) * (rnfl + 1)).astype(np.int32)
    rob_full = rng.random(n) < 0.3
    rob *= (rob_full[:, None] | (rng.random((n, K)) < 0.5))[:, :, None]

    pc = np.zeros((n, pc_depth, NUM_P), np.int32)
    pc[..., P_VALID] = 1
    pc[..., P_TYP] = ri(0, 10, (n, pc_depth))
    pc[..., P_SRC] = ri(0, nn, (n, pc_depth))
    pc[..., P_OSRC] = ri(0, nn, (n, pc_depth))
    pc[..., P_TAG] = ri(0, 1 << 14, (n, pc_depth))
    pc_full = rng.random(n) < 0.3
    pc *= (pc_full[:, None]
           | (rng.random((n, pc_depth)) < 0.3))[:, :, None]

    q_desc = np.zeros((n, send_queue + 1, NUM_Q), np.int32)
    q_desc[..., Q_TYP] = ri(0, 10, (n, send_queue + 1))
    q_desc[..., Q_DST] = ri(-1, nn, (n, send_queue + 1))
    q_desc[..., Q_OSRC] = ri(0, nn, (n, send_queue + 1))
    q_desc[..., Q_TAG] = ri(0, 1 << 14, (n, send_queue + 1))
    q_desc[..., Q_PKT] = ri(0, 1 << 14, (n, send_queue + 1))
    q_desc[..., Q_NFL] = rng.choice(_PACKET_FLITS, (n, send_queue + 1))
    q_head = ri(0, send_queue, n)
    q_size = np.where(rng.random(n) < 0.3, 0,
                      ri(1, send_queue + 1, n)).astype(np.int32)
    rows_ = np.arange(n)
    live = q_size > 0
    # a queued packet has a real destination, sometimes the router itself
    q_desc[rows_[live], q_head[live], Q_DST] = np.where(
        rng.random(int(live.sum())) < 0.2, nid[live],
        ri(0, nn, int(live.sum())))
    head_nfl = q_desc[rows_, q_head, Q_NFL]
    q_fid = np.where(live, (rng.random(n) * head_nfl).astype(np.int32),
                     0).astype(np.int32)
    return dict(
        inp=inp, rob=rob, pc=pc, q_desc=q_desc, q_head=q_head,
        q_size=q_size, q_fid=q_fid, node_id=nid, node_r=r.astype(np.int32),
        node_c=c.astype(np.int32), valid_port=vp,
        knob_ej_age=np.array(rng.integers(0, 8), np.int32),
        stats=ri(0, 1 << 30, NUM_STATS))


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: float | None = None
                  ) -> torch.Tensor:
    """Reference attention.  q: (B, H, S, D); k, v: (B, KV, T, D) with
    ``H % KV == 0`` (grouped-query attention: head ``h`` reads K/V head
    ``h // (H // KV)``, as ``jnp.repeat`` lays them out).

    Logits in float32, the causal mask ``tril(ones(S, T), T - S)`` at
    -1e30, softmax, output cast to q's dtype.
    """
    d = q.shape[-1]
    rep = q.shape[1] // k.shape[1]
    if rep > 1:
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        s_, t_ = logits.shape[-2:]
        mask = torch.tril(torch.ones((s_, t_), dtype=torch.bool,
                                     device=q.device), t_ - s_)
        logits = torch.where(mask, logits, -1e30)
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", w, v.float()).to(q.dtype)
