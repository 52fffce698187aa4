"""Serial golden-model simulator (the paper's §7.1 "serial version").

Pure numpy + Python loops, deliberately boring.  This file is the
*executable specification*: the vectorized simulator in
:mod:`repro_torch.core.sim` implements bit-identical semantics and is
validated against this model (paper §7.3 validates GPU-vs-serial the same
way).  A copy of the JAX package's ``repro.core.ref_serial`` over the
port's own config; the launcher's ``--serial`` mode runs it.

Semantic rules are labelled ``S<n>`` and referenced from the vectorized
implementation.

Per-cycle phase order (S1):
    1a. each node processes at most one completed inbound packet
    1b. each node steps its memory-access FSM (trace-driven)
    2.  each router arbitrates: eject -> inject -> age-priority port assign
    3.  flits move to neighbour input ports; ejected flit enters the reorder
        buffer; a fully-assembled packet becomes the node's pending
        completion for the next cycle's phase 1a.
Within a phase, nodes are independent (writes are conflict-free), so any
iteration order gives the same result — this is what makes the paper's
one-thread-per-router parallelization (and our vectorization) exact.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from .config import (
    EJECT,
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
    NUM_PORTS,
    PORT_E,
    PORT_N,
    PORT_S,
    PORT_W,
    ST_DONE,
    ST_IDLE,
    ST_L1_WAIT,
    ST_L2_WAIT,
    ST_WAIT_DATA,
    ST_WAIT_DIR,
    ST_WAIT_MEM,
    SimConfig,
)
from .state import STAT_NAMES


@dataclasses.dataclass
class Flit:
    age: int
    src: int
    dst: int
    osrc: int      # original requester / DU owner payload / DR owner payload
    typ: int
    tag: int
    pkt: int
    fid: int
    nfl: int


class SerialSim:
    """Golden-model LCMP simulator (serial; semantics spec)."""

    def __init__(self, cfg: SimConfig, trace: np.ndarray):
        cfg.validate()
        self.cfg = cfg
        n = cfg.num_nodes
        assert trace.shape[0] == n
        self.trace = trace.astype(np.int64)
        ca = cfg.cache

        # --- per-node FSM ---
        self.st = np.zeros(n, np.int64)
        self.ctr = np.zeros(n, np.int64)
        self.tr_ptr = np.zeros(n, np.int64)
        self.pend_addr = np.full(n, -1, np.int64)
        self.install_mode = np.zeros(n, np.int64)
        self.pkt_ctr = np.zeros(n, np.int64)

        # --- caches (SoA) ---
        self.l1_tag = np.full((n, ca.l1_sets, ca.l1_ways), -1, np.int64)
        self.l1_lru = np.zeros((n, ca.l1_sets, ca.l1_ways), np.int64)
        self.l1_owner = np.full((n, ca.l1_sets, ca.l1_ways), -1, np.int64)
        self.l2_tag = np.full((n, ca.l2_sets, ca.l2_ways), -1, np.int64)
        self.l2_lru = np.zeros((n, ca.l2_sets, ca.l2_ways), np.int64)
        self.l2_mig = np.zeros((n, ca.l2_sets, ca.l2_ways), np.int64)
        self.l2_last_req = np.full((n, ca.l2_sets, ca.l2_ways), -1, np.int64)
        self.l2_streak = np.zeros((n, ca.l2_sets, ca.l2_ways), np.int64)
        self.lru_clock = np.zeros(n, np.int64)

        # --- directory (paper's "location array") ---
        self.dir_loc = np.full(cfg.dir_entries, -1, np.int64)

        # --- forwarding table (redirection) ---
        self.fwd_tag = np.full((n, cfg.fwd_entries), -1, np.int64)
        self.fwd_dst = np.full((n, cfg.fwd_entries), -1, np.int64)
        self.fwd_ptr = np.zeros(n, np.int64)

        # --- network ---
        self.inp: List[List[Optional[Flit]]] = [[None] * NUM_PORTS for _ in range(n)]
        # send queue holds whole packets (typ, dst, osrc, tag, pkt, nfl);
        # flits of the head packet are injected one per cycle (S2).
        self.sendq: List[List[Tuple[int, int, int, int, int, int]]] = [[] for _ in range(n)]
        self.q_fid = np.zeros(n, np.int64)   # flit cursor of the head packet

        # --- reorder buffer: per node, list of [src, pkt, typ, tag, osrc, nfl, count]
        self.rob: List[List[List[int]]] = [[] for _ in range(n)]
        # pending-completion queue: per node, FIFO of (typ, src, osrc, tag)
        # capped at cfg.pc_depth (depth 1 = the paper's single S14
        # register; deeper queues enable the ejection guarantee, see
        # phase2)
        self.pending: List[List[Tuple[int, int, int, int]]] = [[] for _ in range(n)]

        self.stats: Dict[str, int] = {k: 0 for k in STAT_NAMES}
        self.cycle = 0

    # -- geometry helpers ---------------------------------------------------
    def rc(self, node: int) -> Tuple[int, int]:
        return divmod(node, self.cfg.cols)

    def valid_ports(self, node: int) -> List[int]:
        r, c = self.rc(node)
        out = []
        if r > 0:
            out.append(PORT_N)
        if c < self.cfg.cols - 1:
            out.append(PORT_E)
        if r < self.cfg.rows - 1:
            out.append(PORT_S)
        if c > 0:
            out.append(PORT_W)
        return out

    # -- send-queue helpers ---------------------------------------------------
    def enqueue(self, node: int, typ: int, dst: int, osrc: int, tag: int) -> None:
        """S2: whole packets enter the FIFO packet queue or are dropped whole."""
        if len(self.sendq[node]) >= self.cfg.send_queue:
            self.stats["send_drop"] += 1
            return
        pkt = int(self.pkt_ctr[node]) & (self.cfg.pkt_wrap - 1)
        self.pkt_ctr[node] += 1
        self.sendq[node].append((typ, dst, osrc, tag, pkt, FLITS_OF[typ]))

    # -- cache helpers --------------------------------------------------------
    def _touch(self, lru, node, s, w):
        self.lru_clock[node] += 1
        lru[node, s, w] = self.lru_clock[node]

    def l1_probe(self, node: int, addr: int) -> Optional[Tuple[int, int]]:
        ca = self.cfg.cache
        tag = addr >> ca.l1_shift
        s = tag % ca.l1_sets
        for w in range(ca.l1_ways):
            if self.l1_tag[node, s, w] == tag:
                return s, w
        return None

    def l2_probe(self, node: int, tag2: int) -> Optional[Tuple[int, int]]:
        ca = self.cfg.cache
        s = tag2 % ca.l2_sets
        for w in range(ca.l2_ways):
            if self.l2_tag[node, s, w] == tag2:
                return s, w
        return None

    def install_l1(self, node: int, addr: int, owner: int) -> None:
        """S3: L1 install with victim write-back to the victim's L2 home."""
        ca = self.cfg.cache
        tag = addr >> ca.l1_shift
        s = tag % ca.l1_sets
        hit = self.l1_probe(node, addr)
        if hit is not None:
            self._touch(self.l1_lru, node, s, hit[1])
            self.l1_owner[node, s, hit[1]] = owner
            return
        # victim way: first invalid, else LRU (smallest lru, tie lowest way)
        way = -1
        for w in range(ca.l1_ways):
            if self.l1_tag[node, s, w] < 0:
                way = w
                break
        if way < 0:
            way = int(np.argmin(self.l1_lru[node, s]))
            # write back the victim (DESIGN §2: paper's mechanics)
            vtag1 = int(self.l1_tag[node, s, way])
            vowner = int(self.l1_owner[node, s, way])
            vtag2 = vtag1 >> (ca.l2_shift - ca.l1_shift)
            if vowner == node:
                if self.l2_probe(node, vtag2) is None:
                    self.stats["wb_miss"] += 1
            elif vowner >= 0:
                self.enqueue(node, MSG_WB, vowner, node, vtag2)
                self.stats["wb_sent"] += 1
            # vowner < 0: trap-filled block, written straight back to memory
        self.l1_tag[node, s, way] = tag
        self.l1_owner[node, s, way] = owner
        self._touch(self.l1_lru, node, s, way)

    def dir_set(self, node: int, tag2: int, owner: int) -> None:
        """S4: directory update — local apply or DU flit to the tag home."""
        home = self.cfg.dir_home(tag2)
        if home == node:
            self.stats["dir_update"] += 1
            if owner < 0:
                if self.dir_loc[tag2] == node:
                    self.dir_loc[tag2] = -1
            else:
                self.dir_loc[tag2] = owner
        else:
            self.enqueue(node, MSG_DU, home, owner, tag2)

    def install_l2(self, node: int, tag2: int) -> bool:
        """S5: L2 install; victim dir-entry delete; dir update for new tag."""
        ca = self.cfg.cache
        s = tag2 % ca.l2_sets
        if self.l2_probe(node, tag2) is not None:
            return True
        way = -1
        for w in range(ca.l2_ways):
            if self.l2_tag[node, s, w] < 0:
                way = w
                break
        if way < 0:
            best = None
            for w in range(ca.l2_ways):
                if self.l2_mig[node, s, w]:
                    continue
                k = (int(self.l2_lru[node, s, w]), w)
                if best is None or k < best[0]:
                    best = (k, w)
            if best is None:
                self.stats["l2_install_drop"] += 1
                return False
            way = best[1]
            vtag = int(self.l2_tag[node, s, way])
            self.dir_set(node, vtag, -1)   # delete victim's dir entry
        self.l2_tag[node, s, way] = tag2
        self.l2_mig[node, s, way] = 0
        self.l2_last_req[node, s, way] = -1
        self.l2_streak[node, s, way] = 0
        self._touch(self.l2_lru, node, s, way)
        self.dir_set(node, tag2, node)
        return True

    def fwd_lookup(self, node: int, tag2: int) -> int:
        for i in range(self.cfg.fwd_entries):
            if self.fwd_tag[node, i] == tag2:
                return int(self.fwd_dst[node, i])
        return -1

    def fwd_insert(self, node: int, tag2: int, dst: int) -> None:
        p = int(self.fwd_ptr[node]) % self.cfg.fwd_entries
        self.fwd_tag[node, p] = tag2
        self.fwd_dst[node, p] = dst
        self.fwd_ptr[node] = p + 1

    # -- phase 1a: inbound completions -----------------------------------------
    #: S14 — worst-case packets a handler may enqueue, by message type.
    NEED = {MSG_REQ: 2, MSG_REQ_FWD: 2, MSG_RA: 1, MSG_NACK: 0, MSG_DA: 1,
            MSG_DR: 1, MSG_DU: 0, MSG_WB: 0, MSG_B2: 3, MSG_MIG_ACK: 0}

    def q_space(self, node: int) -> int:
        return self.cfg.send_queue - len(self.sendq[node])

    def _exact_need(self, node: int, comp: Tuple[int, int, int, int]) -> int:
        """Exact number of packets the handler for ``comp`` will enqueue
        (the pc_depth > 1 drain-from-head gate; mirrors each handler's
        enqueue sites without mutating state)."""
        typ, src, osrc, tag = comp
        cfg = self.cfg
        if typ in (MSG_REQ, MSG_REQ_FWD):
            hit = self.l2_probe(node, tag)
            if hit is None:
                return 1                       # REQ_FWD or NACK
            s, w = hit
            trig = False
            if (cfg.migration_enabled and osrc != node
                    and not self.l2_mig[node, s, w]):
                streak = (self.l2_streak[node, s, w] + 1
                          if self.l2_last_req[node, s, w] == osrc else 1)
                trig = streak >= cfg.migrate_threshold
            return 1 + (1 if trig else 0)      # RA + maybe B2
        if typ == MSG_RA:
            if self.st[node] != ST_WAIT_DATA:
                return 0                       # stray
            # would install_l1 write back a remote-owned victim?
            ca = cfg.cache
            addr = int(self.pend_addr[node])
            t1 = addr >> ca.l1_shift
            s = t1 % ca.l1_sets
            if self.l1_probe(node, addr) is not None:
                return 0
            for w in range(ca.l1_ways):
                if self.l1_tag[node, s, w] < 0:
                    return 0                   # free way, no victim
            way = int(np.argmin(self.l1_lru[node, s]))
            vowner = int(self.l1_owner[node, s, way])
            return 1 if (vowner >= 0 and vowner != node) else 0
        if typ == MSG_DA:
            return 1                           # DR reply
        if typ == MSG_DR:
            return 1 if (self.st[node] == ST_WAIT_DIR and osrc >= 0) else 0
        if typ == MSG_B2:
            # MIG_ACK + one DU per remote directory update of install_l2
            ca = cfg.cache
            if self.l2_probe(node, tag) is not None:
                return 1
            s = tag % ca.l2_sets
            cnt = 1
            way = -1
            for w in range(ca.l2_ways):
                if self.l2_tag[node, s, w] < 0:
                    way = w
                    break
            if way < 0:
                best = None
                for w in range(ca.l2_ways):
                    if self.l2_mig[node, s, w]:
                        continue
                    k = (int(self.l2_lru[node, s, w]), w)
                    if best is None or k < best[0]:
                        best = (k, w)
                if best is None:
                    return 1                   # install fails: MIG_ACK only
                vtag = int(self.l2_tag[node, s, best[1]])
                if cfg.dir_home(vtag) != node:
                    cnt += 1
            if cfg.dir_home(tag) != node:
                cnt += 1
            return cnt
        return 0                               # NACK / DU / WB / MIG_ACK

    def phase1a(self, node: int) -> None:
        if not self.pending[node]:
            return
        comp = self.pending[node][0]   # FIFO: always serve the head
        # S14: backpressure — defer processing until the send queue can hold
        # the response; the completion queue head stays occupied, which
        # restricts further ejection at this node (see phase2).  pc_depth=1
        # gates on the worst-case NEED table (the paper's register
        # semantics, bit-identical to the seed); a deeper queue gates on
        # the exact response count so a head whose response actually fits
        # never blocks the drain (the ejection guarantee's second half).
        need = (self.NEED[comp[0]] if self.cfg.pc_depth == 1
                else self._exact_need(node, comp))
        if self.q_space(node) < need:
            # guaranteed drain (pc_depth > 1): a FULL queue must make
            # progress every cycle (its node cannot eject, so it may never
            # get to inject and free send-queue space on its own) — the
            # head fires anyway; responses that do not fit are dropped
            # whole (send_drop) and recovered by the req_timeout retry.
            if not (self.cfg.pc_depth > 1
                    and len(self.pending[node]) >= self.cfg.pc_depth):
                return
        self.pending[node].pop(0)
        typ, src, osrc, tag = comp
        cfg = self.cfg
        if typ in (MSG_REQ, MSG_REQ_FWD):
            self.stats["req_rcvd"] += 1
            hit = self.l2_probe(node, tag)
            if hit is not None:
                s, w = hit
                self._touch(self.l2_lru, node, s, w)
                self.enqueue(node, MSG_RA, osrc, osrc, tag)
                self.stats["reply_sent"] += 1
                if (cfg.migration_enabled and osrc != node
                        and not self.l2_mig[node, s, w]):
                    if self.l2_last_req[node, s, w] == osrc:
                        self.l2_streak[node, s, w] += 1
                    else:
                        self.l2_last_req[node, s, w] = osrc
                        self.l2_streak[node, s, w] = 1
                    if self.l2_streak[node, s, w] >= cfg.migrate_threshold:
                        self.l2_mig[node, s, w] = 1
                        self.enqueue(node, MSG_B2, osrc, node, tag)
                        self.stats["migrations"] += 1
            else:
                fwd = self.fwd_lookup(node, tag)
                if fwd >= 0 and fwd != node:
                    self.enqueue(node, MSG_REQ_FWD, fwd, osrc, tag)
                    self.stats["redirection"] += 1
                else:
                    self.enqueue(node, MSG_NACK, osrc, osrc, tag)
                    self.stats["trap"] += 1
        elif typ == MSG_RA:
            if self.st[node] == ST_WAIT_DATA:
                self.stats["reply_rcvd"] += 1
                self.install_l1(node, int(self.pend_addr[node]), src)
                self.st[node] = ST_IDLE
            else:
                self.stats["stray"] += 1
        elif typ == MSG_NACK:
            if self.st[node] == ST_WAIT_DATA:
                self.st[node] = ST_WAIT_MEM
                self.ctr[node] = cfg.mem_cycles
                self.install_mode[node] = INSTALL_L1_ONLY
                self.stats["mem_req"] += 1
            else:
                self.stats["stray"] += 1
        elif typ == MSG_DA:
            # S6: home reserves on miss so only one node ever memory-installs
            self.stats["dir_search"] += 1
            owner = int(self.dir_loc[tag])
            if owner < 0 or owner == osrc:
                self.dir_loc[tag] = osrc
                owner = -1
            self.enqueue(node, MSG_DR, osrc, owner, tag)
        elif typ == MSG_DR:
            owner = osrc   # payload
            if self.st[node] == ST_WAIT_DIR:
                if owner >= 0:
                    self.enqueue(node, MSG_REQ, owner, node, tag)
                    self.stats["req_made"] += 1
                    self.st[node] = ST_WAIT_DATA
                    if cfg.pc_depth > 1:   # arm the transaction timeout
                        self.ctr[node] = cfg.req_timeout
                else:
                    self.st[node] = ST_WAIT_MEM
                    self.ctr[node] = cfg.mem_cycles
                    self.install_mode[node] = INSTALL_L2
                    self.stats["mem_req"] += 1
            else:
                self.stats["stray"] += 1
        elif typ == MSG_DU:
            self.stats["dir_update"] += 1
            owner = osrc
            if owner < 0:
                if self.dir_loc[tag] == src:
                    self.dir_loc[tag] = -1
            else:
                self.dir_loc[tag] = owner
        elif typ == MSG_WB:
            self.stats["wb_rcvd"] += 1
            hit = self.l2_probe(node, tag)
            if hit is not None:
                self._touch(self.l2_lru, node, hit[0], hit[1])
            else:
                self.stats["wb_miss"] += 1
        elif typ == MSG_B2:
            self.stats["migrations_done"] += 1
            ok = self.install_l2(node, tag)
            # S13: MIG_ACK carries success (osrc=dest) or failure (osrc=-1);
            # on failure the source keeps the block and clears `migrating`.
            self.enqueue(node, MSG_MIG_ACK, src, node if ok else -1, tag)
        elif typ == MSG_MIG_ACK:
            hit = self.l2_probe(node, tag)
            if osrc >= 0:
                if hit is not None and self.l2_mig[node, hit[0], hit[1]]:
                    self.l2_tag[node, hit[0], hit[1]] = -1
                    self.l2_mig[node, hit[0], hit[1]] = 0
                self.fwd_insert(node, tag, osrc)
            else:
                if hit is not None:
                    self.l2_mig[node, hit[0], hit[1]] = 0
                    self.l2_streak[node, hit[0], hit[1]] = 0

    # -- phase 1b: trace-driven FSM --------------------------------------------
    def _consume_hit_under_miss(self, node: int) -> None:
        """S7: hit-under-miss — while waiting on a remote/memory miss the core
        keeps consuming trace addresses as long as they hit in L1."""
        p = int(self.tr_ptr[node])
        if p >= self.trace.shape[1] or self.trace[node, p] < 0:
            return
        addr = int(self.trace[node, p])
        hit = self.l1_probe(node, addr)
        if hit is not None:
            s = (addr >> self.cfg.cache.l1_shift) % self.cfg.cache.l1_sets
            self._touch(self.l1_lru, node, s, hit[1])
            self.stats["l1_hits"] += 1
            self.tr_ptr[node] = p + 1

    def phase1b(self, node: int) -> None:
        cfg = self.cfg
        ca = cfg.cache
        st = int(self.st[node])
        if st == ST_DONE:
            return
        if st == ST_IDLE:
            p = int(self.tr_ptr[node])
            if p >= self.trace.shape[1] or self.trace[node, p] < 0:
                self.st[node] = ST_DONE
                return
            addr = int(self.trace[node, p])
            self.tr_ptr[node] = p + 1
            hit = self.l1_probe(node, addr)
            if hit is not None:
                s = (addr >> ca.l1_shift) % ca.l1_sets
                self._touch(self.l1_lru, node, s, hit[1])
                self.stats["l1_hits"] += 1
                return
            self.stats["l1_misses"] += 1
            self.pend_addr[node] = addr
            self.st[node] = ST_L1_WAIT
            self.ctr[node] = cfg.l1_miss_cycles
            return
        if st == ST_L1_WAIT:
            self.ctr[node] -= 1
            if self.ctr[node] > 0:
                return
            if self.q_space(node) < 1:      # S14: hold until we can enqueue
                self.ctr[node] = 1
                return
            tag2 = int(self.pend_addr[node]) >> ca.l2_shift
            if self.l2_probe(node, tag2) is not None:
                self.stats["l2_local_hits"] += 1
                self.st[node] = ST_L2_WAIT
                self.ctr[node] = cfg.l2_hit_cycles
                return
            self.stats["l2_local_misses"] += 1
            home = cfg.dir_home(tag2)
            if home == node:
                # S8: inline directory access at the home node
                self.stats["dir_search"] += 1
                owner = int(self.dir_loc[tag2])
                if owner >= 0 and owner != node:
                    self.enqueue(node, MSG_REQ, owner, node, tag2)
                    self.stats["req_made"] += 1
                    self.st[node] = ST_WAIT_DATA
                    if cfg.pc_depth > 1:   # arm the transaction timeout
                        self.ctr[node] = cfg.req_timeout
                else:
                    self.dir_loc[tag2] = node   # reserve
                    self.st[node] = ST_WAIT_MEM
                    self.ctr[node] = cfg.mem_cycles
                    self.install_mode[node] = INSTALL_L2
                    self.stats["mem_req"] += 1
            else:
                self.enqueue(node, MSG_DA, home, node, tag2)
                self.st[node] = ST_WAIT_DIR
                if cfg.pc_depth > 1:   # arm the transaction timeout
                    self.ctr[node] = cfg.req_timeout
            return
        if st == ST_L2_WAIT:
            self.ctr[node] -= 1
            if self.ctr[node] > 0:
                return
            if self.q_space(node) < 1:      # S14
                self.ctr[node] = 1
                return
            s, w = self.l2_probe(node, int(self.pend_addr[node]) >> ca.l2_shift) or (-1, -1)
            if s >= 0:
                self._touch(self.l2_lru, node, s, w)
            self.install_l1(node, int(self.pend_addr[node]), node)
            self.st[node] = ST_IDLE
            return
        if st == ST_WAIT_MEM:
            self.ctr[node] -= 1
            if self.ctr[node] > 0:
                self._consume_hit_under_miss(node)
                return
            if self.q_space(node) < 3:      # S14 (DUv + DUn + WB worst case)
                self.ctr[node] = 1
                return
            addr = int(self.pend_addr[node])
            if self.install_mode[node] == INSTALL_L2:
                self.install_l2(node, addr >> ca.l2_shift)
                self.install_l1(node, addr, node)
            else:
                self.install_l1(node, addr, -1)
            self.st[node] = ST_IDLE
            return
        # ST_WAIT_DIR / ST_WAIT_DATA
        if cfg.pc_depth > 1:
            # transaction timeout: restart with a fresh DA to the tag's
            # home — retransmit-once recovery for responses the
            # guaranteed drain had to drop (stale duplicates -> `stray`)
            self.ctr[node] -= 1
            if self.ctr[node] <= 0:
                if self.q_space(node) < 1:      # S14: hold the retry
                    self.ctr[node] = 1
                else:
                    tag2 = int(self.pend_addr[node]) >> ca.l2_shift
                    self.enqueue(node, MSG_DA, cfg.dir_home(tag2), node, tag2)
                    self.st[node] = ST_WAIT_DIR
                    self.ctr[node] = cfg.req_timeout
        self._consume_hit_under_miss(node)

    # -- phase 2: arbitration ---------------------------------------------------
    def _prefs(self, node: int, flit: Flit) -> List[int]:
        """S9: PMDR preference list — desired X, desired Y, then remaining
        valid ports in index order."""
        r, c = self.rc(node)
        dr_, dc_ = divmod(flit.dst, self.cfg.cols)
        prefs: List[int] = []
        if dc_ > c:
            prefs.append(PORT_E)
        elif dc_ < c:
            prefs.append(PORT_W)
        if dr_ > r:
            prefs.append(PORT_S)
        elif dr_ < r:
            prefs.append(PORT_N)
        vp = self.valid_ports(node)
        prefs = [p for p in prefs if p in vp]
        for p in vp:
            if p not in prefs:
                prefs.append(p)
        return prefs

    def rob_can_accept(self, node: int, flit: Flit) -> bool:
        """S10: eject only if the reorder buffer can take the flit."""
        if flit.nfl == 1:
            return True   # single-flit packets complete via the pending register
        for slot in self.rob[node]:
            if slot[0] == flit.src and slot[1] == flit.pkt:
                return True
        return len(self.rob[node]) < self.cfg.rob_slots

    def phase2(self, node: int):
        """Returns (out_ports: dict port->flit, eject: Optional[Flit],
        injected: bool, deflect_flags: dict id(flit)->bool)."""
        flits = [(p, f) for p, f in enumerate(self.inp[node]) if f is not None]
        vp = self.valid_ports(node)

        # S11: ejection — oldest (age desc, port asc) flit destined here that
        # the ROB can accept; at most one per cycle.  S14 + ejection
        # guarantee (pc_depth > 1): with an empty pending-completion queue
        # any deliverable flit may eject (the paper's behaviour); once the
        # queue is occupied only flits aged past cfg.eject_age_threshold
        # eject — into spare queue capacity while a slot is free, and into
        # a free ROB slot (buffered ejection; the completion parks and is
        # promoted as the queue drains, see phase3) when the queue is full.
        # pc_depth=1 keeps the paper's exact single-register bar.
        eject: Optional[Tuple[int, Flit]] = None
        pcq = self.pending[node]
        depth = self.cfg.pc_depth

        def ej_allowed(f: Flit) -> bool:
            if not pcq:
                return self.rob_can_accept(node, f)
            if depth == 1 or f.age < self.cfg.eject_age_threshold:
                return False
            if len(pcq) < depth:
                return self.rob_can_accept(node, f)
            # queue full — parking path: a single-flit completion needs a
            # fresh ROB slot; a multi-flit flit parks in its own slot
            if f.nfl == 1:
                return len(self.rob[node]) < self.cfg.rob_slots
            return self.rob_can_accept(node, f)

        for p, f in sorted(flits, key=lambda pf: (-pf[1].age, pf[0])):
            if f.dst == node and ej_allowed(f):
                eject = (p, f)
                break
        remaining = [(p, f) for p, f in flits if eject is None or p != eject[0]]

        # S12: injection — head of the send queue joins arbitration iff the
        # number of remaining network flits is below the number of valid
        # ports; the injected flit has age 0 and loses all ties (slot 4).
        inj: Optional[Flit] = None
        if self.sendq[node] and len(remaining) < len(vp):
            typ, dst, osrc, tag, pkt, nfl = self.sendq[node][0]
            inj = Flit(0, node, dst, osrc, typ, tag, pkt, int(self.q_fid[node]), nfl)

        cands = [(p, f) for p, f in remaining]
        if inj is not None:
            cands.append((4, inj))
        order = sorted(cands, key=lambda pf: (-pf[1].age, pf[0]))

        taken: set = set()
        out: Dict[int, Flit] = {}
        deflected: Dict[int, bool] = {}
        for p, f in order:
            prefs = self._prefs(node, f)
            wanted_eject = (f.dst == node)
            assigned = None
            for q in prefs:
                if q not in taken:
                    assigned = q
                    break
            assert assigned is not None, "bufferless invariant violated"
            taken.add(assigned)
            out[assigned] = f
            deflected[id(f)] = wanted_eject or (assigned != prefs[0])
        injected = inj is not None
        if injected:
            self.q_fid[node] += 1
            if self.q_fid[node] == inj.nfl:
                self.sendq[node].pop(0)
                self.q_fid[node] = 0
            self.stats["injected"] += 1
        return out, eject, deflected

    # -- phase 3: transfer --------------------------------------------------
    def phase3(self, all_out, all_eject, all_defl) -> None:
        cfg = self.cfg
        n = cfg.num_nodes
        new_inp: List[List[Optional[Flit]]] = [[None] * NUM_PORTS for _ in range(n)]
        for node in range(n):
            r, c = self.rc(node)
            for port, f in all_out[node].items():
                if all_defl[node].get(id(f), False):
                    f.age += 1
                    self.stats["deflections"] += 1
                self.stats["hops"] += 1
                if port == PORT_N:
                    nb, back = (r - 1) * cfg.cols + c, PORT_S
                elif port == PORT_S:
                    nb, back = (r + 1) * cfg.cols + c, PORT_N
                elif port == PORT_E:
                    nb, back = r * cfg.cols + (c + 1), PORT_W
                else:
                    nb, back = r * cfg.cols + (c - 1), PORT_E
                new_inp[nb][back] = f
        self.inp = new_inp
        depth = self.cfg.pc_depth
        for node in range(n):
            pcq = self.pending[node]
            # promotion: the parked completion (count reached its flit
            # total while the queue was full) with the smallest (src, pkt)
            # enters the queue tail — same rule as the vectorized deliver
            parked = [s for s in self.rob[node] if s[6] >= s[5]]
            if parked and len(pcq) < depth:
                sl = min(parked, key=lambda s: (s[0], s[1]))
                pcq.append((sl[2], sl[0], sl[4], sl[3]))
                self.rob[node].remove(sl)
            ej = all_eject[node]
            if ej is None:
                continue
            f = ej[1]
            self.stats["flits_delivered"] += 1
            if f.nfl == 1:
                if len(pcq) < depth:
                    pcq.append((f.typ, f.src, f.osrc, f.tag))
                else:   # park (phase2 guaranteed a free slot)
                    assert len(self.rob[node]) < self.cfg.rob_slots
                    self.rob[node].append(
                        [f.src, f.pkt, f.typ, f.tag, f.osrc, 1, 1])
                continue
            slot = None
            for s in self.rob[node]:
                if s[0] == f.src and s[1] == f.pkt:
                    slot = s
                    break
            if slot is None:
                slot = [f.src, f.pkt, f.typ, f.tag, f.osrc, f.nfl, 0]
                self.rob[node].append(slot)
            slot[6] += 1
            if slot[6] == slot[5]:
                if len(pcq) < depth:
                    pcq.append((slot[2], slot[0], slot[4], slot[3]))
                    self.rob[node].remove(slot)
                # else: the completed slot stays parked (count == total)

    # -- driver ----------------------------------------------------------------
    def network_empty(self) -> bool:
        if any(f is not None for ports in self.inp for f in ports):
            return False
        if any(self.sendq[n] for n in range(self.cfg.num_nodes)):
            return False
        if any(self.rob[n] for n in range(self.cfg.num_nodes)):
            return False
        if any(self.pending):
            return False
        return True

    def finished(self) -> bool:
        return bool(np.all(self.st == ST_DONE)) and self.network_empty()

    def step(self) -> None:
        n = self.cfg.num_nodes
        for node in range(n):
            self.phase1a(node)
        for node in range(n):
            self.phase1b(node)
        all_out, all_eject, all_defl = {}, {}, {}
        for node in range(n):
            out, eject, defl = self.phase2(node)
            all_out[node], all_eject[node], all_defl[node] = out, eject, defl
        self.phase3(all_out, all_eject, all_defl)
        self.cycle += 1

    def run(self, max_cycles: Optional[int] = None) -> Dict[str, int]:
        """Drive to completion, with the same livelock / directory-
        saturation monitors as the vectorized driver (`sim._drive`) —
        the golden-model equivalence contract covers pathological inputs
        too, so both sides must abort at the same cycle with the same
        snapshot (the stats ARE the snapshot: they were frozen / sampled
        at the fire cycle)."""
        limit = max_cycles or self.cfg.max_cycles
        n = self.cfg.num_nodes
        lw = self.cfg.livelock_window_effective
        sw = self.cfg.sat_window if n >= 256 else 0
        central = self.cfg.centralized_directory

        def prog():
            return tuple(v for k, v in self.stats.items()
                         if k not in ("hops", "deflections"))

        prev, frz = prog(), 0
        refs_anchor = int(self.tr_ptr.sum())
        abort = ""
        while not self.finished() and self.cycle < limit:
            self.step()
            cur = prog()
            frz = frz + 1 if cur == prev else 0
            prev = cur
            fin = self.finished()
            fire_sat = False
            if sw and self.cycle % sw == 0:
                refs = int(self.tr_ptr.sum())
                wd = int((self.st == ST_WAIT_DIR).sum())
                wdd = int((self.st == ST_WAIT_DATA).sum())
                fire_sat = (not fin and central and (wd + wdd) * 2 >= n
                            and (refs - refs_anchor) * 2 < n)
                refs_anchor = refs
            if fire_sat:
                abort = "dir_saturation"
                break
            if lw and frz >= lw and not fin:
                abort = "livelock"
                break
        out = dict(self.stats)
        out["cycles"] = self.cycle
        if abort:
            out["finished"] = 0
            out["aborted"] = abort
            flits = [f for ports in self.inp for f in ports if f is not None]
            out["circulating_flits"] = len(flits)
            out["wait_dir_nodes"] = int((self.st == ST_WAIT_DIR).sum())
            out["wait_data_nodes"] = int((self.st == ST_WAIT_DATA).sum())
            out["stalled_queues"] = sum(1 for q in self.sendq if q)
            out["flits_to_node0"] = sum(1 for f in flits if f.dst == 0)
        else:
            out["finished"] = int(self.finished())
        return out
