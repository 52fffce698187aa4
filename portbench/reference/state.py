"""The reference simulator's state: dense int32 tensors over all nodes.

A frozen copy of the port's ``core/state.py``, cut to what one whole
mesh needs.  The reference keeps every leaf int32 (the wide layout); the
packed layout's storage dtypes (:func:`leaf_dtypes`) are kept because the
control narrows through them and the yardstick counts bytes with them.

Flit fields: 0 VALID, 1 AGE, 2 SRC, 3 DST, 4 OSRC, 5 TYP, 6 TAG, 7 PKT,
8 FID, 9 NFL.  Send-queue descriptor: 0 TYP, 1 DST, 2 OSRC, 3 TAG, 4 PKT,
5 NFL.  ROB slot: 0 SRC, 1 PKT, 2 TYP, 3 TAG, 4 OSRC, 5 NFL, 6 CNT.
Pending-completion slot: 0 VALID, 1 TYP, 2 SRC, 3 OSRC, 4 TAG.

Statistics are a base-2**30 (hi, lo) int32 pair, folded once a cycle.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch

from .config import NUM_MSG_TYPES, NUM_PORTS, Config

I32 = torch.int32

STAT_NAMES = (
    "req_made", "req_rcvd", "reply_sent", "reply_rcvd", "trap",
    "redirection", "dir_search", "dir_update", "mem_req", "migrations",
    "migrations_done", "l1_hits", "l1_misses", "l2_local_hits",
    "l2_local_misses", "wb_sent", "wb_rcvd", "wb_miss", "flits_delivered",
    "deflections", "hops", "injected", "send_drop", "l2_install_drop",
    "stray",
)
STAT_INDEX = {k: i for i, k in enumerate(STAT_NAMES)}
NUM_STATS = len(STAT_NAMES)

F_VALID, F_AGE, F_SRC, F_DST, F_OSRC, F_TYP, F_TAG, F_PKT, F_FID, F_NFL = range(10)
NUM_F = 10
Q_TYP, Q_DST, Q_OSRC, Q_TAG, Q_PKT, Q_NFL = range(6)
NUM_Q = 6
R_SRC, R_PKT, R_TYP, R_TAG, R_OSRC, R_NFL, R_CNT = range(7)
NUM_R = 7
P_VALID, P_TYP, P_SRC, P_OSRC, P_TAG = range(5)
NUM_P = 5


class SimState(NamedTuple):
    st: torch.Tensor          # (N,) FSM state
    ctr: torch.Tensor
    tr_ptr: torch.Tensor
    pend_addr: torch.Tensor
    install_mode: torch.Tensor
    pkt_ctr: torch.Tensor
    lru_clock: torch.Tensor
    l1_tag: torch.Tensor      # (N, S1, W1)
    l1_lru: torch.Tensor
    l1_owner: torch.Tensor
    l2_tag: torch.Tensor      # (N, S2, W2)
    l2_lru: torch.Tensor
    l2_mig: torch.Tensor
    l2_last: torch.Tensor
    l2_streak: torch.Tensor
    dir_loc: torch.Tensor     # flat (E + 1,) or home (N, per + 1); last = sink
    fwd_tag: torch.Tensor     # (N, Fe)
    fwd_dst: torch.Tensor
    fwd_ptr: torch.Tensor
    inp: torch.Tensor         # (N, 4, NUM_F)
    q_desc: torch.Tensor      # (N, Qp + 1, NUM_Q); slot Qp is a sink
    q_head: torch.Tensor
    q_size: torch.Tensor
    q_fid: torch.Tensor
    rob: torch.Tensor         # (N, K, NUM_R)
    pc: torch.Tensor          # (N, pc_depth, NUM_P)
    stats: torch.Tensor       # (NUM_STATS,) low word
    stats_hi: torch.Tensor    # (NUM_STATS,) high word
    cycle: torch.Tensor       # ()
    trace: torch.Tensor       # (N, M)
    knob_mig: torch.Tensor
    knob_mig_thr: torch.Tensor
    knob_central: torch.Tensor
    knob_ej_age: torch.Tensor


class Geometry(NamedTuple):
    valid_port: torch.Tensor   # (N, 4) bool
    gather_node: torch.Tensor  # (N, 4) int64
    gather_port: torch.Tensor  # (4,) int64


class Ctx(NamedTuple):
    node_id: torch.Tensor     # (N,) int32
    node_r: torch.Tensor      # (N,) int32
    node_c: torch.Tensor      # (N,) int32
    valid_port: torch.Tensor  # (N, 4) bool
    node: torch.Tensor        # (N,) int64 row index


def make_geometry(cfg: Config, device) -> Tuple[Geometry, Ctx]:
    rows, cols = cfg.rows, cfg.cols
    idx = np.arange(rows * cols)
    r, c = idx // cols, idx % cols
    valid = np.stack([r > 0, c < cols - 1, r < rows - 1, c > 0], axis=1)
    gnode = np.stack([idx - cols, idx + 1, idx + cols, idx - 1], axis=1)
    gnode = np.where(valid, gnode, 0)
    t = lambda a, **kw: torch.as_tensor(a, device=device, **kw)  # noqa: E731
    vp = t(valid)
    geo = Geometry(vp, t(gnode, dtype=torch.int64),
                   t(np.array([2, 3, 0, 1]), dtype=torch.int64))
    ctx = Ctx(t(idx, dtype=I32), t(r, dtype=I32), t(c, dtype=I32), vp,
              t(idx, dtype=torch.int64))
    return geo, ctx


def dir_shape(cfg: Config) -> Tuple[int, ...]:
    if cfg.dir_layout == "flat":
        return (cfg.dir_entries + 1,)
    if cfg.centralized_directory:
        raise ValueError("the home directory layout needs a distributed "
                         "directory")
    per = -(-cfg.dir_entries // cfg.num_nodes)
    return (cfg.num_nodes, per + 1)


def init_state(cfg: Config, trace: np.ndarray, device) -> SimState:
    """The empty machine with ``trace`` ``(N, M)`` loaded, every leaf
    int32."""
    n, ca = cfg.num_nodes, cfg.cache
    if trace.shape[0] != n:
        raise ValueError(f"trace has {trace.shape[0]} rows, the mesh {n} "
                         "nodes")
    z = lambda *s: torch.zeros(s, dtype=I32, device=device)  # noqa: E731
    neg = lambda *s: torch.full(s, -1, dtype=I32, device=device)  # noqa: E731
    knob = lambda v: torch.tensor(int(v), dtype=I32, device=device)  # noqa: E731
    return SimState(
        st=z(n), ctr=z(n), tr_ptr=z(n), pend_addr=neg(n), install_mode=z(n),
        pkt_ctr=z(n), lru_clock=z(n),
        l1_tag=neg(n, ca.l1_sets, ca.l1_ways),
        l1_lru=z(n, ca.l1_sets, ca.l1_ways),
        l1_owner=neg(n, ca.l1_sets, ca.l1_ways),
        l2_tag=neg(n, ca.l2_sets, ca.l2_ways),
        l2_lru=z(n, ca.l2_sets, ca.l2_ways),
        l2_mig=z(n, ca.l2_sets, ca.l2_ways),
        l2_last=neg(n, ca.l2_sets, ca.l2_ways),
        l2_streak=z(n, ca.l2_sets, ca.l2_ways),
        dir_loc=neg(*dir_shape(cfg)),
        fwd_tag=neg(n, cfg.fwd_entries), fwd_dst=neg(n, cfg.fwd_entries),
        fwd_ptr=z(n),
        inp=z(n, NUM_PORTS, NUM_F),
        q_desc=z(n, cfg.send_queue + 1, NUM_Q),
        q_head=z(n), q_size=z(n), q_fid=z(n),
        rob=z(n, cfg.rob_slots, NUM_R),
        pc=z(n, cfg.pc_depth, NUM_P),
        stats=z(NUM_STATS), stats_hi=z(NUM_STATS), cycle=z(),
        trace=torch.as_tensor(np.asarray(trace, np.int32), device=device),
        knob_mig=knob(cfg.migration_enabled),
        knob_mig_thr=knob(cfg.migrate_threshold),
        knob_central=knob(cfg.centralized_directory),
        knob_ej_age=knob(cfg.eject_age_threshold),
    )


#: leaves that stay int32 under every layout
PINNED_I32 = ("stats", "stats_hi", "cycle",
              "knob_mig", "knob_mig_thr", "knob_central", "knob_ej_age")


def _fit(lo: int, hi: int) -> torch.dtype:
    for dt in (torch.int8, torch.int16, torch.int32):
        info = torch.iinfo(dt)
        if lo >= info.min and hi <= info.max:
            return dt
    raise ValueError(f"state value bounds [{lo}, {hi}] exceed int32")


@functools.lru_cache(maxsize=None)
def leaf_dtypes(cfg: Config, trace_len: int) -> Dict[str, torch.dtype]:
    """Each leaf's storage dtype under ``cfg``'s layout: int32 for
    ``wide``; for ``packed`` the smallest of int8/int16/int32 that holds
    the leaf's bounds under the configuration."""
    out = {k: I32 for k in SimState._fields}
    if cfg.state_dtype_policy != "packed":
        return out
    n = cfg.num_nodes
    addr_max = (1 << cfg.addr_bits) - 1
    clk_max = 3 * cfg.max_cycles + 4
    ctr_max = max(cfg.mem_cycles, cfg.l2_hit_cycles, cfg.l1_miss_cycles,
                  cfg.req_timeout) + 1
    flits_max = 16
    msg_hi = max(addr_max, n - 1, cfg.pkt_wrap - 1, cfg.max_cycles,
                 flits_max, NUM_MSG_TYPES)
    out.update(
        st=_fit(0, 6), ctr=_fit(-2, ctr_max), tr_ptr=_fit(0, trace_len + 1),
        pend_addr=_fit(-1, addr_max), install_mode=_fit(0, 1),
        pkt_ctr=_fit(0, cfg.pkt_wrap - 1), lru_clock=_fit(0, clk_max),
        l1_tag=_fit(-1, addr_max >> cfg.cache.l1_shift),
        l1_lru=_fit(0, clk_max), l1_owner=_fit(-1, n - 1),
        l2_tag=_fit(-1, addr_max >> cfg.cache.l2_shift),
        l2_lru=_fit(0, clk_max), l2_mig=_fit(0, 1), l2_last=_fit(-1, n - 1),
        l2_streak=torch.int16, dir_loc=_fit(-1, n - 1),
        fwd_tag=_fit(-1, addr_max >> cfg.cache.l2_shift),
        fwd_dst=_fit(-1, n - 1), fwd_ptr=_fit(0, cfg.fwd_entries),
        inp=_fit(-1, msg_hi), q_desc=_fit(-1, msg_hi),
        q_head=_fit(0, cfg.send_queue), q_size=_fit(0, cfg.send_queue + 1),
        q_fid=_fit(0, flits_max), rob=_fit(-1, msg_hi), pc=_fit(-1, msg_hi),
        trace=_fit(-1, addr_max),
    )
    for k in PINNED_I32:
        out[k] = I32
    return out


STATS_FOLD = 1 << 30


def fold_stats(hi: torch.Tensor, lo: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    carry = torch.div(lo, STATS_FOLD, rounding_mode="floor")
    return hi + carry, lo - carry * STATS_FOLD


def stats_totals(hi: torch.Tensor, lo: torch.Tensor) -> np.ndarray:
    return (hi.cpu().numpy().astype(np.int64) * STATS_FOLD
            + lo.cpu().numpy().astype(np.int64))


@functools.lru_cache(maxsize=None)
def _stat_index(names: Tuple[str, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor([STAT_INDEX[k] for k in names], device=device)


def bump_all(stats: torch.Tensor,
             bumps: List[Tuple[str, torch.Tensor]]) -> torch.Tensor:
    """Add each ``(name, amount)`` to its statistic: (N,) masks are
    summed, 0-d amounts added as they are."""
    masks = [(k, a) for k, a in bumps if a.dim() == 1]
    scalars = [(k, a) for k, a in bumps if a.dim() != 1]
    parts = []
    if masks:
        parts.append(torch.stack([a for _, a in masks]).sum(dim=1, dtype=I32))
    if scalars:
        parts.append(torch.stack([a.sum(dtype=I32) if a.dim() else a.to(I32)
                                  for _, a in scalars]))
    names = tuple(k for k, _ in masks + scalars)
    return stats.index_add(0, _stat_index(names, stats.device),
                           torch.cat(parts))
