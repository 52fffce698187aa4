"""Simulator state as a structure of PyTorch tensors.

The GPU version's ``struct Flit / Router / Core`` (paper §6.2.1) become
dense tensors over all N = rows*cols nodes.  Every leaf of
:class:`SimState` maps one to one onto the JAX package's
``repro.core.state.SimState``: same name, shape, storage dtype and
values, so a state carries across through numpy (:mod:`repro_torch.convert`).

Storage layout is configurable (``SimConfig.state_dtype_policy``):
``"wide"`` keeps every leaf int32; ``"packed"`` gives each leaf the
smallest of int8/int16/int32 that holds its validated value bounds
(:func:`leaf_dtypes`).  All phase code computes in int32 either way —
:func:`widen_state` / :func:`narrow_state` cast at the cycle boundary.

Statistics are carried as a base-2**30 (hi, lo) int32 pair (``stats_hi``,
``stats``), as in the JAX package: the low word is folded into the high
word once per cycle (:func:`fold_stats`), so the low word always equals
``total mod 2**30``.  Hosts reconstruct exact int64 totals with
:func:`stats_totals`.

Flit field order (axis -1 of ``inp`` / arbitration candidates):
    0 VALID, 1 AGE, 2 SRC, 3 DST, 4 OSRC, 5 TYP, 6 TAG, 7 PKT, 8 FID, 9 NFL
Send-queue descriptor fields: 0 TYP, 1 DST, 2 OSRC, 3 TAG, 4 PKT, 5 NFL
ROB slot fields: 0 SRC, 1 PKT, 2 TYP, 3 TAG, 4 OSRC, 5 NFL, 6 CNT
Pending-completion slot fields: 0 VALID, 1 TYP, 2 SRC, 3 OSRC, 4 TAG
(the pending-completion state is a per-node FIFO of ``cfg.pc_depth`` such
slots, head at index 0 — depth 1 is the paper's single S14 register)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from .config import NUM_MSG_TYPES, NUM_PORTS, SimConfig

I32 = torch.int32

#: statistic counters, in accumulator order (the serial golden model's
#: ``STAT_NAMES``)
STAT_NAMES = (
    "req_made", "req_rcvd", "reply_sent", "reply_rcvd", "trap",
    "redirection", "dir_search", "dir_update", "mem_req", "migrations",
    "migrations_done", "l1_hits", "l1_misses", "l2_local_hits",
    "l2_local_misses", "wb_sent", "wb_rcvd", "wb_miss", "flits_delivered",
    "deflections", "hops", "injected", "send_drop", "l2_install_drop",
    "stray",
)

# flit fields
F_VALID, F_AGE, F_SRC, F_DST, F_OSRC, F_TYP, F_TAG, F_PKT, F_FID, F_NFL = range(10)
NUM_F = 10
# queue descriptor fields
Q_TYP, Q_DST, Q_OSRC, Q_TAG, Q_PKT, Q_NFL = range(6)
NUM_Q = 6
# rob fields
R_SRC, R_PKT, R_TYP, R_TAG, R_OSRC, R_NFL, R_CNT = range(7)
NUM_R = 7
# pending fields
P_VALID, P_TYP, P_SRC, P_OSRC, P_TAG = range(5)
NUM_P = 5

STAT_INDEX = {k: i for i, k in enumerate(STAT_NAMES)}
NUM_STATS = len(STAT_NAMES)


class SimState(NamedTuple):
    # FSM (N,)
    st: torch.Tensor
    ctr: torch.Tensor
    tr_ptr: torch.Tensor
    pend_addr: torch.Tensor
    install_mode: torch.Tensor
    pkt_ctr: torch.Tensor
    lru_clock: torch.Tensor
    # caches
    l1_tag: torch.Tensor      # (N, S1, W1)
    l1_lru: torch.Tensor
    l1_owner: torch.Tensor
    l2_tag: torch.Tensor      # (N, S2, W2)
    l2_lru: torch.Tensor
    l2_mig: torch.Tensor
    l2_last: torch.Tensor
    l2_streak: torch.Tensor
    # directory: flat (dir_entries + 1,) or home (N, per + 1); the last
    # slot is a scatter sink
    dir_loc: torch.Tensor
    # forwarding table
    fwd_tag: torch.Tensor     # (N, Fe)
    fwd_dst: torch.Tensor
    fwd_ptr: torch.Tensor     # (N,)
    # network input ports
    inp: torch.Tensor         # (N, 4, NUM_F)
    # send queue (packet ring buffer)
    q_desc: torch.Tensor      # (N, Qp + 1, NUM_Q); slot Qp is a sink
    q_head: torch.Tensor      # (N,)
    q_size: torch.Tensor      # (N,)
    q_fid: torch.Tensor       # (N,)  flit cursor of head packet
    # reorder buffer
    rob: torch.Tensor         # (N, K, NUM_R)
    # pending-completion queue (head at slot 0; depth 1 = S14 register)
    pc: torch.Tensor          # (N, pc_depth, NUM_P)
    # statistics + clock: stats is the LOW word of a base-2**30 pair
    stats: torch.Tensor       # (NUM_STATS,) int32 — total mod 2**30
    stats_hi: torch.Tensor    # (NUM_STATS,) int32 — total div 2**30
    cycle: torch.Tensor       # () int32
    # workload (read-only during the run)
    trace: torch.Tensor       # (N, M)
    # policy knobs as per-scenario tensors, initialised from SimConfig
    knob_mig: torch.Tensor      # () int32 — migration enabled?
    knob_mig_thr: torch.Tensor  # () int32 — migration streak threshold
    knob_central: torch.Tensor  # () int32 — centralized directory?
    knob_ej_age: torch.Tensor   # () int32 — guaranteed-ejection age threshold


class Geometry(NamedTuple):
    """Routing geometry, precomputed from the config.  :func:`make_geometry`
    gives numpy arrays; :func:`geometry_to` puts them on a device."""

    valid_port: np.ndarray   # (N, 4) bool — does this port physically exist
    gather_node: np.ndarray  # (N, 4) — node whose output feeds my input p
    gather_port: np.ndarray  # (4,) — which output port of that node
    node_r: np.ndarray       # (N,)
    node_c: np.ndarray       # (N,)


class NodeCtx(NamedTuple):
    """Per-node identity and geometry as tensors on the run's device."""

    node_id: torch.Tensor     # (N,) int32 global node id (r*C + c)
    node_r: torch.Tensor      # (N,) int32 row
    node_c: torch.Tensor      # (N,) int32 col
    valid_port: torch.Tensor  # (N, 4) bool
    node: torch.Tensor        # (N,) int64 — the node ids as an index


def make_geometry(rows: int, cols: int) -> Geometry:
    n = rows * cols
    idx = np.arange(n)
    r, c = idx // cols, idx % cols
    valid = np.stack([r > 0, c < cols - 1, r < rows - 1, c > 0], axis=1)  # N,E,S,W
    # input port p receives the opposite output of the neighbour in direction p
    gnode = np.stack([idx - cols, idx + 1, idx + cols, idx - 1], axis=1)
    gnode = np.where(valid, gnode, 0).astype(np.int32)
    gport = np.array([2, 3, 0, 1], np.int32)  # S, W, N, E
    return Geometry(valid.astype(bool), gnode, gport,
                    r.astype(np.int32), c.astype(np.int32))


def geometry_to(geo: Geometry, device) -> Geometry:
    """The geometry as tensors on ``device`` (gather indices as int64)."""
    return Geometry(
        torch.as_tensor(geo.valid_port, device=device),
        torch.as_tensor(geo.gather_node, dtype=torch.int64, device=device),
        torch.as_tensor(geo.gather_port, dtype=torch.int64, device=device),
        torch.as_tensor(geo.node_r, device=device),
        torch.as_tensor(geo.node_c, device=device))


def make_node_ctx(cfg: SimConfig, device) -> NodeCtx:
    geo = make_geometry(cfg.rows, cfg.cols)
    return NodeCtx(torch.arange(cfg.num_nodes, dtype=I32, device=device),
                   torch.as_tensor(geo.node_r, device=device),
                   torch.as_tensor(geo.node_c, device=device),
                   torch.as_tensor(geo.valid_port, device=device),
                   torch.arange(cfg.num_nodes, device=device))


def dir_shape(cfg: SimConfig) -> Tuple[int, ...]:
    """Directory tensor shape. ``flat``: one global location array (+ sink
    slot).  ``home``: entry for tag t lives at (t % N, t // N) — row-split
    with the nodes, so every access is local to the tag's home node."""
    if cfg.dir_layout == "flat":
        return (cfg.dir_entries + 1,)
    if cfg.centralized_directory:
        raise ValueError("home-sharded directory layout requires a "
                         "distributed directory")
    per = -(-cfg.dir_entries // cfg.num_nodes)
    return (cfg.num_nodes, per + 1)


def init_state(cfg: SimConfig, trace: np.ndarray, device) -> SimState:
    """Build the initial state on ``device``.

    ``trace`` is ``(num_nodes, M)`` for a solo run, or ``(B, num_nodes, M)``
    for a batch — every leaf then carries the same leading scenario axis
    ``B``.
    """
    cfg.validate()
    trace = np.asarray(trace)
    if trace.ndim not in (2, 3) or trace.shape[-2] != cfg.num_nodes:
        raise ValueError(
            f"trace must be (num_nodes, M) or (B, num_nodes, M) with "
            f"num_nodes={cfg.num_nodes}, got shape {trace.shape}")
    batch = trace.shape[:-2]
    n = cfg.num_nodes
    ca = cfg.cache
    dt = leaf_dtypes(cfg, trace.shape[-1])
    z = lambda k, *s: torch.zeros(batch + s, dtype=dt[k], device=device)
    neg = lambda k, *s: torch.full(batch + s, -1, dtype=dt[k], device=device)
    knob = lambda v: torch.full(batch, v, dtype=I32, device=device)
    return SimState(
        st=z("st", n), ctr=z("ctr", n), tr_ptr=z("tr_ptr", n),
        pend_addr=neg("pend_addr", n), install_mode=z("install_mode", n),
        pkt_ctr=z("pkt_ctr", n), lru_clock=z("lru_clock", n),
        l1_tag=neg("l1_tag", n, ca.l1_sets, ca.l1_ways),
        l1_lru=z("l1_lru", n, ca.l1_sets, ca.l1_ways),
        l1_owner=neg("l1_owner", n, ca.l1_sets, ca.l1_ways),
        l2_tag=neg("l2_tag", n, ca.l2_sets, ca.l2_ways),
        l2_lru=z("l2_lru", n, ca.l2_sets, ca.l2_ways),
        l2_mig=z("l2_mig", n, ca.l2_sets, ca.l2_ways),
        l2_last=neg("l2_last", n, ca.l2_sets, ca.l2_ways),
        l2_streak=z("l2_streak", n, ca.l2_sets, ca.l2_ways),
        dir_loc=torch.full(batch + dir_shape(cfg), -1, dtype=dt["dir_loc"],
                           device=device),
        fwd_tag=neg("fwd_tag", n, cfg.fwd_entries),
        fwd_dst=neg("fwd_dst", n, cfg.fwd_entries),
        fwd_ptr=z("fwd_ptr", n),
        inp=z("inp", n, NUM_PORTS, NUM_F),
        q_desc=z("q_desc", n, cfg.send_queue + 1, NUM_Q),  # +1 = sink slot
        q_head=z("q_head", n), q_size=z("q_size", n), q_fid=z("q_fid", n),
        rob=z("rob", n, cfg.rob_slots, NUM_R),
        pc=z("pc", n, cfg.pc_depth, NUM_P),
        stats=z("stats", NUM_STATS),
        stats_hi=z("stats_hi", NUM_STATS),
        cycle=z("cycle"),
        trace=torch.as_tensor(trace).to(device=device, dtype=dt["trace"]),
        knob_mig=knob(int(cfg.migration_enabled)),
        knob_mig_thr=knob(cfg.migrate_threshold),
        knob_central=knob(int(cfg.centralized_directory)),
        knob_ej_age=knob(cfg.eject_age_threshold),
    )


# ---------------------------------------------------------------------------
# Narrow-dtype storage layout (SimConfig.state_dtype_policy)
# ---------------------------------------------------------------------------

#: leaves that stay int32 under every policy: the stats hi/lo pair (the
#: accumulator arithmetic needs int32 headroom), the clock, and the knobs
_PINNED_I32 = ("stats", "stats_hi", "cycle",
               "knob_mig", "knob_mig_thr", "knob_central", "knob_ej_age")


def _fit(lo: int, hi: int) -> torch.dtype:
    """Smallest signed integer dtype holding the closed range [lo, hi]."""
    for dt in (torch.int8, torch.int16, torch.int32):
        info = torch.iinfo(dt)
        if lo >= info.min and hi <= info.max:
            return dt
    raise ValueError(f"state value bounds [{lo}, {hi}] exceed int32")


@functools.lru_cache(maxsize=None)
def leaf_dtypes(cfg: SimConfig, trace_len: int) -> Dict[str, torch.dtype]:
    """Per-leaf storage dtype map for ``cfg`` (keyed by SimState field).

    ``wide`` pins every leaf to int32.  ``packed`` derives each leaf's
    value bounds from the validated config — FSM states 0..6, tags
    ``<= (2**addr_bits - 1) >> shift``, node ids ``< num_nodes``, LRU
    clocks ``<= 3 * max_cycles + 4`` (at most three touch sites tick the
    clock per cycle), flit ages ``<= max_cycles``, packet ids
    ``< cfg.pkt_wrap`` — and picks the smallest of int8/int16/int32 that
    holds them (``-1`` sentinels included).
    """
    out = {k: I32 for k in SimState._fields}
    if cfg.state_dtype_policy != "packed":
        return out
    n = cfg.num_nodes
    addr_max = (1 << cfg.addr_bits) - 1
    clk_max = 3 * cfg.max_cycles + 4
    ctr_max = max(cfg.mem_cycles, cfg.l2_hit_cycles, cfg.l1_miss_cycles,
                  cfg.req_timeout) + 1
    flits_max = 16          # longest packet (B2) — FLITS_OF
    # every value a flit/descriptor/ROB/pending slot can carry: a message
    # type, a node id, a tag or address payload, a packet id, an age, a
    # flit count, or a -1 sentinel
    msg_hi = max(addr_max, n - 1, cfg.pkt_wrap - 1, cfg.max_cycles,
                 flits_max, NUM_MSG_TYPES)
    out.update(
        st=_fit(0, 6),
        ctr=_fit(-2, ctr_max),
        tr_ptr=_fit(0, trace_len + 1),
        pend_addr=_fit(-1, addr_max),
        install_mode=_fit(0, 1),
        # pkt_ctr may wrap in a narrow dtype: safe, because consumers only
        # ever read it mod cfg.pkt_wrap (2**14), and 2**16 = 0 mod 2**14
        pkt_ctr=_fit(0, cfg.pkt_wrap - 1),
        lru_clock=_fit(0, clk_max),
        l1_tag=_fit(-1, addr_max >> cfg.cache.l1_shift),
        l1_lru=_fit(0, clk_max),
        l1_owner=_fit(-1, n - 1),
        l2_tag=_fit(-1, addr_max >> cfg.cache.l2_shift),
        l2_lru=_fit(0, clk_max),
        l2_mig=_fit(0, 1),
        l2_last=_fit(-1, n - 1),
        l2_streak=torch.int16,   # saturating narrow (see narrow_state)
        dir_loc=_fit(-1, n - 1),
        fwd_tag=_fit(-1, addr_max >> cfg.cache.l2_shift),
        fwd_dst=_fit(-1, n - 1),
        fwd_ptr=_fit(0, cfg.fwd_entries),
        inp=_fit(-1, msg_hi),
        q_desc=_fit(-1, msg_hi),
        q_head=_fit(0, cfg.send_queue),
        q_size=_fit(0, cfg.send_queue + 1),
        q_fid=_fit(0, flits_max),
        rob=_fit(-1, msg_hi),
        pc=_fit(-1, msg_hi),
        trace=_fit(-1, addr_max),
    )
    for k in _PINNED_I32:
        out[k] = I32
    return out


def widen_state(s: SimState) -> SimState:
    """Cast every narrow leaf up to the int32 compute domain.

    ``trace`` is exempt: it is read-only during the run and its single
    consumer (``cache._next_addr``) casts after the gather.
    """
    return SimState(*(v if k == "trace" or v.dtype == I32 else v.to(I32)
                      for k, v in zip(SimState._fields, s)))


def narrow_state(s: SimState, dtypes: Dict[str, torch.dtype]) -> SimState:
    """Cast leaves back down to their storage dtypes (``leaf_dtypes``).

    All casts are value-preserving by the bounds in :func:`leaf_dtypes`,
    with two deliberate exceptions: ``pkt_ctr`` wraps (a torch integer
    cast wraps, congruent mod ``cfg.pkt_wrap``, so packet ids are
    unchanged) and ``l2_streak`` saturates at int16 max, which needs the
    explicit clamp because the cast alone would wrap.
    """
    def down(k, v):
        dt = dtypes[k]
        if v.dtype == dt:
            return v
        if k == "l2_streak":
            v = torch.clamp(v, max=torch.iinfo(torch.int16).max)
        return v.to(dt)
    return SimState(*(down(k, v) for k, v in zip(SimState._fields, s)))


def state_bytes(cfg: SimConfig, trace_len: int = 200,
                policy: Optional[str] = None) -> int:
    """Exact SimState bytes for ONE scenario of ``cfg`` (trace included).

    ``policy`` overrides ``cfg.state_dtype_policy``.  Pure shape/dtype
    arithmetic — no allocation.
    """
    if policy is not None:
        cfg = dataclasses.replace(cfg, state_dtype_policy=policy)
    cfg.validate()
    n, ca = cfg.num_nodes, cfg.cache
    shapes = dict(
        st=(n,), ctr=(n,), tr_ptr=(n,), pend_addr=(n,), install_mode=(n,),
        pkt_ctr=(n,), lru_clock=(n,),
        l1_tag=(n, ca.l1_sets, ca.l1_ways), l1_lru=(n, ca.l1_sets, ca.l1_ways),
        l1_owner=(n, ca.l1_sets, ca.l1_ways),
        l2_tag=(n, ca.l2_sets, ca.l2_ways), l2_lru=(n, ca.l2_sets, ca.l2_ways),
        l2_mig=(n, ca.l2_sets, ca.l2_ways), l2_last=(n, ca.l2_sets, ca.l2_ways),
        l2_streak=(n, ca.l2_sets, ca.l2_ways),
        dir_loc=dir_shape(cfg),
        fwd_tag=(n, cfg.fwd_entries), fwd_dst=(n, cfg.fwd_entries),
        fwd_ptr=(n,),
        inp=(n, NUM_PORTS, NUM_F),
        q_desc=(n, cfg.send_queue + 1, NUM_Q),
        q_head=(n,), q_size=(n,), q_fid=(n,),
        rob=(n, cfg.rob_slots, NUM_R), pc=(n, cfg.pc_depth, NUM_P),
        stats=(NUM_STATS,), stats_hi=(NUM_STATS,), cycle=(),
        trace=(n, trace_len),
        knob_mig=(), knob_mig_thr=(), knob_central=(), knob_ej_age=(),
    )
    dt = leaf_dtypes(cfg, trace_len)
    return sum(int(np.prod(shp, dtype=np.int64)) * dt[k].itemsize
               for k, shp in shapes.items())


# ---------------------------------------------------------------------------
# 64-bit statistics accumulator (base-2**30 hi/lo int32 pair)
# ---------------------------------------------------------------------------

#: fold base.  Per-cycle increments stay far below 2**31 - 2**30, so the
#: low word never overflows between folds even at 43k nodes.
STATS_FOLD = 1 << 30


def fold_stats(hi: torch.Tensor, lo: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Carry the low stats word into the high word: returns the canonical
    pair with ``lo = total mod 2**30``.  Floor division, so a negative
    transient ``lo`` normalizes correctly."""
    carry = torch.div(lo, STATS_FOLD, rounding_mode="floor")
    return hi + carry, lo - carry * STATS_FOLD


def stats_totals(hi, lo) -> np.ndarray:
    """Exact int64 counter totals from a (hi, lo) stats pair (host side)."""
    as_np = lambda x: (x.cpu().numpy() if isinstance(x, torch.Tensor)
                       else np.asarray(x))
    return as_np(hi).astype(np.int64) * STATS_FOLD + as_np(lo).astype(np.int64)


def bump(stats: torch.Tensor, name: str, amount) -> torch.Tensor:
    """Add ``amount`` (a Python int, or a tensor to be summed) to a named
    statistic; one-statistic form of :func:`bump_all`."""
    if not isinstance(amount, torch.Tensor):
        amount = torch.tensor(amount, dtype=I32, device=stats.device)
    return bump_all(stats, [(name, amount)])


@functools.lru_cache(maxsize=None)
def _stat_index(names: Tuple[str, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor([STAT_INDEX[k] for k in names], device=device)


def bump_all(stats: torch.Tensor,
             bumps: List[Tuple[str, torch.Tensor]]) -> torch.Tensor:
    """Add each ``(name, amount)`` increment to its named statistic in
    ``stats`` (the LOW word of the base-2**30 pair; the per-cycle fold in
    ``sim.cycle_step`` carries overflow into ``stats_hi``); returns a new
    tensor.  An amount is a tensor to be summed: the (N,) masks are summed
    in one reduction and every increment lands in one ``index_add``
    (names may repeat), so a phase's statistics cost a few ops, not a few
    per statistic."""
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
