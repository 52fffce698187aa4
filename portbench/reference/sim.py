"""The reference simulator's driver: one scenario, cycle by cycle.

The paper's loop ``while not finished: Phase1; Phase2; Phase3`` over all
nodes at once, with the port's progress monitors and statistics, frozen
from the port's ``core/sim.py``.  It steps one scenario at a time; a
sweep's scenarios are run one after another, each with its own knobs,
which is what the port's sweep promises to equal.

The state stays int32 throughout.  Under the packed layout the port
stores each leaf in a narrower type between cycles; the two casts that
change a value (packet ids wrapped at ``pkt_wrap``, migration streaks
saturated at the int16 maximum) are applied here too, so the statistics
are those of the configuration as stated.  ``control=True`` instead
passes every leaf through the integer type one width below its storage
type in the configuration's layout at each cycle's end: the control,
which has to come out wrong.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .cache import phase1a, phase1b
from .config import ST_DONE, ST_WAIT_DATA, ST_WAIT_DIR, Config
from .noc import phase2, phase3
from .state import (F_DST, F_VALID, I32, P_VALID, PINNED_I32, R_NFL,
                    STAT_NAMES, SimState, fold_stats, init_state, leaf_dtypes,
                    make_geometry, stats_totals)

#: progress statistics: all but hops and deflections, which keep rising
#: while flits only circulate
_PROG_IDX = tuple(i for i, k in enumerate(STAT_NAMES)
                  if k not in ("hops", "deflections"))
_SAT_MIN_NODES = 256
_LOWER = {torch.int32: torch.int16, torch.int16: torch.int8,
          torch.int8: torch.int8}


def _narrowing(cfg: Config, trace_len: int, control: bool):
    """The value changes of the storage layout at a cycle's end, as a
    function of a state."""
    if control:
        dts = leaf_dtypes(cfg, trace_len)

        def lower(s: SimState) -> SimState:
            return SimState(*(
                v if k in PINNED_I32 or k == "trace"
                else v.to(_LOWER[dts[k]]).to(I32)
                for k, v in zip(SimState._fields, s)))
        return lower
    if cfg.state_dtype_policy == "packed":
        return lambda s: s._replace(
            l2_streak=torch.clamp(s.l2_streak, max=torch.iinfo(torch.int16).max))
    return lambda s: s


def cycle_step(s: SimState, cfg: Config, geo, ctx) -> SimState:
    s = phase1a(s, cfg, ctx)
    s = phase1b(s, cfg, ctx)
    s, arb = phase2(s, cfg, ctx)
    s = phase3(s, cfg, geo, ctx, arb)
    hi, lo = fold_stats(s.stats_hi, s.stats)
    return s._replace(cycle=s.cycle + 1, stats=lo, stats_hi=hi)


def stepper(s0: SimState, cfg: Config, geo, ctx, narrow):
    """One cycle of the reference as a function of the state.  On a CUDA
    device the cycle's plain operations are captured once as a CUDA graph
    and replayed: the same kernels on the same inputs, issued without the
    host's per-operation cost.  The returned state is then the graph's
    own output, overwritten by the next call."""
    def eager(s: SimState) -> SimState:
        return narrow(cycle_step(s, cfg, geo, ctx))
    if s0.cycle.device.type != "cuda":
        return eager
    static = SimState(*(x.clone() for x in s0))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):          # fills the index tables and the pool
            eager(static)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = eager(static)

    def replay(s: SimState) -> SimState:
        for dst, src in zip(static, s):
            if dst is not src:
                dst.copy_(src)
        g.replay()
        return out
    return replay


def finished(s: SimState) -> torch.Tensor:
    return ((s.st == ST_DONE).all()
            & ~(s.inp[..., F_VALID] > 0).any()
            & (s.q_size == 0).all()
            & (s.rob[..., R_NFL] == 0).all()
            & (s.pc[..., P_VALID] == 0).all())


@torch.inference_mode()
def run(cfg: Config, trace: np.ndarray, max_cycles: int, device,
        chunk: int = 8, control: bool = False) -> Dict[str, int]:
    """Run one scenario to the end or to ``max_cycles``; its statistics
    as the port's ``run`` reports them: every counter, ``cycles`` and
    ``finished``, or the snapshot at the cycle where a progress monitor
    stopped it (with ``aborted`` and the diagnostic counts).  On a CUDA
    device each cycle is replayed as a CUDA graph (:func:`stepper`)."""
    geo, ctx = make_geometry(cfg, device)
    s = init_state(cfg, trace, device)
    narrow = _narrowing(cfg, s.trace.shape[1], control)
    step = stepper(s, cfg, geo, ctx, narrow)
    prog_idx = torch.tensor(_PROG_IDX, device=device)
    n = cfg.num_nodes
    lw = cfg.livelock_window_effective
    sw = cfg.sat_window if n >= _SAT_MIN_NODES else 0

    prev = s.stats[prog_idx]
    zero = torch.zeros((), dtype=I32, device=device)
    frz = zero
    anchor = s.tr_ptr.sum(dtype=I32)
    done_at = zero - 1
    # the monitors' record, on the device: code (0 none, 1 livelock,
    # 2 directory saturation), cycle, statistics and diagnostic counts
    abort, abort_cycle = zero, zero
    abort_lo, abort_hi = torch.zeros_like(s.stats), torch.zeros_like(s.stats)
    diag = torch.zeros(5, dtype=I32, device=device)
    clock = 0
    while clock < max_cycles:
        for _ in range(min(chunk, max_cycles - clock)):
            s = step(s)
            clock += 1
            done_at = torch.where((done_at < 0) & finished(s), s.cycle,
                                  done_at)
            active = (done_at < 0) & (abort == 0)
            prog = s.stats[prog_idx]
            frz = torch.where((prog == prev).all(), frz + 1, 0)
            prev = prog
            can_lv = lw > 0 and clock >= lw
            at_edge = sw > 0 and clock % sw == 0
            if not (can_lv or at_edge):
                continue
            fire_lv = active & (frz >= lw) if can_lv else active & False
            fire_sat = active & False
            if at_edge:
                refs = s.tr_ptr.sum(dtype=I32)
                waiting = ((s.st == ST_WAIT_DIR).sum(dtype=I32)
                           + (s.st == ST_WAIT_DATA).sum(dtype=I32))
                fire_sat = (active & (s.knob_central > 0)
                            & (waiting * 2 >= n) & ((refs - anchor) * 2 < n))
                anchor = refs
            fire = (fire_lv & ~fire_sat) | fire_sat
            abort = torch.where(fire, torch.where(fire_sat, 2, 1), abort)
            abort_cycle = torch.where(fire, s.cycle, abort_cycle)
            abort_lo = torch.where(fire, s.stats, abort_lo)
            abort_hi = torch.where(fire, s.stats_hi, abort_hi)
            diag = torch.where(fire, _diag(s), diag)
        if bool((done_at >= 0) | (abort > 0)):
            break
    code = int(abort)
    if code:
        out = {k: int(v) for k, v in zip(
            STAT_NAMES, stats_totals(abort_hi, abort_lo))}
        out.update(cycles=int(abort_cycle), finished=0,
                   aborted={1: "livelock", 2: "dir_saturation"}[code])
        out.update(zip(DIAG_NAMES, (int(x) for x in diag.cpu())))
        return out
    out = {k: int(v) for k, v in zip(
        STAT_NAMES, stats_totals(s.stats_hi, s.stats))}
    out["cycles"] = int(done_at) if int(done_at) >= 0 else int(s.cycle)
    out["finished"] = int(bool(finished(s)))
    return out


#: the diagnostic counts of an aborted run, in :func:`_diag`'s order
DIAG_NAMES = ("circulating_flits", "wait_dir_nodes", "wait_data_nodes",
              "stalled_queues", "flits_to_node0")


def _diag(s: SimState) -> torch.Tensor:
    valid = s.inp[..., F_VALID] > 0
    return torch.stack([
        valid.sum(dtype=I32), (s.st == ST_WAIT_DIR).sum(dtype=I32),
        (s.st == ST_WAIT_DATA).sum(dtype=I32), (s.q_size > 0).sum(dtype=I32),
        (valid & (s.inp[..., F_DST] == 0)).sum(dtype=I32)])
