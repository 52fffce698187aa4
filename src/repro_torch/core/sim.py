"""Simulator driver: the paper's main loop (§7.1/§7.2) in PyTorch.

The serial version's

    while not finished: Phase1(all); Phase2(all); Phase3(all)

becomes :func:`cycle_step` (phases 1a, 1b, 2, 3 over all nodes at once)
inside a Python loop.  The counterpart of the JAX package's
``repro.core.sim``, with the same contract:

* The driver is batched: a state has a leading scenario axis B, and a
  solo ``run`` is a batch of one.  Every scenario terminates on its own;
  a finished scenario keeps stepping (a no-op on every leaf but the
  clock), and the driver records each scenario's finish cycle and
  rewrites ``cycle`` at the end.
* Termination is checked once per K-cycle chunk (one host sync a chunk);
  the tail then steps cycle by cycle up to ``max_cycles``.  Neither a
  phase nor the monitors sync with the host on every cycle.
* Progress monitors, per scenario: **livelock** (no progress statistic
  — anything but ``hops``/``deflections`` — changes for
  ``cfg.livelock_window_effective`` cycles) and **directory saturation**
  (centralized directory at >= 256 nodes, every ``cfg.sat_window``
  cycles).  A monitor only stops a run early, snapshotting the
  statistics and a diagnostic at the abort cycle.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no GPU they raise and never fall back to the CPU.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from .cache import phase1a, phase1b
from .config import ST_DONE, ST_WAIT_DATA, ST_WAIT_DIR, SimConfig
from .noc import phase2, phase3
from .state import (F_DST, F_VALID, I32, P_VALID, R_NFL, STAT_NAMES,
                    Geometry, NodeCtx, SimState, fold_stats, geometry_to,
                    init_state, leaf_dtypes, make_geometry, make_node_ctx,
                    narrow_state, stats_totals, widen_state)

__all__ = ["cycle_step", "finished", "run", "stats_list", "ExecAux",
           "VectorSim", "ABORT_LABELS", "check_cycle_cap", "aggregate_stats",
           "network_health", "resolve_device"]

#: statistics that witness forward progress.  hops/deflections are excluded:
#: they keep rising while flits merely circulate, which is exactly the
#: livelock signature the monitor must see *through*.
_PROG_IDX = tuple(i for i, k in enumerate(STAT_NAMES)
                  if k not in ("hops", "deflections"))


@functools.lru_cache(maxsize=None)
def _prog_index(device: torch.device) -> torch.Tensor:
    return torch.tensor(_PROG_IDX, device=device)

ABORT_NONE, ABORT_LIVELOCK, ABORT_SATURATION = 0, 1, 2
ABORT_LABELS = {ABORT_LIVELOCK: "livelock", ABORT_SATURATION: "dir_saturation"}
_SAT_MIN_NODES = 256


def resolve_device(device=None) -> torch.device:
    """The device a run uses: ``cuda`` unless the caller names another.
    Raises when CUDA is asked for (or implied) and there is no GPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the simulator runs on the GPU by "
            "default and does not fall back to the CPU — pass device='cpu' "
            "to run on the CPU")
    return dev


class ExecAux(NamedTuple):
    """Per-scenario abort record returned by the driver next to the state.

    All leaves are ``(B,)`` (or ``()`` for a solo run) except
    ``abort_stats``/``abort_stats_hi`` which are ``(B, NUM_STATS)``.
    ``abort == 0`` means the scenario ran to completion or to
    ``max_cycles`` untouched; the remaining fields are then zero."""

    abort: torch.Tensor          # 0 none | 1 livelock | 2 dir saturation
    abort_cycle: torch.Tensor
    abort_stats: torch.Tensor    # stats LOW-word snapshot at the abort cycle
    abort_stats_hi: torch.Tensor  # stats HIGH-word snapshot
    circ: torch.Tensor           # circulating (in-flight) flits at abort
    wait_dir: torch.Tensor       # nodes in WAIT_DIR at abort
    wait_data: torch.Tensor      # nodes in WAIT_DATA at abort
    stalled: torch.Tensor        # nodes with a backlogged send queue at abort
    dst0: torch.Tensor           # in-flight flits destined to node 0 at abort


class _Mon(NamedTuple):
    prev_prog: torch.Tensor    # (B, P) progress stats last cycle
    frz: torch.Tensor          # (B,) consecutive frozen cycles
    refs_anchor: torch.Tensor  # (B,) sum(tr_ptr) at the last window edge
    aux: ExecAux


def cycle_step(s: SimState, cfg: SimConfig, geo: Geometry,
               ctx: NodeCtx) -> SimState:
    """One simulated cycle of one scenario = phases 1a, 1b, 2, 3 (S1).

    The phases compute in int32: under a packed storage layout the state
    is widened on entry and narrowed back on exit.  The cycle boundary
    also folds the low stats word into ``stats_hi``.  ``geo`` holds
    tensors on the state's device (:func:`state.geometry_to`)."""
    dtypes = leaf_dtypes(cfg, s.trace.shape[-1])
    s = widen_state(s)
    s = phase1a(s, cfg, ctx)
    s = phase1b(s, cfg, ctx)
    s, arb = phase2(s, cfg, ctx)
    s = phase3(s, cfg, geo, ctx, arb)
    hi, lo = fold_stats(s.stats_hi, s.stats)
    return narrow_state(
        s._replace(cycle=s.cycle + 1, stats=lo, stats_hi=hi), dtypes)


def finished(s: SimState) -> torch.Tensor:
    """Termination predicate.  0-d for a solo state; ``(B,)`` for a
    batched state (reductions run over everything but the leading
    scenario axis)."""
    b = s.cycle.dim()                      # 0 solo, 1 batched
    flat = lambda x: x.reshape(x.shape[:b] + (-1,))
    done = (flat(s.st) == ST_DONE).all(dim=-1)
    net_empty = ~flat(s.inp[..., F_VALID] > 0).any(dim=-1)
    q_empty = (flat(s.q_size) == 0).all(dim=-1)
    rob_empty = (flat(s.rob[..., R_NFL]) == 0).all(dim=-1)
    pc_empty = (flat(s.pc[..., P_VALID]) == 0).all(dim=-1)
    return done & net_empty & q_empty & rob_empty & pc_empty


def _index(s: SimState, b: int) -> SimState:
    return SimState(*(x[b] for x in s))


def _stack(states: List[SimState]) -> SimState:
    return SimState(*(torch.stack(xs) for xs in zip(*states)))


def _mon_init(stats: torch.Tensor, tr_ptr: torch.Tensor) -> _Mon:
    b = stats.shape[0]
    zb = torch.zeros(b, dtype=I32, device=stats.device)
    aux = ExecAux(abort=zb, abort_cycle=zb,
                  abort_stats=torch.zeros_like(stats),
                  abort_stats_hi=torch.zeros_like(stats),
                  circ=zb, wait_dir=zb, wait_data=zb, stalled=zb, dst0=zb)
    return _Mon(prev_prog=stats[:, _prog_index(stats.device)], frz=zb,
                refs_anchor=tr_ptr.sum(dim=-1, dtype=I32), aux=aux)


def _mon_update(mon: _Mon, st: SimState, active: torch.Tensor,
                cfg: SimConfig, cycle: int, steps: int) -> _Mon:
    """Advance the livelock/saturation monitors one cycle (batched state
    ``st``).

    ``cycle`` is the clock after the step and ``steps`` the cycles this
    drive has stepped; both are known on the host (one clock for every
    scenario), so the O(N) saturation reductions run only at
    ``sat_window`` edges, and the O(N) diagnostic snapshot only on cycles
    where a monitor can fire — without reading anything back."""
    n = cfg.num_nodes
    lw = cfg.livelock_window_effective
    sw = cfg.sat_window if n >= _SAT_MIN_NODES else 0

    prog = st.stats[:, _prog_index(st.stats.device)]
    frz = torch.where((prog == mon.prev_prog).all(dim=-1), mon.frz + 1, 0)
    can_lv = lw > 0 and steps >= lw
    fire_lv = (active & (frz >= lw)) if can_lv else torch.zeros_like(active)

    at_edge = sw > 0 and cycle % sw == 0
    if at_edge:
        refs = st.tr_ptr.sum(dim=-1, dtype=I32)
        wd = (st.st == ST_WAIT_DIR).sum(dim=-1, dtype=I32)
        wdd = (st.st == ST_WAIT_DATA).sum(dim=-1, dtype=I32)
        fire_sat = (active & (st.knob_central > 0)
                    & ((wd + wdd) * 2 >= n)
                    & ((refs - mon.refs_anchor) * 2 < n))
        refs_anchor = refs
    else:
        fire_sat = torch.zeros_like(active)
        refs_anchor = mon.refs_anchor
    if not (can_lv or at_edge):
        return _Mon(prog, frz, refs_anchor, mon.aux)

    fire_lv = fire_lv & ~fire_sat      # saturation is the sharper diagnosis
    fire = fire_lv | fire_sat
    aux = mon.aux
    valid = st.inp[..., F_VALID] > 0
    circ = valid.sum(dim=(-2, -1), dtype=I32)
    dst0 = (valid & (st.inp[..., F_DST] == 0)).sum(dim=(-2, -1), dtype=I32)
    stalled = (st.q_size > 0).sum(dim=-1, dtype=I32)
    wd = (st.st == ST_WAIT_DIR).sum(dim=-1, dtype=I32)
    wdd = (st.st == ST_WAIT_DATA).sum(dim=-1, dtype=I32)
    snap = lambda new, old: torch.where(fire, new, old)
    aux = ExecAux(
        abort=torch.where(fire, torch.where(fire_sat, ABORT_SATURATION,
                                            ABORT_LIVELOCK), aux.abort
                          ).to(I32),
        abort_cycle=snap(st.cycle, aux.abort_cycle),
        abort_stats=torch.where(fire[:, None], st.stats, aux.abort_stats),
        abort_stats_hi=torch.where(fire[:, None], st.stats_hi,
                                   aux.abort_stats_hi),
        circ=snap(circ, aux.circ),
        wait_dir=snap(wd, aux.wait_dir),
        wait_data=snap(wdd, aux.wait_data),
        stalled=snap(stalled, aux.stalled),
        dst0=snap(dst0, aux.dst0),
    )
    return _Mon(prog, frz, refs_anchor, aux)


@torch.inference_mode()
def _drive(s: SimState, cfg: SimConfig, max_cycles: int,
           chunk: int) -> Tuple[SimState, ExecAux]:
    """Drive a state to completion; returns ``(state, ExecAux)``.

    ``s`` is solo or batched.  Each scenario steps as its own solo state
    (the batch is a Python loop over scenarios), and the monitors and the
    termination predicate run on a (B, ...) view of the scenarios."""
    solo = s.cycle.dim() == 0
    dev = s.cycle.device
    states = [s] if solo else [_index(s, b) for b in range(s.cycle.shape[0])]
    geo = geometry_to(make_geometry(cfg.rows, cfg.cols), dev)
    ctx = make_node_ctx(cfg, dev)

    # the per-scenario view the monitors read: a batch of one is a view,
    # not a copy
    batch = ((lambda xs: xs[0].unsqueeze(0)) if len(states) == 1
             else torch.stack)
    done = torch.full((len(states),), -1, dtype=I32, device=dev)
    mon = _mon_init(batch([x.stats for x in states]),
                    batch([x.tr_ptr for x in states]))
    clock = int(states[0].cycle)           # one clock for every scenario
    steps = 0

    def step():
        nonlocal states, done, mon, clock, steps
        states = [cycle_step(x, cfg, geo, ctx) for x in states]
        clock += 1
        steps += 1
        view = SimState(*(batch(xs) if k in _MON_LEAVES else None
                          for k, xs in zip(SimState._fields, zip(*states))))
        fin = batch([finished(x) for x in states])
        done = torch.where((done < 0) & fin, view.cycle, done)
        active = (done < 0) & (mon.aux.abort == 0)
        mon = _mon_update(mon, view, active, cfg, clock, steps)

    def alive() -> bool:
        return bool(((done < 0) & (mon.aux.abort == 0)).any())

    if chunk > 1:
        # main loop: whole chunks with no per-cycle host sync; the check
        # keeps whole chunks from overstepping the cycle cap
        while clock + chunk <= max_cycles and alive():
            for _ in range(chunk):
                step()
    # tail: per-cycle, so an unfinished scenario stops at exactly
    # max_cycles
    while clock < max_cycles and alive():
        step()

    aux = mon.aux
    # finished scenarios kept no-op stepping; restore their true clock.
    # aborted scenarios report the abort cycle.
    cyc = torch.where(done >= 0, done,
                      torch.where(aux.abort > 0, aux.abort_cycle,
                                  batch([x.cycle for x in states])))
    if solo:
        return (states[0]._replace(cycle=cyc[0]),
                ExecAux(*(x[0] for x in aux)))
    return _stack(states)._replace(cycle=cyc), aux


#: leaves the monitors read from the stacked per-scenario view
_MON_LEAVES = ("st", "inp", "q_size", "tr_ptr", "stats", "stats_hi", "cycle",
               "knob_central")


def stats_list(s: SimState, aux: ExecAux) -> List[Dict[str, int]]:
    """Per-scenario statistics dicts from a driven state + its ExecAux.

    Healthy scenarios get exactly the classic key set (STAT_NAMES +
    ``cycles`` + ``finished``).  Aborted scenarios report the snapshot
    taken at the abort cycle plus ``aborted`` (label) and the diagnostic
    counters."""
    stats = np.atleast_2d(stats_totals(s.stats_hi, s.stats))
    cyc = np.atleast_1d(s.cycle.cpu().numpy())
    fin = np.atleast_1d(finished(s).cpu().numpy())
    a = {k: np.atleast_1d(v.cpu().numpy()) for k, v in aux._asdict().items()}
    a["abort_stats"] = np.atleast_2d(
        stats_totals(aux.abort_stats_hi, aux.abort_stats))
    out = []
    for b in range(cyc.shape[0]):
        code = int(a["abort"][b])
        if code:
            d = {k: int(v) for k, v in zip(STAT_NAMES, a["abort_stats"][b])}
            d["cycles"] = int(a["abort_cycle"][b])
            d["finished"] = 0
            d["aborted"] = ABORT_LABELS[code]
            d["circulating_flits"] = int(a["circ"][b])
            d["wait_dir_nodes"] = int(a["wait_dir"][b])
            d["wait_data_nodes"] = int(a["wait_data"][b])
            d["stalled_queues"] = int(a["stalled"][b])
            d["flits_to_node0"] = int(a["dst0"][b])
        else:
            d = {k: int(v) for k, v in zip(STAT_NAMES, stats[b])}
            d["cycles"] = int(cyc[b])
            d["finished"] = int(bool(fin[b]))
        out.append(d)
    return out


def aggregate_stats(stats: List[Dict[str, int]]) -> Dict[str, int]:
    """Sum the ``STAT_NAMES`` counters over per-scenario ``stats`` dicts;
    ``cycles`` becomes the max and ``finished`` the min, so the aggregate
    reads like one worst-case scenario.  Diagnostic keys are dropped."""
    out = {k: sum(int(d.get(k, 0)) for d in stats) for k in STAT_NAMES}
    out["cycles"] = max((int(d.get("cycles", 0)) for d in stats), default=0)
    out["finished"] = min((int(d.get("finished", 0)) for d in stats),
                          default=0)
    return out


def network_health(stats: Dict[str, int]) -> Dict[str, float]:
    """Derived network-health ratios from one statistics dict:
    ``deflection_rate`` (deflections per hop), ``hops_per_flit`` and
    ``deflections_per_flit`` (per delivered flit), ``drops_recovered``
    (``send_drop``) and ``stray_responses`` (``stray``)."""
    hops = int(stats.get("hops", 0))
    defl = int(stats.get("deflections", 0))
    flits = int(stats.get("flits_delivered", 0))
    return {
        "deflection_rate": defl / hops if hops else 0.0,
        "hops_per_flit": hops / flits if flits else 0.0,
        "deflections_per_flit": defl / flits if flits else 0.0,
        "drops_recovered": int(stats.get("send_drop", 0)),
        "stray_responses": int(stats.get("stray", 0)),
    }


def check_cycle_cap(cfg: SimConfig, max_cycles: Optional[int]) -> None:
    """Reject a per-call cycle cap above ``cfg.max_cycles`` under the
    packed layout: its narrow dtypes (LRU clocks, flit ages) are sized
    from the config's own cap.  The wide layout accepts any cap."""
    if (cfg.state_dtype_policy == "packed" and max_cycles is not None
            and max_cycles > cfg.max_cycles):
        raise ValueError(
            f"max_cycles={max_cycles} exceeds cfg.max_cycles="
            f"{cfg.max_cycles}: the packed state layout sizes its narrow "
            "dtypes from the config cap — raise cfg.max_cycles instead")


def run(cfg: SimConfig, trace: np.ndarray, max_cycles: Optional[int] = None,
        chunk: int = 1, device=None
        ) -> Union[Dict[str, int], List[Dict[str, int]]]:
    """Run the simulator to completion; returns statistics.

    Args:
        cfg: the simulation config (mesh shape, caches, policies).
        trace: ``(num_nodes, M)`` for a solo run (returns one dict) or
            ``(B, num_nodes, M)`` for a batched run (returns a list of
            dicts; the policy knobs are shared).
        max_cycles: hard cycle cap (default ``cfg.max_cycles``).
        chunk: simulated cycles per termination check (one host sync).
        device: ``None`` (the GPU), ``"cuda"``, ``"cuda:<i>"`` or
            ``"cpu"``.  Without a GPU only ``"cpu"`` runs."""
    check_cycle_cap(cfg, max_cycles)
    dev = resolve_device(device)
    s = init_state(cfg, trace, dev)
    solo = s.cycle.dim() == 0
    s, aux = _drive(s, cfg, max_cycles or cfg.max_cycles, chunk)
    out = stats_list(s, aux)
    return out[0] if solo else out


class VectorSim:
    """Step-at-a-time wrapper of one solo scenario (the tests compare it
    against the JAX package cycle by cycle)."""

    def __init__(self, cfg: SimConfig, trace: np.ndarray, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.geo = geometry_to(make_geometry(cfg.rows, cfg.cols),
                               self.device)
        self.ctx = make_node_ctx(cfg, self.device)
        self.state = init_state(cfg, trace, self.device)

    @torch.inference_mode()
    def step(self) -> None:
        self.state = cycle_step(self.state, self.cfg, self.geo, self.ctx)

    def stats(self) -> Dict[str, int]:
        st = stats_totals(self.state.stats_hi, self.state.stats)
        out = {k: int(v) for k, v in zip(STAT_NAMES, st)}
        out["cycles"] = int(self.state.cycle)
        out["finished"] = int(bool(finished(self.state)))
        return out

    def run(self, max_cycles: Optional[int] = None) -> Dict[str, int]:
        limit = max_cycles or self.cfg.max_cycles
        self.state, _ = _drive(self.state, self.cfg, limit, 1)
        return self.stats()
