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
* Each scenario's state is stepped in place: a cycle's result is
  narrowed straight into the scenario's own tensors.  On a CUDA device
  each scenario's cycle is captured once as a CUDA graph
  (:class:`CycleGraph`) and replayed, one launch a scenario-cycle in
  place of ~1,500 eager ones, phases 1a and 1b in one launch of the
  cache-phase kernel; elsewhere the pure cycle runs eagerly and its
  result is written back.
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
from typing import (Callable, Dict, List, NamedTuple, Optional, Tuple,
                    Union)

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import cache_phase, router_phase
from ..tracing import RECORDER
from .cache import phase1a, phase1b
from .config import ST_DONE, ST_WAIT_DATA, ST_WAIT_DIR, SimConfig
from .noc import phase2, phase3
from .state import (CACHE_LEAVES, F_DST, F_VALID, I32, P_VALID, R_NFL,
                    STAT_NAMES, Geometry, NodeCtx, SimState, fold_stats,
                    geometry_to, init_state, leaf_dtypes, make_geometry,
                    make_node_ctx, narrow_state, stats_totals, widen_state)

__all__ = ["cycle_step", "CycleGraph", "finished", "run", "stats_list",
           "stats_dicts", "diag_counts", "DIAG_FIELDS", "ExecAux",
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


#: ExecAux's diagnostic fields, in :func:`diag_counts`'s order
DIAG_FIELDS = ("circ", "wait_dir", "wait_data", "stalled", "dst0")


def diag_counts(st: torch.Tensor, inp: torch.Tensor,
                q_size: torch.Tensor) -> torch.Tensor:
    """Abort-diagnostic counters over the nodes of a state's leaves ``st``
    ``(..., N)``, ``inp`` ``(..., N, 4, F)`` and ``q_size`` ``(..., N)``,
    as int32 ``(..., 5)`` in :data:`DIAG_FIELDS` order: in-flight flits,
    nodes in WAIT_DIR and in WAIT_DATA, nodes with a backlogged send
    queue, in-flight flits bound for node 0.  Leading scenario axes are
    kept.  The counts of a mesh's tiles add up to the mesh's."""
    valid = inp[..., F_VALID] > 0
    return torch.stack([
        valid.sum(dim=(-2, -1), dtype=I32),
        (st == ST_WAIT_DIR).sum(dim=-1, dtype=I32),
        (st == ST_WAIT_DATA).sum(dim=-1, dtype=I32),
        (q_size > 0).sum(dim=-1, dtype=I32),
        (valid & (inp[..., F_DST] == 0)).sum(dim=(-2, -1), dtype=I32)],
        dim=-1)


class _Mon(NamedTuple):
    prev_prog: torch.Tensor    # (B, P) progress stats last cycle
    frz: torch.Tensor          # (B,) consecutive frozen cycles
    refs_anchor: torch.Tensor  # (B,) sum(tr_ptr) at the last window edge
    aux: ExecAux


def cycle_step(s: SimState, cfg: SimConfig, geo: Geometry,
               ctx: NodeCtx, graph: Optional[CycleGraph] = None
               ) -> SimState:
    """One simulated cycle of one scenario = phases 1a, 1b, 2, 3 (S1).

    The phases compute in int32: under a packed storage layout the state
    is widened on entry and narrowed back on exit.  The cycle boundary
    also folds the low stats word into ``stats_hi``.  ``geo`` holds
    tensors on the state's device (:func:`state.geometry_to`).

    Without ``graph`` the step is pure: it returns a new state.  With
    ``graph``, the scenario's :class:`CycleGraph` on a CUDA device, the
    cycle is stepped in place (:func:`_cycle` with ``in_place``) and
    ``s`` is returned: the graph's first step runs the cycle eagerly and
    captures it, every later step replays the capture.

    With :data:`repro_torch.tracing.RECORDER` on, the cycle is a
    ``cycle`` span holding ``cast`` (entry; exit), ``phase1a``,
    ``phase1b`` (on the card, where the cycle is stepped in place, one
    ``phase1`` span instead), ``phase2``, ``phase3`` and ``cast`` spans
    where it runs eagerly or is captured, and a ``replay`` span where it
    is replayed."""
    with RECORDER.span("cycle"):
        if graph is None:
            return _cycle(s, cfg, geo, ctx)
        graph.step(lambda: _cycle(s, cfg, geo, ctx, in_place=True))
        return s


def _cycle(s: SimState, cfg: SimConfig, geo: Geometry, ctx: NodeCtx,
           in_place: bool = False) -> SimState:
    """:func:`cycle_step`'s phases.  ``in_place`` steps ``s`` itself and
    returns it: phases 1a and 1b are one launch of the cache-phase kernel
    (``kernels.cache_phase``, a ``phase1`` span), which writes the L1 and
    L2 arrays in place in their storage dtypes, and every other leaf is
    narrowed back into ``s``'s own tensor (:func:`state.narrow_state`).
    The kernel runs only on the card; elsewhere its wrapper raises."""
    dtypes = leaf_dtypes(cfg, s.trace.shape[-1])
    with RECORDER.span("cast"):
        w = widen_state(s, CACHE_LEAVES) if in_place else widen_state(s)
    if in_place:
        with RECORDER.span("phase1"):
            w = cache_phase.phase1_cache_cuda(w, cfg)
    else:
        with RECORDER.span("phase1a"):
            w = phase1a(w, cfg, ctx)
        with RECORDER.span("phase1b"):
            w = phase1b(w, cfg, ctx)
    with RECORDER.span("phase2"):
        w, arb = phase2(w, cfg, ctx)
    with RECORDER.span("phase3"):
        w = phase3(w, cfg, geo, ctx, arb)
    with RECORDER.span("cast"):
        hi, lo = fold_stats(w.stats_hi, w.stats)
        w = w._replace(cycle=w.cycle + 1, stats=lo, stats_hi=hi)
        if in_place:
            return narrow_state(w, dtypes, into=s)
        return narrow_state(w, dtypes)


#: the launch counters of the hand-written kernels a cycle runs on the
#: card: K1 (Phase 2) and the cache phases
KERNEL_LAUNCHES = (router_phase.LAUNCHES, cache_phase.LAUNCHES)


class CycleGraph:
    """One scenario's cycle as a CUDA graph over the scenario's own state
    tensors, which the graph reads and writes in place.

    The first :meth:`step` runs the cycle eagerly on the capture stream
    ``stream``, a real cycle that also makes what the cycle creates
    lazily (the index tables, K1's scratch words for that stream, K1's
    shared-memory opt-in) outside the graph, and then captures it; every
    later step replays the capture.  The graphs of one drive share the
    memory pool ``pool``: they replay one after another on one stream,
    and once a cycle has written the state back nothing in the pool is
    read again.  A replay adds the launches the capture holds of each
    hand-written kernel to its counter (:data:`KERNEL_LAUNCHES`)."""

    def __init__(self, stream: torch.cuda.Stream, pool):
        self.stream, self.pool = stream, pool
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.launches = [0] * len(KERNEL_LAUNCHES)

    def step(self, body: Callable[[], object]) -> None:
        """Step the cycle that ``body`` computes in place: eagerly and
        captured the first time, replayed after."""
        if self.graph is None:
            self._capture(body)
            return
        with RECORDER.span("replay"):
            self.graph.replay()
        RECORDER.count("graph_replays")
        for c, n in zip(KERNEL_LAUNCHES, self.launches):
            c.n += n

    def _capture(self, body: Callable[[], object]) -> None:
        here = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(here)
        with torch.cuda.stream(self.stream):
            body()
            graph = torch.cuda.CUDAGraph()
            before = [c.n for c in KERNEL_LAUNCHES]
            graph.capture_begin(pool=self.pool)
            try:
                body()
            finally:
                graph.capture_end()
        here.wait_stream(self.stream)
        # captured, not launched: the replays count them
        self.launches = [c.n - b for c, b in zip(KERNEL_LAUNCHES, before)]
        for c, b in zip(KERNEL_LAUNCHES, before):
            c.n = b
        self.graph = graph
        RECORDER.count("graph_captures")


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
    diag = diag_counts(st.st, st.inp, st.q_size)            # (B, 5)
    snap = lambda new, old: torch.where(fire, new, old)
    aux = ExecAux(
        abort=torch.where(fire, torch.where(fire_sat, ABORT_SATURATION,
                                            ABORT_LIVELOCK), aux.abort
                          ).to(I32),
        abort_cycle=snap(st.cycle, aux.abort_cycle),
        abort_stats=torch.where(fire[:, None], st.stats, aux.abort_stats),
        abort_stats_hi=torch.where(fire[:, None], st.stats_hi,
                                   aux.abort_stats_hi),
        **{k: snap(diag[:, j], getattr(aux, k))
           for j, k in enumerate(DIAG_FIELDS)})
    return _Mon(prog, frz, refs_anchor, aux)


@torch.inference_mode()
def _drive(s: SimState, cfg: SimConfig, max_cycles: int,
           chunk: int) -> Tuple[SimState, ExecAux]:
    """Drive a state to completion; returns ``(state, ExecAux)``.

    ``s`` is solo or batched, and is stepped in place: the returned state
    holds ``s``'s own tensors.  Each scenario steps as its own solo state,
    its view of ``s`` (the batch is a Python loop over scenarios), and
    the monitors and the termination predicate run on a (B, ...) view of
    the scenarios.  On a CUDA device each scenario's cycle is a
    :class:`CycleGraph`, captured on its first cycle and replayed after;
    elsewhere each cycle runs eagerly and is written back into the
    scenario's tensors.

    With :data:`repro_torch.tracing.RECORDER` on, each cycle is a
    ``step`` span holding the scenarios' ``cycle`` spans and a
    ``monitor`` span; each termination check is a ``check`` span; and
    ``host_syncs`` counts the reads of a device value to the host (the
    start clock, each check), ``graph_captures`` and ``graph_replays``
    the CUDA graphs captured and replayed."""
    solo = s.cycle.dim() == 0
    dev = s.cycle.device
    states = [s] if solo else [_index(s, b) for b in range(s.cycle.shape[0])]
    geo = geometry_to(make_geometry(cfg.rows, cfg.cols), dev)
    ctx = make_node_ctx(cfg, dev)
    dtypes = leaf_dtypes(cfg, s.trace.shape[-1])
    graphs = None
    if dev.type == "cuda":
        stream, pool = torch.cuda.Stream(dev), torch.cuda.graph_pool_handle()
        graphs = [CycleGraph(stream, pool) for _ in states]

    # the per-scenario view the monitors read: a batch of one is a view,
    # not a copy
    batch = ((lambda xs: xs[0].unsqueeze(0)) if len(states) == 1
             else torch.stack)
    done = torch.full((len(states),), -1, dtype=I32, device=dev)
    mon = _mon_init(batch([x.stats for x in states]),
                    batch([x.tr_ptr for x in states]))
    RECORDER.count("host_syncs")
    clock = int(states[0].cycle)           # one clock for every scenario
    steps = 0

    def stepped(b: int, x: SimState) -> None:
        RECORDER.at(b, clock)
        if graphs is None:
            narrow_state(cycle_step(x, cfg, geo, ctx), dtypes, into=x)
        else:
            cycle_step(x, cfg, geo, ctx, graphs[b])

    def step():
        nonlocal done, mon, clock, steps
        RECORDER.at(None, clock)
        with RECORDER.span("step"):
            for b, x in enumerate(states):
                stepped(b, x)
            RECORDER.at(None, clock)
            clock += 1
            steps += 1
            with RECORDER.span("monitor"):
                view = SimState(*(batch(xs) if k in _MON_LEAVES else None
                                  for k, xs in zip(SimState._fields,
                                                   zip(*states))))
                fin = batch([finished(x) for x in states])
                done = torch.where((done < 0) & fin, view.cycle, done)
                active = (done < 0) & (mon.aux.abort == 0)
                mon = _mon_update(mon, view, active, cfg, clock, steps)

    def alive() -> bool:
        RECORDER.count("host_syncs")
        RECORDER.at(None, clock)
        with RECORDER.span("check"):
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
        return s._replace(cycle=cyc[0]), ExecAux(*(x[0] for x in aux))
    return s._replace(cycle=cyc), aux


#: leaves the monitors read from the stacked per-scenario view
_MON_LEAVES = ("st", "inp", "q_size", "tr_ptr", "stats", "stats_hi", "cycle",
               "knob_central")


def stats_list(s: SimState, aux: ExecAux) -> List[Dict[str, int]]:
    """Per-scenario statistics dicts from a driven state + its ExecAux.

    Healthy scenarios get exactly the classic key set (STAT_NAMES +
    ``cycles`` + ``finished``).  Aborted scenarios report the snapshot
    taken at the abort cycle plus ``aborted`` (label) and the diagnostic
    counters."""
    return stats_dicts(s.stats_hi, s.stats, s.cycle, finished(s), aux)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def stats_dicts(stats_hi, stats, cycle, fin, aux: ExecAux
                ) -> List[Dict[str, int]]:
    """:func:`stats_list` from its parts: the stats pair, the clock and
    the termination flag of each scenario (tensors or numpy arrays, solo
    or ``(B, ...)``), and the ExecAux.  The sharded backend calls it with
    the flag reduced over its tiles."""
    stats = np.atleast_2d(stats_totals(stats_hi, stats))
    cyc = np.atleast_1d(_host(cycle))
    fin = np.atleast_1d(_host(fin))
    a = {k: np.atleast_1d(_host(v)) for k, v in aux._asdict().items()}
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
