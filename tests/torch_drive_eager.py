"""Shared harness of the driver's in-place tests
(``tests/test_torch_drive_in_place.py`` on the CPU, the ``gpu`` tests of
``tests/test_torch_gpu.py`` on the card): a state driven by
``sim._drive``, with the recorder on and every call of ``cycle_step``
watched, and what the pure step gives for each of its scenarios.
Imports neither JAX nor ``repro``."""
from typing import Dict, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch import tracing
from repro_torch.core import sim
from repro_torch.core.config import ST_WAIT_DATA, ST_WAIT_DIR, SimConfig
from repro_torch.core.state import STAT_NAMES, SimState, init_state
from repro_torch.core.sweep import ScenarioSpec, SweepSpec
from repro_torch.kernels import cache_phase, router_phase

PROGRESS = [k for k in STAT_NAMES if k not in ("hops", "deflections")]
DIAG_KEYS = ("circulating_flits", "wait_dir_nodes", "wait_data_nodes",
             "stalled_queues", "flits_to_node0")


def eager(cfg: SimConfig, trace, cycles: int, device
          ) -> Tuple[Dict, Tuple, SimState]:
    """What ``_drive`` must give for one scenario, from the pure step:
    ``VectorSim.step`` run ``cycles`` times.  Returns the statistics dict
    and ``(abort code, abort cycle, diagnostics)`` as the driver reports
    them, where a progress monitor's rule fires first (the statistics and
    diagnostics of that cycle), and the state after ``cycles``.
    Directory saturation (centralized directory, >= 256 nodes): at every
    ``sat_window``-th cycle, half the nodes wait on the directory or data
    while fewer than half a reference a node retired since the last such
    cycle.  Livelock, where saturation does not fire: no progress
    statistic changed for the window's cycles, once that many have been
    stepped.  Runs here are cut before the scenario finishes."""
    vs = sim.VectorSim(cfg, trace, device=device)
    n, lw = cfg.num_nodes, cfg.livelock_window_effective
    sw = cfg.sat_window if n >= 256 else 0
    prev = {k: 0 for k in PROGRESS}
    frozen = anchor = 0
    got, record = None, (0, 0, [0] * 5)
    for c in range(1, cycles + 1):
        vs.step()
        s = vs.state
        if got is not None:
            continue
        now = vs.stats()
        prog = {k: now[k] for k in PROGRESS}
        frozen = frozen + 1 if prog == prev else 0
        prev = prog
        sat = False
        if sw and c % sw == 0:
            refs = int(s.tr_ptr.sum())
            waiting = int(((s.st == ST_WAIT_DIR) | (s.st == ST_WAIT_DATA)
                           ).sum())
            sat = (cfg.centralized_directory and waiting * 2 >= n
                   and (refs - anchor) * 2 < n)
            anchor = refs
        if sat or (lw > 0 and c >= lw and frozen >= lw):
            code = sim.ABORT_SATURATION if sat else sim.ABORT_LIVELOCK
            diag = sim.diag_counts(s.st, s.inp, s.q_size).tolist()
            got = dict(now, finished=0, aborted=sim.ABORT_LABELS[code],
                       **dict(zip(DIAG_KEYS, diag)))
            record = (code, c, diag)
    return (got or vs.stats()), record, vs.state


class Driven(NamedTuple):
    state: SimState        # the state handed to ``_drive``
    before: List[int]      # its leaves' data pointers before the drive
    out: SimState
    aux: sim.ExecAux
    ptrs: List[List[int]]  # each ``cycle_step`` call's input pointers
    shared: List[Tuple[str, str]]  # (output leaf, other input leaf) pairs
    counters: Dict[str, int]
    steps: int             # cycles the drive stepped
    launches: int          # K1 launches the drive counted
    cache_launches: int    # cache-phase kernel launches it counted
    want: List[Tuple[Dict, Tuple, SimState]]  # :func:`eager`, a scenario

    def records(self) -> List[Tuple[int, int, List[int]]]:
        """``(abort code, abort cycle, diagnostics)`` of each scenario."""
        a = self.aux
        diag = torch.stack([a.circ, a.wait_dir, a.wait_data, a.stalled,
                            a.dst0], dim=-1).reshape(-1, 5).tolist()
        return list(zip(a.abort.reshape(-1).tolist(),
                        a.abort_cycle.reshape(-1).tolist(), diag))

    def unequal_leaves(self) -> List[Tuple[int, str]]:
        """``(scenario, leaf)`` where the driven state, stepped in place,
        differs from the pure steps' state in value or dtype."""
        views = ([self.state] if self.state.cycle.dim() == 0 else
                 [SimState(*(x[b] for x in self.state))
                  for b in range(self.state.cycle.shape[0])])
        return [(b, k) for b, (x, (_, _, w)) in enumerate(zip(views,
                                                              self.want))
                for k, u, v in zip(SimState._fields, x, w)
                if u.dtype != v.dtype or not torch.equal(u, v)]


def in_place(x: SimState, cfg: SimConfig, geo, ctx) -> SimState:
    """A ``cycle_step`` that steps ``x`` in place, as a CUDA graph's
    capture does (``sim._cycle`` with ``in_place``), and returns it: in
    place of the pure step, it has ``_drive`` on the CPU step every
    scenario in place (with the cache-phase kernel's host build standing
    in for its wrapper, ``tests/torch_cache_host.py``), and the driver's
    write-back then finds nothing to copy."""
    return sim._cycle(x, cfg, geo, ctx, in_place=True)


def drive(cfg: SimConfig, scenarios: Sequence[Tuple], cycles: int,
          chunk: int, device, cycle=None) -> Driven:
    """Drive the scenarios ``(app, seed, refs, knobs)`` (one: a solo
    state; more: a batch with each scenario's knobs) for ``cycles``
    with ``_drive`` on ``device``, the recorder on and ``cycle_step``
    (or ``cycle`` in its place, such as :func:`in_place`) watched; then
    step each alone with :func:`eager` for as many cycles as the drive
    stepped."""
    spec = SweepSpec(cfg, tuple(ScenarioSpec(a, seed, refs, **k)
                                for a, seed, refs, k in scenarios))
    traces = spec.traces()
    if len(scenarios) == 1:
        s = init_state(cfg, traces[0], device)
    else:
        s = init_state(cfg, traces, device)
        s = s._replace(**{k: torch.as_tensor(a, device=device)
                          for k, a in zip(("knob_mig", "knob_mig_thr",
                                           "knob_central", "knob_ej_age"),
                                          spec.knob_arrays())})
    before = [x.data_ptr() for x in s]
    ptrs, shared = [], []
    real = cycle or sim.cycle_step

    def step(x, cfg, geo, ctx, *graph):
        ptrs.append([y.data_ptr() for y in x])
        out = real(x, cfg, geo, ctx, *graph)
        where = {y.untyped_storage().data_ptr(): k
                 for k, y in zip(SimState._fields, x)}
        shared.extend(
            (k, where[y.untyped_storage().data_ptr()])
            for k, y in zip(SimState._fields, out)
            if where.get(y.untyped_storage().data_ptr(), k) != k)
        return out
    tracing.RECORDER.drain()
    tracing.RECORDER.start()
    launches = router_phase.LAUNCHES.n
    cache_launches = cache_phase.LAUNCHES.n
    saved, sim.cycle_step = sim.cycle_step, step
    try:
        out, aux = sim._drive(s, cfg, cycles, chunk)
    finally:
        sim.cycle_step = saved
        tracing.RECORDER.stop()
    launches = router_phase.LAUNCHES.n - launches
    cache_launches = cache_phase.LAUNCHES.n - cache_launches
    spans, counters = tracing.RECORDER.drain()
    steps = sum(sp.name == "step" for sp in spans)
    want = [eager(sc.resolve_cfg(cfg), traces[b], steps, device)
            for b, sc in enumerate(spec.scenarios)]
    return Driven(s, before, out, aux, ptrs, shared, counters, steps,
                  launches, cache_launches, want)
