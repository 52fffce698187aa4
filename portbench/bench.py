"""One run of one cell: set-up, the measured window, the check.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``: a
configuration (``configs/<config>.json``) under a traffic mix
(``traffic/<traffic>.json``).  A run

1. makes the mix's traces from the seed and builds the port's entry
   (``repro_torch.core.sim.run`` or ``repro_torch.core.sweep.run_sweep``)
   over them;
2. warms the entry up on the same traces;
3. calls the entry once for the window, a fixed amount of work: the
   mix's ``cycles_per_s`` times ``seconds`` cycles of every scenario (a
   multiple of the mix's ``chunk``), whatever the machine's speed; with
   the peak of device memory
   reset before it; with ``trace`` the port's ``cycle_step`` and its four
   phases are wrapped in the benchmark's own spans, and a steady
   sub-window of :data:`TRACE_CYCLES` scenario-cycles is profiled;
4. runs the plain reference (``reference/``) over the same traces for
   the same cycles and compares every statistic of every scenario.

The window's rate is the simulated node-cycles over the host seconds of
the whole call, ended by a synchronise.  Set-up (imports, traces, the
kernel's build or load, the warm-up) is ``setup_s``.
"""
from __future__ import annotations

import bisect
import dataclasses
import importlib.util
import json
import sys
import time
import warnings
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from . import traffic, yardstick
from .reference import config as ref_config
from .reference import sim as ref_sim

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

#: the phases ``repro_torch.core.sim.cycle_step`` calls, by the names it
#: calls them by
PHASES = ("phase1a", "phase1b", "phase2", "phase3")
#: the traced sub-window opens at this scenario-cycle of the window (a
#: chunk boundary past the first chunks) and spans TRACE_CYCLES
TRACE_START = 64
TRACE_CYCLES = 32
#: top-level module names that the process may not hold once the
#: window has closed: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: keys of a configuration file beside the simulator's fields
CONFIG_META = ("source", "why", "reduced", "assumed", "guarantees")
#: the mesh a rehearsal on the CPU runs, whatever the configuration says
REHEARSAL_MESH = 8
GIB = float(1 << 30)


@dataclasses.dataclass
class Cell:
    name: str
    cfg: ref_config.Config
    fields: Dict[str, Any]
    mix: Dict[str, Any]
    chips: int
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def load_config(name: str) -> Tuple[ref_config.Config, Dict[str, Any]]:
    """A configuration file's simulator fields, as the reference's config
    and as the raw dict."""
    with open(HERE / "configs" / f"{name}.json") as f:
        raw = json.load(f)
    fields = {k: v for k, v in raw.items() if k not in CONFIG_META}
    return ref_config.from_fields(fields), fields


def load_cell(name: str, root: Path = ROOT, rehearse: bool = False) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    return cell_of(cells[name], bench, rehearse)


def cell_of(w: Dict[str, Any], bench: Dict[str, Any],
            rehearse: bool = False) -> Cell:
    """The cell of a ``workloads`` entry ``w``, with the metrics of
    ``bench`` that it reports."""
    name = w["name"]
    cfg, fields = load_config(w["config"])
    if rehearse:
        fields = dict(fields, rows=REHEARSAL_MESH, cols=REHEARSAL_MESH)
        cfg = ref_config.from_fields(fields)

    def mine(m):
        return name in m.get("workloads", [name])
    return Cell(name, cfg, fields, traffic.load_mix(w["traffic"]), w["chips"],
                [m for m in bench["end_to_end"] if mine(m)],
                [m for m in bench["per_layer"] if mine(m)])


def port_entry(cell: Cell, traces: np.ndarray, device
               ) -> Callable[[int], List[Dict[str, int]]]:
    """The port's public entry over ``traces``, as a function of the cycle
    cap; it returns one statistics dict per scenario."""
    from repro_torch.core.config import CacheConfig, SimConfig
    fields = dict(cell.fields, cache=CacheConfig(**cell.fields["cache"]))
    cfg = SimConfig(**fields)
    chunk = cell.mix["chunk"]
    if cell.mix["entry"] == "run":
        from repro_torch.core.sim import run
        return lambda cycles: [run(cfg, traces[0], max_cycles=cycles,
                                   chunk=chunk, device=device)]
    from repro_torch.core.sweep import ScenarioSpec, SweepSpec, run_sweep

    @dataclasses.dataclass(frozen=True, eq=False)
    class GivenSweep(SweepSpec):
        """The sweep over the benchmark's own traces."""
        given: Optional[np.ndarray] = None

        def traces(self) -> np.ndarray:
            return self.given

    spec = GivenSweep(cfg, tuple(
        ScenarioSpec(sc["source"], 0, sc["refs_per_core"], **sc["knobs"])
        for sc in cell.mix["scenarios"]), given=traces)
    return lambda cycles: run_sweep(spec, max_cycles=cycles, chunk=chunk,
                                    device=device)


class Clock:
    """Host seconds of work that ends in a synchronise with the device."""

    def __init__(self, device):
        import torch
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))

    def time(self, fn: Callable[[], Any]) -> Tuple[Any, float]:
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        return out, time.perf_counter() - t0


def window_cycles(mix: Dict[str, Any], seconds: float, least: int = 1
                  ) -> int:
    """The window's cycle cap: the mix's ``cycles_per_s`` for each of
    ``seconds``, a whole number of chunks, at least ``least``.  The
    window's work is fixed by the cell and ``seconds`` alone, so a faster
    program steps the same cycles in less time."""
    chunk = mix["chunk"]
    n = int(round(seconds * mix["cycles_per_s"] / chunk)) * chunk
    return max(n, -(-least // chunk) * chunk)


class Tracer:
    """The benchmark's spans around the port's ``cycle_step`` and its four
    phases, and a profiled sub-window.

    The port's driver calls ``cycle_step`` once for each scenario and
    cycle (a sweep's scenarios one after another), and ``cycle_step``
    calls the phases by their names in ``repro_torch.core.sim``; so
    wrapping those names reaches every call, and no file of the program
    changes.  The sub-window opens before scenario-cycle ``start`` and
    closes before ``start + count``, so it holds whole cycles of the
    driver with its monitors and termination checks.  Spans are kept in
    memory; the profiler records the device's activity alone."""

    def __init__(self, start: int, count: int, device):
        import repro_torch.core.sim as sim
        self.sim, self.start, self.count = sim, start, count
        self.clock = Clock(device)
        self.cuda = device.type == "cuda"
        self.n = 0
        self.active = False
        self.spans: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = None
        self.prof = None
        self.saved: Dict[str, Callable] = {}

    def __enter__(self) -> "Tracer":
        for k in PHASES + ("cycle_step",):
            self.saved[k] = getattr(self.sim, k)
        for k in PHASES:
            setattr(self.sim, k, self._span(k, self.saved[k]))
        self.sim.cycle_step = self._cycle(self.saved["cycle_step"])
        return self

    def __exit__(self, *exc) -> None:
        if self.active:
            self._close()
        for k, fn in self.saved.items():
            setattr(self.sim, k, fn)

    def _span(self, name: str, fn: Callable) -> Callable:
        def wrapped(*a, **kw):
            if not self.active:
                return fn(*a, **kw)
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            self.spans.append((name, t0, time.perf_counter()))
            return out
        return wrapped

    def _cycle(self, fn: Callable) -> Callable:
        def wrapped(*a, **kw):
            if self.n == self.start:
                self._open()
            elif self.n == self.start + self.count and self.active:
                self._close()
            self.n += 1
            return fn(*a, **kw)
        return wrapped

    def _open(self) -> None:
        self.clock.sync()
        if self.cuda:
            self.prof = profiler()
            self.prof.start()
        self.active = True
        self.t0 = time.perf_counter()

    def _close(self) -> None:
        self.clock.sync()
        self.t1 = time.perf_counter()
        self.active = False
        if self.prof is not None:
            self.prof.stop()

    def device_events(self) -> List[Tuple[str, float, float]]:
        """``(name, start_us, end_us)`` of every operation that ran on the
        device in the sub-window: kernels, copies and fills."""
        if self.prof is None:
            return []
        from torch.autograd import DeviceType
        return [(e.name, e.time_range.start, e.time_range.end)
                for e in self.prof.events()
                if e.device_type == DeviceType.CUDA]


def profiler():
    """The profiler of the traced sub-window: the device's activity only,
    so the host pays for no record of its own operations."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


@dataclasses.dataclass
class Trace:
    """What a per-layer metric's reader reads: the traced sub-window."""

    cell: Cell
    scenario_cycles: int
    window_s: float
    spans: Dict[str, float]          # host seconds in each phase's spans
    device_events: List[Tuple[str, float, float]]  # name, start, end (us)
    busy_s: Optional[float]          # union of the device's operations
    on_device: bool
    device_name: str
    trace_len: int


def read_trace(cell: Cell, tracer: Tracer, on_device: bool,
               device_name: str, trace_len: int
               ) -> Tuple[Trace, Dict[str, list]]:
    """The traced sub-window as a :class:`Trace`, and its breakdown: the
    device operations that took most time, and the device's idle time
    summed by the phase span the host was in when the gap ended."""
    events = tracer.device_events()
    spans: Dict[str, float] = {k: 0.0 for k in PHASES}
    for name, a, b in tracer.spans:
        spans[name] += b - a
    intervals = [(a, b) for _, a, b in events]
    busy = yardstick.union_seconds(intervals) * 1e-6 if events else None
    t = Trace(cell, tracer.count, tracer.t1 - tracer.t0, spans, events, busy,
              on_device, device_name, trace_len)
    by_op: Dict[str, float] = {}
    for name, a, b in events:
        by_op[name] = by_op.get(name, 0.0) + (b - a) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
    gaps: Dict[str, float] = {}
    if events:
        # the device's clock against the host's: the first operation
        # starts just after the host issues it, as the window opens
        offset = min(a for a, _ in intervals) * 1e-6 - tracer.t0
        starts = [a for _, a, _ in tracer.spans]
        for g0, g1 in yardstick.idle_gaps(intervals):
            at = g1 * 1e-6 - offset
            i = bisect.bisect_right(starts, at) - 1
            label = (tracer.spans[i][0]
                     if i >= 0 and at <= tracer.spans[i][2] else "driver")
            gaps[label] = gaps.get(label, 0.0) + (g1 - g0) * 1e-6
    idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return t, {"device_ops": [[n[:120], s] for n, s in ops],
               "idle_gaps": [[n, s] for n, s in idle]}


def reader(metric: str) -> Callable[[Trace], Optional[float]]:
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that are JAX or the JAX package,
    each compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.partition(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def reference_stats(cell: Cell, traces: np.ndarray, cycles: int, device,
                    control: bool = False) -> List[Dict[str, int]]:
    """The plain reference's statistics of every scenario."""
    return [ref_sim.run(c, traces[b], cycles, device,
                        chunk=cell.mix["chunk"], control=control)
            for b, c in enumerate(traffic.scenario_configs(cell.cfg,
                                                           cell.mix))]


def trace_used(cell: Cell, stats: List[Dict[str, int]]) -> float:
    """The largest share of a scenario's trace that its cores have taken
    (each reference is an L1 hit or an L1 miss once): how far the window
    came towards the end of the traffic."""
    return max((g["l1_hits"] + g["l1_misses"])
               / (cell.cfg.num_nodes * sc["refs_per_core"])
               for g, sc in zip(stats, cell.mix["scenarios"]))


def prepare(cell: Cell, seed: int, device
            ) -> Tuple[np.ndarray, Callable[[int], List[Dict[str, int]]]]:
    """The seed's traces and the port's entry over them."""
    traces = traffic.make_traces(cell.cfg, cell.mix, seed)
    return traces, port_entry(cell, traces, device)


def warm_up(cell: Cell, entry, clock: Clock) -> None:
    """Two calls of the entry on the cell's own traces: the first loads
    (or builds) the kernel and fills the allocator's pools, the second
    steps whole chunks as the window does."""
    chunk = cell.mix["chunk"]
    entry(chunk)
    clock.time(lambda: entry(4 * chunk))


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, device_name: str) -> Dict[str, Any]:
    """One run of ``cell``; returns the result line's object."""
    import torch
    on_device = device.type == "cuda"
    clock = Clock(device)
    n_scen = len(cell.mix["scenarios"])
    parts = {"imports": time.perf_counter() - t_start}
    t = time.perf_counter()
    traces, entry = prepare(cell, seed, device)
    parts["traces"] = time.perf_counter() - t
    t = time.perf_counter()
    least = -(-(TRACE_START + TRACE_CYCLES + 1) // n_scen) if trace else 1
    cycles = window_cycles(cell.mix, seconds, least)
    warm_up(cell, entry, clock)
    parts["warm_up"] = time.perf_counter() - t
    if trace and on_device:
        warm = profiler()            # the profiler's own first start
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            warm.start()
            torch.zeros(1, device=device).add_(1)
            clock.sync()
            warm.stop()

    tracer = Tracer(TRACE_START, TRACE_CYCLES, device) if trace else None
    if on_device:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    if tracer is None:
        got, window_s = clock.time(lambda: entry(cycles))
    else:
        with tracer, warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, window_s = clock.time(lambda: entry(cycles))
    peak = int(torch.cuda.max_memory_allocated(device)) if on_device else None
    held = forbidden_modules()
    if held:
        raise ForbiddenModules(held)
    del entry

    want, reference_s = clock.time(
        lambda: reference_stats(cell, traces, cycles, device))
    mism, failed = yardstick.compare(got, want)
    finished = sum(int(g.get("finished", 0)) for g in got)
    checks = {"stat_mismatches": {"value": mism, "limit": 0},
              "scenarios_finished": {"value": finished, "limit": 0}}
    correct = mism == 0 and finished == 0 and len(got) == n_scen

    metrics: Dict[str, Dict[str, Any]] = {}
    breakdown = None
    dev = {"platform": "gpu" if on_device else "cpu", "kind": device_name,
           "count": 1, "memory_peak_bytes": peak}
    if not trace:
        node_cycles = cell.cfg.num_nodes * sum(int(g["cycles"]) for g in got)
        values = {"node_cycles_per_s": node_cycles / window_s,
                  "setup_s": setup_s,
                  "peak_device_gib": peak / GIB if on_device else None}
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        tr, breakdown = read_trace(cell, tracer, on_device, device_name,
                                   traces.shape[-1])
        for m in cell.per_layer:
            v = reader(m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if on_device:
            dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    out = {"correct": correct, "attempted": n_scen, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["run"] = {"seed": seed, "cycles": cycles, "scenarios": n_scen,
                  "trace_used": trace_used(cell, want),
                  "window_s": window_s, "reference_s": reference_s,
                  "setup_parts_s": parts}
    out["checks"] = checks
    return out


class ForbiddenModules(RuntimeError):
    """The process holds JAX or the JAX package."""
