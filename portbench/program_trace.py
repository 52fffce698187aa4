"""A traced run of one cell with the port's own spans and counters on.

    python3 portbench/program_trace.py --workload paper-208.random \
        --seed 7 --seconds 10

runs the cell as ``run.py --trace 1`` does (the same set-up, window,
traced sub-window of scenario-cycles 64-95, and check against the
reference) with the port's recorder, ``repro_torch.tracing.RECORDER``,
switched on over the same sub-window as the profiler.  It prints
``run.py``'s last line with, added:

* under ``metrics``, per scenario-cycle of the sub-window:
  ``cast_host_ms`` and ``monitor_host_ms`` (self time of the program's
  ``cast`` and ``monitor`` spans), ``host_syncs_per_cycle`` (the
  program's ``host_syncs`` counter) and, from the device trace,
  ``phase1a_launches``, ``phase1b_launches``, ``phase3_launches`` and
  ``cast_launches``: the device operations whose launch call (the CUDA
  runtime or driver record with the operation's correlation id) the host
  made inside a span of that name, innermost;
* under ``run``, ``idle_by_program_span_s``: the device's idle seconds
  between operations, summed by the innermost program span the host was
  in when each gap ended;
* ``program``: each span's self milliseconds and launches per
  scenario-cycle, the counters, and the join's checks: operations with
  no launch record, how many launches of the fused Phase-2 kernel fall
  inside a ``phase2`` span, and by how many microseconds at least.

The program's spans are stamped with ``time.time_ns()``, the clock of
the profiler's records, so they are joined without an offset.  Needs a
CUDA device, or ``--rehearse-cpu`` (no device trace: the launch metrics
and the idle seconds are left out).  Fails, exit 1, on a program that
has no recorder.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

#: the fused Phase-2 kernel, launched once a scenario-cycle in ``phase2``
K1 = "phase2_router_kernel"
#: the label of a launch or gap outside every span, and of a device
#: operation with no launch record
OUTSIDE, UNLINKED = "outside", "unlinked"


@dataclasses.dataclass
class ProgramTrace:
    """The program's spans and counters over the traced sub-window, and
    the device's operations with the host instant of each one's launch
    call (``None`` where the profiler kept no launch record).  Times are
    ``time.time_ns()`` nanoseconds."""

    scenario_cycles: int
    spans: list                      # repro_torch.tracing.Span
    counters: Dict[str, int]
    ops: List[Tuple[str, int, int, Optional[int]]]  # name, start, end, launch


def device_ops(prof) -> List[Tuple[str, int, int, Optional[int]]]:
    """The profiler's device operations, each with the host start of the
    launch record (runtime or driver API) that shares its correlation
    id."""
    from torch.autograd import DeviceType
    kr = prof.profiler.kineto_results
    launch: Dict[int, int] = {}
    dev = []
    for e in kr.events():
        if e.device_type() == DeviceType.CUDA:
            dev.append(e)
        elif e.correlation_id() > 0:
            c = e.correlation_id()
            launch[c] = min(launch.get(c, e.start_ns()), e.start_ns())
    return [(e.name(), e.start_ns(), e.end_ns(),
             launch.get(e.correlation_id())) for e in dev]


def launches_by_span(pt: ProgramTrace) -> Dict[str, int]:
    """Device operations counted by the innermost span their launch call
    fell in (``outside`` every span; ``unlinked`` with no launch record)."""
    from repro_torch.tracing import innermost
    at = innermost(pt.spans, [launch for _, _, _, launch in pt.ops])
    out: Dict[str, int] = {}
    for (_, _, _, launch), sp in zip(pt.ops, at):
        k = UNLINKED if launch is None else (sp.name if sp else OUTSIDE)
        out[k] = out.get(k, 0) + 1
    return out


def idle_by_span(pt: ProgramTrace) -> Dict[str, float]:
    """Seconds of each gap between the device's operations, summed by the
    innermost span the host was in when the gap ended."""
    from portbench import yardstick
    from repro_torch.tracing import innermost
    gaps = yardstick.idle_gaps([(a, b) for _, a, b, _ in pt.ops])
    out: Dict[str, float] = {}
    ends = innermost(pt.spans, [g1 for _, g1 in gaps])
    for (g0, g1), sp in zip(gaps, ends):
        k = sp.name if sp else OUTSIDE
        out[k] = out.get(k, 0.0) + (g1 - g0) * 1e-9
    return out


def k1_in_phase2(pt: ProgramTrace) -> Tuple[int, int]:
    """``(launches of the fused Phase-2 kernel, those launched inside a
    phase2 span)``: the join's check of the two clocks."""
    from repro_torch.tracing import innermost
    k1 = [launch for name, _, _, launch in pt.ops if K1 in name]
    at = innermost(pt.spans, k1)
    return len(k1), sum(1 for sp in at if sp is not None
                        and sp.name == "phase2")


def k1_margins_us(pt: ProgramTrace) -> Optional[Tuple[float, float]]:
    """The least microseconds from a launch of the fused Phase-2 kernel to
    the start, and to the end, of its ``phase2`` span (the n-th launch in
    the n-th span): the host's and the profiler's clocks may differ by
    less than either and leave every launch in its span.  ``None`` unless
    the counts match."""
    k1 = sorted(launch for name, _, _, launch in pt.ops
                if K1 in name and launch is not None)
    p2 = sorted((s.start_ns, s.end_ns) for s in pt.spans
                if s.name == "phase2")
    if not k1 or len(k1) != len(p2):
        return None
    return (min(t - a for t, (a, _) in zip(k1, p2)) * 1e-3,
            min(b - t for t, (_, b) in zip(k1, p2)) * 1e-3)


def _self_ms(name: str):
    def read(pt: ProgramTrace) -> Optional[float]:
        from repro_torch.tracing import self_ns
        got = self_ns(pt.spans)
        if name not in got:
            return None
        return got[name] / pt.scenario_cycles * 1e-6
    return read


def _launches(name: str):
    def read(pt: ProgramTrace) -> Optional[float]:
        if not pt.ops:
            return None
        return launches_by_span(pt).get(name, 0) / pt.scenario_cycles
    return read


def _host_syncs(pt: ProgramTrace) -> Optional[float]:
    if not pt.spans:
        return None
    return pt.counters.get("host_syncs", 0) / pt.scenario_cycles


#: each per-scenario-cycle metric of the program's spans and counters
READERS = {
    "cast_host_ms": _self_ms("cast"),
    "monitor_host_ms": _self_ms("monitor"),
    "host_syncs_per_cycle": _host_syncs,
    "phase1a_launches": _launches("phase1a"),
    "phase1b_launches": _launches("phase1b"),
    "phase3_launches": _launches("phase3"),
    "cast_launches": _launches("cast"),
}
UNITS = {"cast_host_ms": "ms", "monitor_host_ms": "ms",
         "host_syncs_per_cycle": "syncs/cycle"}


def traced_measure(cell, seed: int, seconds: float, device, t_start: float,
                   device_name: str) -> Tuple[dict, ProgramTrace]:
    """``bench.measure`` of a traced run, with the program's recorder on
    over the profiled sub-window; the result line's object and the
    sub-window's :class:`ProgramTrace`."""
    from portbench import bench
    from repro_torch.tracing import RECORDER

    made = []

    class Tracer(bench.Tracer):
        def __init__(self, *a):
            super().__init__(*a)
            made.append(self)

        def _open(self) -> None:
            super()._open()
            RECORDER.start()

        def _close(self) -> None:
            RECORDER.stop()
            super()._close()

    saved, bench.Tracer = bench.Tracer, Tracer
    try:
        out = bench.measure(cell, seed, seconds, True, device, t_start,
                            device_name)
    finally:
        bench.Tracer = saved
    spans, counters = RECORDER.drain()
    tracer = made[0]
    ops = device_ops(tracer.prof) if tracer.prof else []
    return out, ProgramTrace(tracer.count, spans, counters, ops)


def program_part(out: dict, pt: ProgramTrace) -> dict:
    """``out`` with the program's metrics, idle seconds and ``program``
    block added."""
    from repro_torch.tracing import self_ns
    n = pt.scenario_cycles
    for name, read in READERS.items():
        v = read(pt)
        if v is not None:
            out["metrics"][name] = {"value": v,
                                    "unit": UNITS.get(name, "launches/cycle")}
    prog = {"self_ms": {k: v / n * 1e-6
                        for k, v in sorted(self_ns(pt.spans).items())},
            "spans": len(pt.spans), "counters": pt.counters}
    if pt.ops:
        out["run"]["idle_by_program_span_s"] = idle_by_span(pt)
        total, inside = k1_in_phase2(pt)
        prog.update(
            launches={k: v / n for k, v in
                      sorted(launches_by_span(pt).items())},
            device_ops=len(pt.ops), k1_launches=total,
            k1_in_phase2=inside, k1_margins_us=k1_margins_us(pt))
    out["program"] = prog
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on the CPU at an 8x8 mesh; no device trace")
    args = ap.parse_args(argv)

    import torch
    from portbench import bench
    try:
        import repro_torch.tracing  # noqa: F401
    except ImportError:
        print("program_trace: the program has no recorder "
              "(repro_torch.tracing)", file=sys.stderr)
        return 1

    cell = bench.load_cell(args.workload, rehearse=args.rehearse_cpu)
    if args.rehearse_cpu:
        torch.set_num_threads(1)
        device, name = torch.device("cpu"), "cpu"
    elif not torch.cuda.is_available():
        print("program_trace: no CUDA device", file=sys.stderr)
        return 1
    else:
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        name = torch.cuda.get_device_name(device)
    try:
        out, pt = traced_measure(cell, args.seed, args.seconds, device,
                                 T_START, name)
    except bench.ForbiddenModules as e:
        print(f"program_trace: the process holds {e.args[0]} (JAX or the "
              "JAX package)", file=sys.stderr)
        return 3
    out = program_part(out, pt)
    out["checks"] = out.pop("checks")          # last, as run.py's
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
