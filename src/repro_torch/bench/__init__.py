"""Benchmark-telemetry subsystem of the PyTorch port: the metrics
contract, collectors and regression gate behind the repo's committed
perf trajectory.

It mirrors the JAX package's ``repro.bench`` module for module, name for
name: the same metric names, the same JSON layout (a report either
package writes reads in the other, byte for byte), the same gate
verdicts and text.  Only :mod:`repro_torch.bench.collect` differs in
what it imports: the stats helpers of :mod:`repro_torch.core.sim`.

The pieces (see ``docs/benchmarks.md``):

* :mod:`repro_torch.bench.schema` — ``Metric``/``BenchReport``: the JSON
  round-trippable contract every benchmark emits.
* :mod:`repro_torch.bench.collect` — shared collectors (network-health
  counters from the ``STAT_NAMES`` surface, timing/ratio/count/flag
  conventions).
* :mod:`repro_torch.bench.contract` — the one benchmark entry contract
  (``Benchmark`` + ``bench_main`` with common ``--smoke/--out/--json``).
* :mod:`repro_torch.bench.gate` — direction-aware baseline diffing + trend
  rendering (driven by ``scripts/bench_gate.py``).

Import cost is deliberately tiny (the standard library only; ``collect``
alone pulls in the simulator, and so torch) so a gate script can parse
and diff reports without paying a torch import.
"""
from .schema import BenchReport, Metric, SCHEMA_VERSION
from .contract import Benchmark, bench_main
from .gate import (Finding, compare_reports, gate_passes, render_findings,
                   render_trend)

__all__ = [
    "Metric", "BenchReport", "SCHEMA_VERSION",
    "Benchmark", "bench_main",
    "Finding", "compare_reports", "gate_passes", "render_findings",
    "render_trend",
]
