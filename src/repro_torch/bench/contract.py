"""The one benchmark entry contract.

A copy of the JAX package's ``repro.bench.contract``: the same flags,
two-pass ``--smoke`` parse and printed table.

Every benchmark module under ``benchmarks/`` declares a module-level
``BENCH = Benchmark(...)`` and a two-line ``main``::

    BENCH = Benchmark(area="sweep", title="...", add_args=add_args,
                      run=run_bench, smoke={"rows": 8, "cols": 8})

    def main(argv=None):
        return bench_main(BENCH, argv)

``bench_main`` gives every benchmark the same surface — the harness
(``benchmarks/run.py``), the regression gate (``scripts/bench_gate.py``)
and CI all invoke benchmarks uniformly through it:

* ``--smoke`` — switch the parser defaults to the benchmark's declared
  smoke tier (explicit flags still win: smoke only changes *defaults*);
* ``--out PATH`` — write the :class:`~repro_torch.bench.schema.BenchReport`
  JSON (the ``BENCH_<area>.json`` shape the gate consumes);
* ``--json PATH`` — legacy flag: write the benchmark's raw payload dict
  (kept so pre-contract invocations keep working).

The benchmark's ``run`` callable does the work and returns the report;
``bench_main`` owns parsing, rendering and writing.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Callable, Dict, List, Optional

from .schema import BenchReport

__all__ = ["Benchmark", "bench_main", "add_common_args"]


@dataclasses.dataclass(frozen=True)
class Benchmark:
    """One benchmark's registration under the shared entry contract.

    Attributes:
        area: short slug; the baseline file is ``BENCH_<area>.json``.
        title: one-line description for ``benchmarks/run.py --list``.
        add_args: callback adding the benchmark's own flags to an
            ``argparse.ArgumentParser``.
        run: ``run(args) -> BenchReport`` — the measurement itself.
        smoke: parser-default overrides applied when ``--smoke`` is
            given (CI tier: small meshes, few seeds, minutes not hours).
        gated: whether ``bench_gate.py --smoke`` checks this area
            against a committed repo-root baseline.
    """

    area: str
    title: str
    add_args: Callable[[argparse.ArgumentParser], None]
    run: Callable[[argparse.Namespace], BenchReport]
    smoke: Dict = dataclasses.field(default_factory=dict)
    gated: bool = True


def add_common_args(ap: argparse.ArgumentParser) -> None:
    """Install the contract's shared flags on parser ``ap``
    (``--smoke`` / ``--out`` / legacy ``--json``)."""
    ap.add_argument("--smoke", action="store_true",
                    help="smoke tier: switch defaults to a small, "
                         "CI-sized configuration (explicit flags still "
                         "override)")
    ap.add_argument("--out", default=None, metavar="PATH",
                    help="write the BenchReport JSON here "
                         "(the BENCH_<area>.json schema bench_gate.py "
                         "diffs against baselines)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="legacy: write the raw payload dict here")


def build_parser(bench: Benchmark) -> argparse.ArgumentParser:
    """The benchmark's full parser: its own flags + the common ones."""
    ap = argparse.ArgumentParser(description=bench.title)
    bench.add_args(ap)
    add_common_args(ap)
    return ap


def parse_bench_args(bench: Benchmark,
                     argv: Optional[List[str]] = None) -> argparse.Namespace:
    """Two-pass parse: detect ``--smoke`` first, swap in the smoke-tier
    defaults for benchmark ``bench``, then parse ``argv`` for real — so
    an explicit flag always beats the smoke default."""
    ap = build_parser(bench)
    pre, _ = ap.parse_known_args(argv)
    if pre.smoke and bench.smoke:
        ap.set_defaults(**bench.smoke)
    return ap.parse_args(argv)


def bench_main(bench: Benchmark,
               argv: Optional[List[str]] = None) -> BenchReport:
    """Uniform benchmark entry point: parse ``argv`` (two-pass smoke
    handling), run benchmark ``bench``, print the metric table, honor
    ``--out``/``--json``, and return the report."""
    args = parse_bench_args(bench, argv)
    report = bench.run(args)
    report.meta.setdefault("smoke", bool(args.smoke))
    print(report.render())
    if args.out:
        report.write(args.out)
    if args.json:
        import json
        with open(args.json, "w") as f:
            json.dump(report.raw, f)
    return report
