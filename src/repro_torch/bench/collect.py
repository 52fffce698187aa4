"""Metric collectors: turn simulator outputs into gated ``Metric`` lists.

A copy of the JAX package's ``repro.bench.collect`` over the port's
simulator: the same metric names, slacks and rounding, with the stats
helpers taken from :mod:`repro_torch.core.sim`.

Shared by the benchmark modules so the same network-health counters
(deflection rate, ejection-latency proxy, recovered drops — the
Ausavarungnirun-style deflection-routing health surface) and the same
timing conventions land in every ``BENCH_<area>.json`` under the same
names.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from repro_torch.core.sim import aggregate_stats, network_health

from .schema import Metric

__all__ = ["health_metrics", "timing_metric", "ratio_metric",
           "count_metric", "flag_metric"]

#: default slack for deterministic event counters: the simulator is
#: bit-exact for a fixed (config, trace, seed), so any drift is a real
#: behavior change — a whisker of slack only guards float rounding in
#: derived ratios.
COUNT_SLACK = 0.0
RATIO_SLACK = 0.02
#: speedup ratios divide two same-host wall clocks, which makes them far
#: more portable across machines than either wall clock alone — gate
#: them, but with room for CI-runner noise.
SPEEDUP_SLACK = 0.5


def health_metrics(stats: Sequence[Dict[str, int]], prefix: str,
                   tags: Optional[Dict[str, str]] = None) -> List[Metric]:
    """Network-health metrics from per-scenario ``stats`` dicts.

    Args:
        stats: per-scenario statistics (``run``/``stats_list`` output);
            aggregated with :func:`repro_torch.core.sim.aggregate_stats`.
        prefix: metric-name prefix, e.g. ``"plan"`` →
            ``plan.deflection_rate``.
        tags: context tags stamped on every emitted metric.

    Counters gate at zero slack (deterministic); derived ratios carry
    :data:`RATIO_SLACK` for rounding.
    """
    agg = aggregate_stats(list(stats))
    h = network_health(agg)
    t = dict(tags or {})
    return [
        Metric(f"{prefix}.deflection_rate", round(h["deflection_rate"], 6),
               unit="ratio", direction="lower", slack=RATIO_SLACK, tags=t),
        Metric(f"{prefix}.hops_per_flit", round(h["hops_per_flit"], 4),
               unit="hops/flit", direction="lower", slack=RATIO_SLACK,
               tags=t),
        Metric(f"{prefix}.deflections_per_flit",
               round(h["deflections_per_flit"], 4), unit="defl/flit",
               direction="lower", slack=RATIO_SLACK, tags=t),
        Metric(f"{prefix}.drops_recovered", h["drops_recovered"],
               unit="count", direction="lower", slack=COUNT_SLACK, tags=t),
        Metric(f"{prefix}.stray_responses", h["stray_responses"],
               unit="count", direction="lower", slack=COUNT_SLACK, tags=t),
    ]


def timing_metric(name: str, seconds: float, **kw) -> Metric:
    """A raw wall-clock measurement: informational (``gate=False``) —
    absolute times do not transfer between hosts; keyword args ``kw``
    pass through to :class:`Metric`."""
    kw.setdefault("unit", "s")
    kw.setdefault("direction", "lower")
    kw.setdefault("gate", False)
    return Metric(name, round(float(seconds), 4), **kw)


def ratio_metric(name: str, value: float, **kw) -> Metric:
    """A speedup/throughput *ratio*: gated with :data:`SPEEDUP_SLACK`
    (portable across hosts because both sides share the host's speed);
    ``kw`` passes through to :class:`Metric`."""
    kw.setdefault("unit", "x")
    kw.setdefault("direction", "higher")
    kw.setdefault("slack", SPEEDUP_SLACK)
    return Metric(name, round(float(value), 4), **kw)


def count_metric(name: str, value: int, **kw) -> Metric:
    """A deterministic event count (cycles, compiles, scenarios): gated
    at zero slack by default; ``kw`` passes through to :class:`Metric`."""
    kw.setdefault("unit", "count")
    kw.setdefault("direction", "lower")
    kw.setdefault("slack", COUNT_SLACK)
    return Metric(name, int(value), **kw)


def flag_metric(name: str, ok: bool, **kw) -> Metric:
    """A boolean invariant (``bit_identical``, ``all_finished``): gated,
    1 is good; ``kw`` passes through to :class:`Metric`."""
    kw.setdefault("unit", "bool")
    kw.setdefault("direction", "higher")
    kw.setdefault("slack", 0.0)
    return Metric(name, int(bool(ok)), **kw)
