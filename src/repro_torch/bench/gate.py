"""Direction-aware baseline comparison + trend table for BenchReports.

A copy of the JAX package's ``repro.bench.gate``: the same finding
kinds, severity order, verdicts and rendered text.

The library behind ``scripts/bench_gate.py``: pure functions over
:class:`repro_torch.bench.schema.BenchReport` pairs so every edge case
(missing baseline metric, newly added metric, regression beyond slack,
improvement) is unit-testable without running a benchmark.

Semantics (see ``docs/benchmarks.md``):

* only the *baseline's* gated metrics can fail the gate — the committed
  baseline is the contract, a fresh run is the candidate;
* a gated baseline metric missing from the fresh report is a failure
  (the measurement silently vanished);
* a metric present only in the fresh report is reported as ``new`` and
  never fails (it starts gating once a refreshed baseline commits it);
* drift in the *bad* direction beyond ``slack`` fails; drift in the good
  direction is reported as ``improvement`` (a refresh opportunity);
* when the baseline value is 0, relative drift is undefined and
  ``slack`` is applied as an absolute allowance.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .schema import BenchReport, Metric

__all__ = ["Finding", "compare_reports", "gate_passes", "render_findings",
           "render_trend"]

#: finding kinds, in display-severity order
_KINDS = ("regression", "vanished", "ok", "improvement", "new", "info")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One metric's verdict from :func:`compare_reports`.

    Attributes:
        name: the metric name.
        kind: ``"regression"`` | ``"vanished"`` | ``"ok"`` |
            ``"improvement"`` | ``"new"`` | ``"info"`` (ungated).
        base: baseline value (``None`` for ``new``).
        fresh: fresh value (``None`` for ``vanished``).
        rel: signed relative change ``(fresh-base)/|base|`` (``None``
            when undefined: zero baseline or a missing side).
        fails: whether this finding fails the gate.
        detail: one-line human explanation.
    """

    name: str
    kind: str
    base: Optional[float]
    fresh: Optional[float]
    rel: Optional[float]
    fails: bool
    detail: str

    def __post_init__(self):
        assert self.kind in _KINDS, self.kind


def _judge(base: Metric, fresh: Metric, slack_scale: float) -> Finding:
    """Direction-aware verdict for one (baseline, fresh) metric pair."""
    b, f = float(base.value), float(fresh.value)
    sign = 1.0 if base.direction == "lower" else -1.0   # +1: growth is bad
    rel = (f - b) / abs(b) if b else None
    slack = base.slack * slack_scale
    # bad_drift > slack fails: relative drift normally, absolute units
    # when the baseline is 0 (relative drift is undefined there)
    bad_drift = sign * (f - b) / abs(b) if b else sign * (f - b)
    if not base.gate:
        return Finding(base.name, "info", b, f, rel, False,
                       "informational (not gated)")
    if bad_drift > slack:
        return Finding(base.name, "regression", b, f, rel, True,
                       f"worse than baseline beyond slack "
                       f"({base.slack:g}{'' if b else ' abs'})")
    if (sign * (f - b)) < 0:
        return Finding(base.name, "improvement", b, f, rel, False,
                       "better than baseline — consider refreshing")
    return Finding(base.name, "ok", b, f, rel, False, "within slack")


def compare_reports(base: BenchReport, fresh: BenchReport,
                    slack_scale: float = 1.0) -> List[Finding]:
    """Diff ``fresh`` against the committed ``base`` report.

    Args:
        base: the committed baseline (its metrics define the contract).
        fresh: the candidate run to judge.
        slack_scale: multiplier applied to every baseline slack (CI can
            loosen a noisy host with ``--slack-scale 2`` without editing
            baselines).

    Returns one :class:`Finding` per union-of-names metric, baseline
    order first, fresh-only (``new``) metrics after.
    """
    if base.area != fresh.area:
        raise ValueError(f"area mismatch: baseline {base.area!r} vs "
                         f"fresh {fresh.area!r}")
    findings = []
    for bm in base.metrics:
        fm = fresh.metric(bm.name)
        if fm is None:
            findings.append(Finding(
                bm.name, "vanished", float(bm.value), None, None, bm.gate,
                "in baseline but missing from fresh run"
                + ("" if bm.gate else " (not gated)")))
            continue
        findings.append(_judge(bm, fm, slack_scale))
    for fm in fresh.metrics:
        if base.metric(fm.name) is None:
            findings.append(Finding(
                fm.name, "new", None, float(fm.value), None, False,
                "not in baseline yet — gates after a refresh"))
    return findings


def gate_passes(findings: Sequence[Finding]) -> bool:
    """``True`` when no finding fails (the CI exit-code predicate)."""
    return not any(f.fails for f in findings)


def _fmt(v: Optional[float]) -> str:
    return "—" if v is None else f"{v:g}"


def render_findings(area: str, findings: Sequence[Finding]) -> str:
    """Human table of one area's findings, worst first."""
    order = {k: i for i, k in enumerate(_KINDS)}
    rows = sorted(findings, key=lambda f: (not f.fails, order[f.kind]))
    w = max([len(f.name) for f in findings] or [4])
    out = [f"-- {area}: {sum(f.fails for f in findings)} failing / "
           f"{len(findings)} metrics --"]
    for f in rows:
        rels = "" if f.rel is None else f"{f.rel:+.1%}"
        flag = "FAIL" if f.fails else "    "
        out.append(f" {flag} {f.kind:<11s} {f.name:<{w}s} "
                   f"{_fmt(f.base):>12s} -> {_fmt(f.fresh):>12s} "
                   f"{rels:>8s}  {f.detail}")
    return "\n".join(out)


def render_trend(history: Sequence[Tuple[str, BenchReport]],
                 names: Optional[Sequence[str]] = None,
                 max_cols: int = 8) -> str:
    """Trend table: one row per metric, one column per historical report.

    Args:
        history: ``(label, report)`` pairs, oldest first (labels are
            typically abbreviated commit hashes, with the newest being
            the fresh run).
        names: metric names to show (default: the newest report's gated
            metrics, then its informational ones).
        max_cols: keep only the last ``max_cols`` history columns.
    """
    if not history:
        return "(no history)"
    history = list(history)[-max_cols:]
    newest = history[-1][1]
    if names is None:
        names = [m.name for m in newest.metrics if m.gate] + \
                [m.name for m in newest.metrics if not m.gate]
    labels = [lbl for lbl, _ in history]
    w = max([len(n) for n in names] or [4])
    cw = max([len(x) for x in labels] + [10])
    out = [f"trend ({newest.area}):",
           " " * (w + 3) + " ".join(f"{x:>{cw}s}" for x in labels)]
    for n in names:
        vals = []
        for _, rep in history:
            m = rep.metric(n)
            vals.append("—" if m is None else f"{m.value:g}")
        out.append(f"  {n:<{w}s} " + " ".join(f"{v:>{cw}s}" for v in vals))
    return "\n".join(out)
