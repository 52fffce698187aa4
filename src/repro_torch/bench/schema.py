"""Benchmark metrics contract: ``Metric`` + ``BenchReport``.

A copy of the JAX package's ``repro.bench.schema``: the same fields,
validation and on-disk JSON, so the committed baselines it wrote read
here unchanged.

Every benchmark in this repo emits a :class:`BenchReport` — a flat list
of named, unit-tagged, direction-aware :class:`Metric` values — instead
of free-form prints.  The committed ``BENCH_<area>.json`` baselines at
the repo root are serialized reports; ``scripts/bench_gate.py`` diffs a
fresh run against them with per-metric slack (see
:mod:`repro_torch.bench.gate` and ``docs/benchmarks.md``).

Design rules:

* a metric's *name* is stable — renaming one is a baseline-breaking
  change (the gate reports it as a vanished metric);
* ``direction`` says which way is better, so the gate only fails on
  drift in the *bad* direction — improvements are reported, not failed;
* ``slack`` is the tolerated relative drift in the bad direction
  (absolute when the baseline value is 0, where relative drift is
  undefined);
* ``gate=False`` marks informational metrics (raw wall-clock times,
  which vary across hosts) that are tracked in the trend table but never
  fail CI — portable *ratios* (speedups) and deterministic *counts*
  (cycles, compiles, drops) are the gated surface.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["Metric", "BenchReport", "SCHEMA_VERSION"]

#: bump when the on-disk JSON layout changes incompatibly
SCHEMA_VERSION = 1

_DIRECTIONS = ("higher", "lower")

Num = Union[int, float]


@dataclasses.dataclass(frozen=True)
class Metric:
    """One measured value with enough context to gate and trend it.

    Args:
        name: stable dotted identifier, e.g. ``"wedge.completion_cycles"``
            — unique within its report's area.
        value: the measurement (int or float; bools are recorded as 0/1).
        unit: human unit label (``"s"``, ``"scenarios/s"``, ``"cycles"``,
            ``"count"``, ``"ratio"``, ``"bool"``, ...).
        direction: ``"higher"`` or ``"lower"`` — which way is *better*.
        slack: tolerated relative drift in the bad direction before the
            gate fails (``0.5`` = fails past 50% worse than baseline).
            Interpreted as an absolute allowance when the baseline value
            is exactly 0.
        gate: when ``False`` the metric is informational — trended but
            never failed (use for host-dependent raw wall times).
        tags: free-form context (``mesh``, ``backend``, ``app``, ...)
            used for display and trend grouping, never for matching.
    """

    name: str
    value: Num
    unit: str = "count"
    direction: str = "lower"
    slack: float = 0.0
    gate: bool = True
    tags: Dict[str, str] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.name:
            raise ValueError("metric name must be non-empty")
        if self.direction not in _DIRECTIONS:
            raise ValueError(
                f"metric {self.name!r}: direction must be one of "
                f"{_DIRECTIONS}, got {self.direction!r}")
        if isinstance(self.value, bool):
            object.__setattr__(self, "value", int(self.value))
        if not isinstance(self.value, (int, float)) or \
                not math.isfinite(self.value):
            raise ValueError(f"metric {self.name!r}: value must be a "
                             f"finite number, got {self.value!r}")
        if self.slack < 0:
            raise ValueError(f"metric {self.name!r}: slack must be >= 0")

    def to_dict(self) -> Dict:
        """JSON-ready dict (inverse of :meth:`from_dict`)."""
        d = dataclasses.asdict(self)
        if not d["tags"]:
            d.pop("tags")
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "Metric":
        """Rebuild a metric from :meth:`to_dict` output (validates)."""
        return cls(**d)


class BenchReport:
    """One benchmark run's emitted metrics + context, JSON round-trippable.

    Args:
        area: short area slug — baselines live at ``BENCH_<area>.json``.
        meta: run context (``smoke`` flag, key parameters, host notes).
        metrics: the measurements, in emission order.
        raw: the benchmark's legacy free-form payload dict, carried for
            debugging and the ``--json`` compatibility flag; the gate
            never reads it.
    """

    def __init__(self, area: str, meta: Optional[Dict] = None,
                 metrics: Sequence[Metric] = (), raw: Optional[Dict] = None):
        if not area:
            raise ValueError("report area must be non-empty")
        self.area = area
        self.meta = dict(meta or {})
        self.metrics: List[Metric] = []
        self.raw = dict(raw or {})
        seen = set()
        for m in metrics:
            if m.name in seen:
                raise ValueError(f"duplicate metric {m.name!r} in report "
                                 f"{area!r}")
            seen.add(m.name)
            self.metrics.append(m)

    # -- building -----------------------------------------------------
    def add(self, name: str, value: Num, **kw) -> Metric:
        """Append a new :class:`Metric` (kwargs as in ``Metric``);
        duplicate names raise."""
        m = Metric(name=name, value=value, **kw)
        if self.metric(name) is not None:
            raise ValueError(f"duplicate metric {name!r} in report "
                             f"{self.area!r}")
        self.metrics.append(m)
        return m

    def extend(self, metrics: Sequence[Metric]) -> None:
        """Append pre-built metrics (same duplicate check as :meth:`add`)."""
        for m in metrics:
            if self.metric(m.name) is not None:
                raise ValueError(f"duplicate metric {m.name!r} in report "
                                 f"{self.area!r}")
            self.metrics.append(m)

    # -- access -------------------------------------------------------
    def metric(self, name: str) -> Optional[Metric]:
        """The metric called ``name``, or ``None``."""
        for m in self.metrics:
            if m.name == name:
                return m
        return None

    def names(self) -> Tuple[str, ...]:
        """Metric names in emission order."""
        return tuple(m.name for m in self.metrics)

    def __eq__(self, other):
        return (isinstance(other, BenchReport)
                and self.area == other.area and self.meta == other.meta
                and self.metrics == other.metrics and self.raw == other.raw)

    def __repr__(self):
        return (f"BenchReport(area={self.area!r}, "
                f"metrics={len(self.metrics)})")

    # -- serialization ------------------------------------------------
    def to_dict(self) -> Dict:
        """JSON-ready dict (inverse of :meth:`from_dict`)."""
        return {
            "schema_version": SCHEMA_VERSION,
            "area": self.area,
            "meta": self.meta,
            "metrics": [m.to_dict() for m in self.metrics],
            **({"raw": self.raw} if self.raw else {}),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "BenchReport":
        """Rebuild a report from :meth:`to_dict` output (validates every
        metric; unknown schema versions raise)."""
        ver = d.get("schema_version", SCHEMA_VERSION)
        if ver > SCHEMA_VERSION:
            raise ValueError(f"BENCH schema version {ver} is newer than "
                             f"this checkout understands ({SCHEMA_VERSION})")
        return cls(area=d["area"], meta=d.get("meta", {}),
                   metrics=[Metric.from_dict(m) for m in d.get("metrics", [])],
                   raw=d.get("raw", {}))

    def to_json(self, indent: int = 1) -> str:
        """Serialize (stable layout; newline-terminated for clean diffs)."""
        return json.dumps(self.to_dict(), indent=indent) + "\n"

    @classmethod
    def from_json(cls, text: str) -> "BenchReport":
        """Parse :meth:`to_json` output."""
        return cls.from_dict(json.loads(text))

    def write(self, path: str) -> None:
        """Write the report to ``path`` as JSON."""
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def read(cls, path: str) -> "BenchReport":
        """Load a report previously written with :meth:`write`."""
        with open(path) as f:
            return cls.from_json(f.read())

    # -- display ------------------------------------------------------
    def render(self) -> str:
        """Human table: one row per metric (gated rows marked ``*``)."""
        rows = [f"== BENCH {self.area} "
                f"({'smoke' if self.meta.get('smoke') else 'full'} tier) =="]
        w = max([len(m.name) for m in self.metrics] or [4])
        for m in self.metrics:
            val = f"{m.value:g}"
            mark = "*" if m.gate else " "
            arrow = "^" if m.direction == "higher" else "v"
            tag = " ".join(f"{k}={v}" for k, v in m.tags.items())
            rows.append(f" {mark} {m.name:<{w}s} {val:>12s} {m.unit:<12s} "
                        f"{arrow} slack={m.slack:g}"
                        + (f"  [{tag}]" if tag else ""))
        return "\n".join(rows)
