"""Scenario-zoo registry: named scenario families for tuning and CI.

A :class:`ZooFamily` is a compact cross-product — mesh sizes x workload
sources x seeds x refs, over a shared set of ``SimConfig`` overrides —
that expands into plan-engine scenarios (:func:`ZooFamily.expand`) or a
JSON manifest (:func:`ZooFamily.manifest`).  A copy of the JAX package's
``repro.core.zoo``: the same families, names, sizes and help strings, so
``--zoo`` names the same scenarios in both launchers.

Sources are workload-registry specs (:mod:`repro_torch.core.workloads`), so
every synthetic pattern (with parameters) and the ``loop:`` reference
generators are zoo-able.  Pattern families set
``centralized_directory=False`` — synthetic destination patterns
materialize through distributed directory homes (see
:mod:`repro_torch.core.workloads.patterns`).

Zoo spec grammar (the launcher's ``--zoo``)::

    patterns-small                         # a family, as registered
    patterns-small:refs=20,seeds=0+1+2     # with overrides
    patterns-small:meshes=4x4+8x8          # '+'-joined list values
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from .config import SimConfig
from .engine import Scenario, make_scenario
from .workloads import PATTERN_NAMES, TRACE_APPS, valid_source

__all__ = ["ZooFamily", "register_family", "get_family", "family_names",
           "zoo_summary", "expand_zoo"]


@dataclasses.dataclass(frozen=True)
class ZooFamily:
    """One named scenario family: a mesh x source x seed cross-product.

    Attributes:
        name: registry key (the ``--zoo`` spelling).
        help: one-line description for CLI listings.
        meshes: ``(rows, cols)`` mesh shapes to cross.
        sources: workload-registry source specs to cross.
        seeds: trace-synthesis seeds to cross.
        refs: references per core for every scenario.
        base: ``SimConfig`` field overrides shared by the family
            (e.g. ``centralized_directory=False`` for pattern families).
    """

    name: str
    help: str
    meshes: Tuple[Tuple[int, int], ...]
    sources: Tuple[str, ...]
    seeds: Tuple[int, ...] = (0,)
    refs: int = 60
    base: Mapping[str, object] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        """Scenarios this family expands to."""
        return len(self.meshes) * len(self.sources) * len(self.seeds)

    def expand(self, base: Optional[SimConfig] = None) -> List[Scenario]:
        """The family's scenario list (mesh-major, then source, then
        seed), built over ``base`` (default :class:`SimConfig`) with the
        family's overrides applied."""
        cfg = base or SimConfig()
        return [make_scenario(cfg, r, c, app=src, seed=s,
                              refs_per_core=self.refs, **dict(self.base))
                for (r, c) in self.meshes
                for src in self.sources
                for s in self.seeds]

    def manifest(self) -> Dict:
        """The family as a ``load_manifest``-compatible JSON object."""
        return {
            "base": dict(self.base),
            "scenarios": [
                {"rows": r, "cols": c, "app": src, "seed": s,
                 "refs_per_core": self.refs}
                for (r, c) in self.meshes
                for src in self.sources
                for s in self.seeds],
        }


_ZOO: Dict[str, ZooFamily] = {}


def register_family(fam: ZooFamily) -> ZooFamily:
    """Add ``fam`` to the zoo (name must be new; every source spec must
    parse against the workload registry) and return it."""
    if fam.name in _ZOO:
        raise ValueError(f"zoo family {fam.name!r} already registered")
    bad = [s for s in fam.sources if not valid_source(s)]
    if bad:
        raise ValueError(f"zoo family {fam.name!r}: invalid source "
                         f"spec(s) {bad}")
    _ZOO[fam.name] = fam
    return fam


def family_names() -> Tuple[str, ...]:
    """Registered family names (registration order)."""
    return tuple(_ZOO)


def get_family(name: str) -> ZooFamily:
    """Look up a family; ``ValueError`` listing the zoo on a miss."""
    try:
        return _ZOO[name]
    except KeyError:
        raise ValueError(f"unknown zoo family {name!r}; families: "
                         f"{list(_ZOO)}") from None


def zoo_summary() -> str:
    """One line per family: name, size, description (CLI listing)."""
    return "\n".join(f"{f.name} ({f.size} scenarios): {f.help}"
                     for f in _ZOO.values())


def _parse_meshes(raw: str) -> Tuple[Tuple[int, int], ...]:
    out = []
    for item in raw.split("+"):
        r, _, c = item.lower().partition("x")
        out.append((int(r), int(c)))
    return tuple(out)


def expand_zoo(spec: str, base: Optional[SimConfig] = None
               ) -> List[Scenario]:
    """Expand a zoo spec (``family`` or ``family:key=val,...``) into
    scenarios over ``base``.

    Overridable keys: ``refs`` (int), ``seeds`` (``+``-joined ints),
    ``meshes`` (``+``-joined ``RxC``), ``sources`` (``+``-joined source
    specs — which may themselves contain ``:``/``,``-free forms only;
    use a manifest for parameterized sources beyond the family's own)."""
    name, _, argstr = spec.partition(":")
    fam = get_family(name.strip())
    kw: Dict[str, object] = {}
    for tok in argstr.split(","):
        tok = tok.strip()
        if not tok:
            continue
        key, eq, raw = tok.partition("=")
        key, raw = key.strip(), raw.strip()
        if not eq or key not in ("refs", "seeds", "meshes", "sources"):
            raise ValueError(
                f"zoo spec {spec!r}: expected key=val with key in "
                "['refs', 'seeds', 'meshes', 'sources'], got " + repr(tok))
        if key == "refs":
            kw["refs"] = int(raw)
        elif key == "seeds":
            kw["seeds"] = tuple(int(x) for x in raw.split("+"))
        elif key == "meshes":
            kw["meshes"] = _parse_meshes(raw)
        else:
            kw["sources"] = tuple(raw.split("+"))
    if kw:
        fam = dataclasses.replace(fam, **kw)
        bad = [s for s in fam.sources if not valid_source(s)]
        if bad:
            raise ValueError(f"zoo spec {spec!r}: invalid source(s) {bad}")
    return fam.expand(base)


# ---------------------------------------------------------------------------
# Built-in families.
# ---------------------------------------------------------------------------

#: distributed directory: destination patterns materialize through the
#: tag-home map (centralized would collapse every pattern onto node 0)
_DIST = {"centralized_directory": False}

register_family(ZooFamily(
    name="patterns-tiny",
    help="all five synthetic patterns on a 4x4 mesh, 2 seeds — the CI "
         "zoo-smoke slice",
    meshes=((4, 4),), sources=PATTERN_NAMES, seeds=(0, 1), refs=12,
    base=_DIST))

register_family(ZooFamily(
    name="patterns-small",
    help="all five synthetic patterns at full injection rate on 4x4 and "
         "8x8 meshes",
    meshes=((4, 4), (8, 8)), sources=PATTERN_NAMES, seeds=(0, 1), refs=40,
    base=_DIST))

register_family(ZooFamily(
    name="patterns-rates",
    help="each pattern at injection rates 0.33 / 0.66 / 1.0 on 8x8",
    meshes=((8, 8),),
    sources=tuple(f"{p}:rate={r}" for p in PATTERN_NAMES
                  for r in ("0.33", "0.66", "1.0")),
    seeds=(0,), refs=60, base=_DIST))

register_family(ZooFamily(
    name="hotspot-stress",
    help="hotspot concentration sweep (frac 0.25..1.0, 1 and 2 hot "
         "nodes) on 8x8 — the ejection-guarantee stressor",
    meshes=((8, 8),),
    sources=tuple(f"hotspot:frac={f},hot={h}"
                  for f in ("0.25", "0.5", "0.75", "1.0") for h in (1, 2)),
    seeds=(0,), refs=60, base=_DIST))

register_family(ZooFamily(
    name="apps-small",
    help="the paper's five application models plus the uniform injector "
         "on 8x8",
    meshes=((8, 8),), sources=tuple(TRACE_APPS) + ("random",),
    seeds=(0, 1), refs=60, base=_DIST))

register_family(ZooFamily(
    name="wedge",
    help="the former S14 ejection-bar livelock family (16x16 loop:matmul, "
         "ROADMAP) — the original threshold-tuning anchor",
    meshes=((16, 16),), sources=("loop:matmul",), seeds=(0,), refs=20,
    base=_DIST))
