"""Traffic-generator registry and the one source grammar.

Every trace source the simulator can synthesize — the paper's five
application models, the uniform ``random`` injector, the ``loop``
reference generators, the synthetic NoC patterns — is a registered
:class:`TrafficGen`.  Validation (:func:`valid_source`), dispatch
(:func:`resolve`), CLI help and error text (:func:`source_help`,
:func:`source_summary`) all derive from the same registry, so adding a
generator is ONE :func:`register` call: it immediately becomes reachable
from ``resolve_trace``, ``stacked_traces``, manifests, ``--app``, the
zoo, and the generated ``docs/cli.md``.

Grammar (one spelling everywhere)::

    name                    # defaults for every parameter
    name:key=val,key=val    # keyword parameters
    name:val                # positional (mapped by TrafficGen.positional)

``loop:matmul`` — the historical spelling of the per-node-loop reference
generator — parses as generator ``loop`` with positional ``app=matmul``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from ..config import SimConfig

__all__ = ["Param", "TrafficGen", "register", "get_gen", "gen_names",
           "parse_source", "valid_source", "resolve", "source_help",
           "source_summary"]


@dataclasses.dataclass(frozen=True)
class Param:
    """One tunable parameter of a :class:`TrafficGen`.

    Attributes:
        default: value used when the source spec omits the parameter.
        typ: coercion applied to the spec's string value (``float`` /
            ``int`` / ``str``).
        help: one-line description (surfaces in :func:`source_help`).
        lo: inclusive lower bound (``None`` = unbounded).
        hi: inclusive upper bound (``None`` = unbounded).
        choices: closed set of admissible values (``None`` = any).
    """

    default: object
    typ: Callable = float
    help: str = ""
    lo: Optional[float] = None
    hi: Optional[float] = None
    choices: Optional[Tuple] = None

    def coerce(self, raw, *, source: str):
        """Parse + bounds-check one raw value; raises ``ValueError`` with
        the offending ``source`` spec named."""
        try:
            v = self.typ(raw)
        except (TypeError, ValueError):
            raise ValueError(
                f"source {source!r}: cannot parse {raw!r} as "
                f"{self.typ.__name__}") from None
        if self.choices is not None and v not in self.choices:
            raise ValueError(f"source {source!r}: {v!r} not in "
                             f"{sorted(self.choices)}")
        if self.lo is not None and v < self.lo:
            raise ValueError(f"source {source!r}: {v!r} < {self.lo}")
        if self.hi is not None and v > self.hi:
            raise ValueError(f"source {source!r}: {v!r} > {self.hi}")
        return v


@dataclasses.dataclass(frozen=True)
class TrafficGen:
    """A registered trace source.

    Attributes:
        name: registry key — the first token of the source grammar.
        fn: ``fn(cfg, refs_per_core, seed, **params) -> (N, M) int32``
            address trace (``-1`` is the trace-exhaustion sentinel and
            must never appear as a generated address).
        kind: coarse family tag — ``"app"`` (representative application
            model), ``"injector"`` (uniform random), ``"reference"``
            (per-node-loop golden generators), ``"pattern"`` (synthetic
            NoC destination patterns).
        help: one-line description for CLI/docs.
        params: name → :class:`Param` spec of the tunables.
        positional: parameter names bare (``key``-less) grammar tokens
            map to, in order — e.g. ``loop:matmul`` == ``loop:app=matmul``.
    """

    name: str
    fn: Callable[..., np.ndarray]
    kind: str = "app"
    help: str = ""
    params: Mapping[str, Param] = dataclasses.field(default_factory=dict)
    positional: Tuple[str, ...] = ()

    def spec(self, **params) -> str:
        """The canonical grammar string for this generator with
        ``params`` (defaults omitted) — the inverse of
        :func:`parse_source`."""
        items = [f"{k}={params[k]}" for k in self.params
                 if k in params and params[k] != self.params[k].default]
        return self.name + (":" + ",".join(items) if items else "")


_REGISTRY: Dict[str, TrafficGen] = {}


def register(gen: TrafficGen) -> TrafficGen:
    """Add ``gen`` to the registry (its ``name`` must be new) and return
    it, so modules can register at import time."""
    if gen.name in _REGISTRY:
        raise ValueError(f"traffic generator {gen.name!r} already registered")
    _REGISTRY[gen.name] = gen
    return gen


def gen_names(kind: Optional[str] = None) -> Tuple[str, ...]:
    """Registered generator names (insertion order), optionally filtered
    by ``kind``."""
    return tuple(n for n, g in _REGISTRY.items()
                 if kind is None or g.kind == kind)


def get_gen(name: str) -> TrafficGen:
    """Look up a generator by registry ``name``; ``ValueError`` (with the
    full registry listed) on an unknown name."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown trace source {name!r}; "
                         + source_summary()) from None


def parse_source(spec: str) -> Tuple[TrafficGen, Dict[str, object]]:
    """Parse a source spec (``name`` or ``name:key=val,...``) into its
    generator and a fully-defaulted, validated parameter dict.

    Raises ``ValueError`` — with registry-derived help — on an unknown
    generator, unknown/duplicate parameter, unparsable value, or a bare
    token beyond the generator's positional slots."""
    name, _, argstr = spec.partition(":")
    gen = get_gen(name.strip())
    params = {k: p.default for k, p in gen.params.items()}
    pos = 0
    if argstr.strip():
        seen = set()
        for tok in argstr.split(","):
            tok = tok.strip()
            if not tok:
                continue
            if "=" in tok:
                key, _, raw = tok.partition("=")
                key = key.strip()
            else:
                if pos >= len(gen.positional):
                    raise ValueError(
                        f"source {spec!r}: unexpected bare value {tok!r} "
                        f"({gen.name} takes "
                        f"{len(gen.positional)} positional parameter(s): "
                        f"{list(gen.positional)})")
                key, raw = gen.positional[pos], tok
                pos += 1
            if key not in gen.params:
                raise ValueError(
                    f"source {spec!r}: unknown parameter {key!r} for "
                    f"{gen.name!r}; parameters: {sorted(gen.params)}")
            if key in seen:
                raise ValueError(f"source {spec!r}: duplicate parameter "
                                 f"{key!r}")
            seen.add(key)
            params[key] = gen.params[key].coerce(raw.strip(), source=spec)
    return gen, params


def valid_source(spec: str) -> bool:
    """Does ``spec`` parse against the registry?  Exactly the set of
    names :func:`resolve` accepts — validation and dispatch share
    :func:`parse_source`."""
    try:
        parse_source(spec)
        return True
    except ValueError:
        return False


def resolve(cfg: SimConfig, spec: str, refs_per_core: int,
            seed: int) -> np.ndarray:
    """Synthesize the ``(num_nodes, refs_per_core)`` trace for ``spec``:
    parse the source against the registry, then call its generator with
    ``cfg``/``refs_per_core``/``seed`` and the parsed parameters."""
    gen, params = parse_source(spec)
    return gen.fn(cfg, refs_per_core, seed, **params)


def source_summary() -> str:
    """One-line registry roll-call used by error messages — kinds with
    their generator names, plus the grammar reminder."""
    kinds = []
    for kind in dict.fromkeys(g.kind for g in _REGISTRY.values()):
        names = ", ".join(gen_names(kind))
        kinds.append(f"{kind}s: {names}")
    return ("known sources — " + "; ".join(kinds)
            + " (grammar: name or name:key=val,...)")


def source_help() -> str:
    """Multi-line per-generator help — one line per generator with its
    kind, parameters (name=default, plus each parameter's description)
    and summary.  Rendered into the generated ``docs/cli.md`` "Workload
    sources" section by ``scripts/gen_cli_docs.py`` (the short
    roll-call in the ``--app`` flag help is :func:`source_summary`)."""
    lines = []
    for g in _REGISTRY.values():
        ps = "; ".join(f"{k}={p.default} ({p.help})" if p.help
                       else f"{k}={p.default}"
                       for k, p in g.params.items())
        lines.append(f"{g.name} [{g.kind}]: {g.help}"
                     + (f"\n    params: {ps}" if ps else ""))
    return "\n".join(lines)
