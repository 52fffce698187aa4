"""The one traffic generator: a traffic mix's data file to traces.

A mix is ``traffic/<name>.json``:

* ``entry``: ``run`` (one scenario, the port's ``core.sim.run``) or
  ``run_sweep`` (a batch, the port's ``core.sweep.run_sweep``);
* ``chunk``: simulated cycles per termination check of the port's
  driver;
* ``cycles_per_s``: the cycles of every scenario that a window steps for
  each second of ``--seconds``: a fixed amount of work, set from the
  program's speed when the mix was written, so that the window lasts
  about ``--seconds`` then and never reaches the end of the traces;
* ``scenarios``: a list of ``{"source", "refs_per_core", "seed_offset",
  "knobs"}``.  ``source`` is a generator's name with its parameters
  (``random``, ``matmul``, ``hotspot:frac=0.8,hot=2``, ``transpose:0.1``),
  a scenario's seed is the run's ``--seed`` plus ``seed_offset``, and
  ``knobs`` overrides the configuration's per-scenario policies.

The generators are frozen copies of the port's (:mod:`.apps`,
:mod:`.patterns`), so a later change to the port's generators changes
no input here.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, List, Tuple

import numpy as np

from . import apps, patterns

HERE = Path(__file__).resolve().parent
ENTRIES = ("run", "run_sweep")
#: the policies a scenario may set for itself (the port's sweep knobs)
KNOBS = ("migration_enabled", "migrate_threshold", "centralized_directory",
         "eject_age_threshold")
SCENARIO_KEYS = ("source", "refs_per_core", "seed_offset", "knobs")

#: generator name -> (function, positional parameter names, parameter types)
_GENS = {"random": (lambda cfg, refs, seed: apps.random_trace(cfg, refs, seed),
                    (), {})}
for _app in apps.TRACE_APPS:
    _GENS[_app] = ((lambda cfg, refs, seed, _a=_app:
                    apps.app_trace(cfg, _a, refs, seed)), (), {})
for _p in patterns.PERMUTATIONS:
    _GENS[_p] = ((lambda cfg, refs, seed, rate=1.0, _n=_p:
                  patterns.permutation(cfg, refs, seed, _n, rate)),
                 ("rate",), {"rate": float})
_GENS["hotspot"] = (patterns.hotspot, ("frac",),
                    {"rate": float, "frac": float, "hot": int})


def parse_source(spec: str) -> Tuple[str, Dict[str, Any]]:
    """``name`` or ``name:key=val,...`` (bare values fill the generator's
    positional parameters) to the generator's name and parameters."""
    name, _, argstr = spec.partition(":")
    if name not in _GENS:
        raise ValueError(f"unknown traffic source {name!r}; known: "
                         f"{sorted(_GENS)}")
    _, positional, types = _GENS[name]
    params: Dict[str, Any] = {}
    pos = 0
    for tok in filter(None, (t.strip() for t in argstr.split(","))):
        if "=" in tok:
            key, _, raw = tok.partition("=")
            key = key.strip()
        else:
            if pos >= len(positional):
                raise ValueError(f"source {spec!r}: unexpected value {tok!r}")
            key, raw = positional[pos], tok
            pos += 1
        if key not in types or key in params:
            raise ValueError(f"source {spec!r}: bad parameter {key!r}")
        params[key] = types[key](raw.strip())
    return name, params


def source_trace(cfg, spec: str, refs: int, seed: int) -> np.ndarray:
    """One scenario's ``(num_nodes, refs)`` int32 trace."""
    name, params = parse_source(spec)
    return _GENS[name][0](cfg, refs, seed, **params)


def load_mix(name: str) -> Dict[str, Any]:
    """Read and check ``traffic/<name>.json``."""
    with open(HERE / f"{name}.json") as f:
        mix = json.load(f)
    if mix.get("entry") not in ENTRIES:
        raise ValueError(f"traffic {name}: entry must be one of {ENTRIES}")
    if not isinstance(mix.get("chunk"), int) or mix["chunk"] < 1:
        raise ValueError(f"traffic {name}: chunk must be a whole number >= 1")
    rate = mix.get("cycles_per_s")
    if isinstance(rate, bool) or not isinstance(rate, (int, float)) \
            or rate <= 0:
        raise ValueError(f"traffic {name}: cycles_per_s must be a number > 0")
    scen = mix.get("scenarios")
    if not scen or (mix["entry"] == "run" and len(scen) != 1):
        raise ValueError(f"traffic {name}: {mix['entry']} needs "
                         f"{'one scenario' if mix['entry'] == 'run' else 'scenarios'}")
    for sc in scen:
        if set(sc) != set(SCENARIO_KEYS):
            raise ValueError(f"traffic {name}: a scenario has the keys "
                             f"{sorted(sc)}, not {sorted(SCENARIO_KEYS)}")
        parse_source(sc["source"])
        if set(sc["knobs"]) - set(KNOBS):
            raise ValueError(f"traffic {name}: knobs {sorted(sc['knobs'])} "
                             f"beyond {KNOBS}")
    return mix


def make_traces(cfg, mix: Dict[str, Any], seed: int) -> np.ndarray:
    """The mix's ``(B, num_nodes, M)`` int32 traces for ``seed``, each
    scenario right-padded with ``-1`` (the end-of-trace mark) to the
    longest."""
    mats = [source_trace(cfg, sc["source"], sc["refs_per_core"],
                         seed + sc["seed_offset"])
            for sc in mix["scenarios"]]
    m = max(t.shape[1] for t in mats)
    out = np.full((len(mats), cfg.num_nodes, m), -1, np.int32)
    for b, t in enumerate(mats):
        out[b, :, :t.shape[1]] = t
    return out


def scenario_configs(cfg, mix: Dict[str, Any]) -> List:
    """Each scenario's configuration: ``cfg`` with its knobs."""
    return [dataclasses.replace(cfg, **sc["knobs"]) for sc in mix["scenarios"]]
