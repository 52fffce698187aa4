"""Pluggable workload layer: every trace source behind one registry.

Importing this package registers every built-in traffic generator:

* the five representative **app** models (``matmul``, ``apsi``,
  ``mgrid``, ``wupwise``, ``equake``) — :mod:`.apps`;
* the uniform **injector** ``random`` — :mod:`.apps`;
* the per-node-loop **reference** family ``loop`` (``loop:matmul``
  spells the historical generator) — :mod:`.apps`;
* the synthetic NoC **patterns** ``transpose`` / ``bitcomp`` /
  ``hotspot`` / ``tornado`` / ``neighbor``, parameterized by injection
  rate and hot-node fraction — :mod:`.patterns`.

One grammar everywhere (``name`` or ``name:key=val,...`` — see
:mod:`.base`): :func:`resolve_trace`, :func:`stacked_traces`, manifests,
``--app``, the zoo and the generated CLI docs all dispatch through the
same registry, so registering a generator is the whole job of adding a
scenario source.  This package is a copy of the JAX package's
``repro.core.workloads``; its traces are byte-identical to those.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..config import SimConfig
from .base import (Param, TrafficGen, gen_names, get_gen, parse_source,
                   register, resolve, source_help, source_summary,
                   valid_source)
from .apps import (TRACE_APPS, app_trace, app_trace_loop,
                   from_model_schedule, random_trace)
from .patterns import PATTERN_NAMES, dst_map, pattern_trace

__all__ = [
    "Param", "TrafficGen", "register", "get_gen", "gen_names",
    "parse_source", "valid_source", "source_help", "source_summary",
    "resolve_trace", "valid_app", "stacked_traces",
    "TRACE_APPS", "PATTERN_NAMES", "app_trace", "app_trace_loop",
    "random_trace", "from_model_schedule", "pattern_trace", "dst_map",
]


def resolve_trace(cfg: SimConfig, app: str, refs_per_core: int,
                  seed: int) -> np.ndarray:
    """Trace-source dispatch shared by every scenario consumer.

    ``app`` is any registered source spec (``name`` or
    ``name:key=val,...``): an app model, ``random``, ``loop:<app>``, or
    a synthetic pattern like ``hotspot:frac=0.8,hot=2`` — see
    :func:`source_summary` for the live registry.  ``cfg``,
    ``refs_per_core`` and ``seed`` are forwarded to the generator."""
    return resolve(cfg, app, refs_per_core, seed)


def valid_app(app: str) -> bool:
    """Is ``app`` a source spec :func:`resolve_trace` accepts?  Alias of
    :func:`valid_source` — validation and dispatch share one parser, so
    the two can never disagree."""
    return valid_source(app)


def stacked_traces(cfg: SimConfig, specs, default_refs: int = 200) -> np.ndarray:
    """Stack per-scenario traces into one ``(B, num_nodes, M)`` block for
    a batched run (:func:`repro_torch.core.sim.run`).

    ``specs`` is an iterable of ``(app, seed)`` or ``(app, seed,
    refs_per_core)`` tuples, where ``app`` is any :func:`resolve_trace`
    source spec.  Scenarios with fewer references are right-padded with
    ``-1`` — the trace-exhaustion sentinel — which is semantically
    identical to running them unpadded, so scenarios of different lengths
    can share one batch.
    """
    mats = []
    for sp in specs:
        app, seed = sp[0], sp[1]
        refs = sp[2] if len(sp) > 2 else default_refs
        mats.append(resolve_trace(cfg, app, refs, seed))
    if not mats:
        raise ValueError("stacked_traces needs at least one scenario")
    m = max(t.shape[1] for t in mats)
    out = np.full((len(mats), cfg.num_nodes, m), -1, np.int32)
    for b, t in enumerate(mats):
        out[b, :, : t.shape[1]] = t
    return out
