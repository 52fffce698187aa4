#!/usr/bin/env python
"""Doc-coverage gate for the public ``repro_torch.core`` and
``repro_torch.bench`` surface of the PyTorch port.

Two checks, both cheap (imports only — no simulation):

1. every symbol a core module exports via ``__all__`` carries a
   non-trivial docstring;
2. the *named* public surface — the symbols users script against —
   documents every parameter by name (args/returns/shape conventions
   live in the docstrings; this guard keeps them from rotting when a
   signature changes).

The counterpart of ``scripts/check_doc_coverage.py``: the same modules
and named surface under ``repro_torch.``, the same ``MIN_DOC``.  Run:

    PYTHONPATH=src python scripts/check_doc_coverage_torch.py
"""
from __future__ import annotations

import importlib
import inspect
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                os.pardir, "src"))

#: modules whose whole ``__all__`` must be documented
MODULES = [
    "repro_torch.core",
    "repro_torch.bench",
    "repro_torch.core.engine",
    "repro_torch.core.sweep",
    "repro_torch.core.sharded",
    "repro_torch.core.sim",
    "repro_torch.core.config",
    "repro_torch.core.workloads",
    "repro_torch.core.zoo",
]

#: (module, symbol): every signature parameter must appear in the
#: docstring (class + __init__ docstrings count for classes)
NAMED_SURFACE = [
    ("repro_torch.core", "run"),
    ("repro_torch.core", "make_scenario"),
    ("repro_torch.bench", "Metric"),
    ("repro_torch.bench", "Benchmark"),
    ("repro_torch.bench", "compare_reports"),
    ("repro_torch.core.engine", "Scenario"),
    ("repro_torch.core.engine", "compile_plan"),
    ("repro_torch.core.engine", "execute_plan"),
    ("repro_torch.core.engine", "choose_backend"),
    ("repro_torch.core.engine", "backend_cost"),
    ("repro_torch.core.sweep", "SweepSpec"),
    ("repro_torch.core.sweep", "run_sweep"),
    ("repro_torch.core.sharded", "ShardedSim"),
    ("repro_torch.core.sharded", "run_composed"),
    ("repro_torch.core.workloads", "resolve_trace"),
    ("repro_torch.core.workloads", "pattern_trace"),
    ("repro_torch.core.zoo", "ZooFamily"),
]

MIN_DOC = 40   # characters; filters out placeholder one-worders


def symbol_doc(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    if inspect.isclass(obj):
        init = inspect.getdoc(obj.__init__) or ""
        if not init.startswith("Initialize self"):   # object.__init__ boilerplate
            doc += "\n" + init
    return doc


def params_of(obj):
    target = obj.__init__ if inspect.isclass(obj) else obj
    try:
        sig = inspect.signature(target)
    except (TypeError, ValueError):
        return []
    return [p for p in sig.parameters if p not in ("self", "cls")]


def main() -> int:
    errors = []
    for modname in MODULES:
        mod = importlib.import_module(modname)
        exported = getattr(mod, "__all__", None)
        if exported is None:
            errors.append(f"{modname}: missing __all__")
            continue
        for name in exported:
            obj = getattr(mod, name, None)
            if obj is None:
                errors.append(f"{modname}.{name}: in __all__ but undefined")
                continue
            if not (inspect.isclass(obj) or inspect.isroutine(obj)):
                continue   # data constants document themselves in context
            doc = symbol_doc(obj)
            if len(doc) < MIN_DOC:
                errors.append(f"{modname}.{name}: docstring missing or "
                              f"trivial ({len(doc)} chars < {MIN_DOC})")
    for modname, name in NAMED_SURFACE:
        obj = getattr(importlib.import_module(modname), name)
        doc = symbol_doc(obj)
        missing = [p for p in params_of(obj) if p not in doc]
        if missing:
            errors.append(f"{modname}.{name}: parameters not documented: "
                          f"{missing}")
    if errors:
        print("doc coverage FAILED:", file=sys.stderr)
        for e in errors:
            print(f"  - {e}", file=sys.stderr)
        return 1
    n = sum(len(getattr(importlib.import_module(m), "__all__", []))
            for m in MODULES)
    print(f"doc coverage OK ({n} exported symbols, "
          f"{len(NAMED_SURFACE)} param-checked)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
