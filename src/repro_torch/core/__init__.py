"""Public surface of the simulator core of the PyTorch port.

The stable API users script against::

    from repro_torch.core import SimConfig, run, compile_plan, execute_plan

    cfg = SimConfig(rows=8, cols=8, centralized_directory=False)
    stats = run(cfg, resolve_trace(cfg, "matmul", 50, seed=0))

The same names as the JAX package's ``repro.core``, resolved lazily (PEP
562): importing :mod:`repro_torch.core` pulls in nothing heavy (no
torch); the attribute access itself imports the defining submodule.
The submodules (:mod:`repro_torch.core.engine`,
:mod:`repro_torch.core.sweep`, ...) remain public too.
"""
from __future__ import annotations

import importlib

#: public name -> (defining module, attribute) — the lazy export table
_EXPORTS = {
    # configuration + solo runs
    "SimConfig": ("repro_torch.core.config", "SimConfig"),
    "CacheConfig": ("repro_torch.core.config", "CacheConfig"),
    "run": ("repro_torch.core.sim", "run"),
    "VectorSim": ("repro_torch.core.sim", "VectorSim"),
    "stats_list": ("repro_torch.core.sim", "stats_list"),
    "aggregate_stats": ("repro_torch.core.sim", "aggregate_stats"),
    "network_health": ("repro_torch.core.sim", "network_health"),
    "STAT_NAMES": ("repro_torch.core.state", "STAT_NAMES"),
    # execution-plan layer
    "Scenario": ("repro_torch.core.engine", "Scenario"),
    "make_scenario": ("repro_torch.core.engine", "make_scenario"),
    "compile_plan": ("repro_torch.core.engine", "compile_plan"),
    "execute_plan": ("repro_torch.core.engine", "execute_plan"),
    "load_manifest": ("repro_torch.core.engine", "load_manifest"),
    # workload registry
    "register": ("repro_torch.core.workloads", "register"),
    "parse_source": ("repro_torch.core.workloads", "parse_source"),
    "resolve_trace": ("repro_torch.core.workloads", "resolve_trace"),
    # scenario zoo
    "expand_zoo": ("repro_torch.core.zoo", "expand_zoo"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        modname, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module 'repro_torch.core' has no attribute {name!r}") from None
    return getattr(importlib.import_module(modname), attr)


def __dir__():
    return sorted(set(globals()) | set(__all__))
