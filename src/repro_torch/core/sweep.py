"""Multi-scenario sweep: B simulations of one mesh shape in one batch.

Every real evaluation of a deflection network sweeps scenarios —
applications, injection seeds, policy knobs.  :func:`run_sweep` builds
one batched state (a leading scenario axis B on every leaf) and drives
it with the port's driver (:func:`repro_torch.core.sim._drive`), which
steps the scenarios one after another and ends each on its own: an early
finisher stops counting cycles bit-identically to a solo
:func:`repro_torch.core.sim.run`, so scenarios of different lengths share
one batch.  The counterpart of the JAX package's ``repro.core.sweep``,
with the same results.

What may vary per scenario:
  * the workload — source spec / seed / refs-per-core (stacked,
    ``-1``-padded traces, see
    :func:`repro_torch.core.workloads.stacked_traces`);
  * the policy knobs carried in state (``SimState.knob_*``): migration
    on/off, migration threshold, centralized vs distributed directory,
    and the guaranteed-ejection age threshold.  Each is a ``(B,)`` int32
    tensor; scenario b's phases read the 0-d view at offset b.

What must be shared (it changes array shapes): mesh size, cache
geometry, latencies, ``dir_layout``, queue/ROB depths — these come from
the sweep-wide ``SweepSpec.cfg``.  Mixed-shape scenario lists are handled
one level up: :mod:`repro_torch.core.engine` buckets them by structural
config and runs one sweep per bucket.

Inside a process group (:mod:`repro_torch.dist`) the scenario axis is
split over the ranks, as the JAX package shards it over its local
devices: the batch is padded to a multiple of
:func:`scenario_device_count` with copies of the last scenario, each rank
drives its ``ceil(B / n)`` scenarios on its own device, and every rank
gets all the results back, in scenario order.  Without a group a sweep
runs on the one device it is given and nothing is padded.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..dist import rank, world_size
from .config import SimConfig
from .sim import _drive, check_cycle_cap, run, stats_list
from .state import init_state
from .workloads import stacked_traces

__all__ = ["ScenarioSpec", "SweepSpec", "run_sweep", "run_sequential",
           "scenario_device_count"]


@dataclasses.dataclass(frozen=True)
class ScenarioSpec:
    """One scenario of a sweep: a workload plus optional policy knobs.

    ``None`` knobs inherit the sweep-wide :class:`SimConfig` value."""

    app: str = "matmul"        # source spec (see workloads.resolve_trace)
    seed: int = 0
    refs_per_core: int = 200
    migration_enabled: Optional[bool] = None
    migrate_threshold: Optional[int] = None
    centralized_directory: Optional[bool] = None
    eject_age_threshold: Optional[int] = None

    def resolve_cfg(self, cfg: SimConfig) -> SimConfig:
        """This scenario's effective SimConfig (the sequential path runs
        a solo simulation with exactly this config)."""
        kw = {}
        if self.migration_enabled is not None:
            kw["migration_enabled"] = self.migration_enabled
        if self.migrate_threshold is not None:
            kw["migrate_threshold"] = self.migrate_threshold
        if self.centralized_directory is not None:
            kw["centralized_directory"] = self.centralized_directory
        if self.eject_age_threshold is not None:
            kw["eject_age_threshold"] = self.eject_age_threshold
        return dataclasses.replace(cfg, **kw) if kw else cfg


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """A batch of scenarios over one shared mesh/cache/latency config.

    Attributes:
        cfg: the sweep-wide structural :class:`SimConfig` — everything
            that changes array shapes (mesh size, cache geometry,
            latencies, ``dir_layout``, queue/ROB depths) is shared by all
            scenarios.
        scenarios: B :class:`ScenarioSpec` workloads; each may override
            the policy knobs only.

    The stacked workload block is ``(B, num_nodes, M)`` (``-1``-padded
    to the longest trace, see :meth:`traces`)."""

    cfg: SimConfig
    scenarios: Tuple[ScenarioSpec, ...]

    @classmethod
    def cross(cls, cfg: SimConfig, apps: Sequence[str],
              seeds: Sequence[int], refs_per_core: int = 200) -> "SweepSpec":
        """Cross-product sweep: every app with every seed."""
        return cls(cfg, tuple(ScenarioSpec(a, int(s), refs_per_core)
                              for a in apps for s in seeds))

    @property
    def size(self) -> int:
        return len(self.scenarios)

    def validate(self) -> None:
        if not self.scenarios:
            raise ValueError("empty sweep")
        for sc in self.scenarios:
            rc = sc.resolve_cfg(self.cfg)
            rc.validate()
            if self.cfg.dir_layout == "home" and rc.centralized_directory:
                raise ValueError(
                    "home-sharded directory layout cannot batch a "
                    f"centralized-directory scenario: {sc}")

    @functools.cached_property
    def _traces(self) -> np.ndarray:
        return stacked_traces(
            self.cfg,
            [(sc.app, sc.seed, sc.refs_per_core) for sc in self.scenarios])

    def traces(self) -> np.ndarray:
        """Stacked ``(B, num_nodes, M)`` workload block (synthesized once
        per spec — trace generation is host set-up, not part of the
        engine)."""
        return self._traces

    def knob_arrays(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                   np.ndarray]:
        """Per-scenario (migration, threshold, centralized, eject-age)
        int32 vectors — one entry per ``SimState.knob_*`` leaf."""
        res = [sc.resolve_cfg(self.cfg) for sc in self.scenarios]
        mig = np.asarray([int(c.migration_enabled) for c in res], np.int32)
        thr = np.asarray([c.migrate_threshold for c in res], np.int32)
        cen = np.asarray([int(c.centralized_directory) for c in res], np.int32)
        eja = np.asarray([c.eject_age_threshold for c in res], np.int32)
        return mig, thr, cen, eja


def scenario_device_count(batch: int, ndev: int) -> int:
    """Devices (ranks) the scenario axis uses: ``min(ndev, batch)``, at
    least 1.  :func:`run_sweep` pads an indivisible batch up to a
    multiple of this count, so every rank carries ``ceil(batch / n)``
    scenarios; the planner's cost model in :mod:`repro_torch.core.engine`
    counts the same number, as the JAX package's does."""
    return max(min(ndev, batch), 1)


def run_sweep(spec: SweepSpec, max_cycles: Optional[int] = None,
              chunk: int = 1, device=None) -> List[Dict[str, int]]:
    """Run all scenarios of ``spec`` as one batched state.

    Args:
        spec: the sweep — B workloads plus policy knobs over one
            structural config.
        max_cycles: per-scenario cycle cap (default ``cfg.max_cycles``).
        chunk: simulated cycles per termination check (one host sync);
            the per-cycle tail keeps the cap exact either way.
        device: ``None`` (the GPU), ``"cuda"``, ``"cuda:<i>"`` or
            ``"cpu"``.  Without a GPU only ``"cpu"`` runs.

    Inside a process group every rank must call it with the same spec;
    each drives its share of the scenarios on its own ``device``.

    Returns: one stats dict per scenario, in scenario order, bit-identical
    to what a solo ``run(sc.resolve_cfg(cfg), trace)`` would produce, on
    every rank.
    """
    spec.validate()
    cfg = spec.cfg
    check_cycle_cap(cfg, max_cycles)
    dev = resolve_device(device)
    traces = spec.traces()
    knobs = spec.knob_arrays()
    n = scenario_device_count(spec.size, world_size())
    # pad an indivisible batch with copies of the last scenario (dropped
    # from the results): copies finish with their original, and the
    # scenarios are independent, so the results do not change
    pad = (-spec.size) % n
    if pad:
        traces = np.concatenate([traces, np.repeat(traces[-1:], pad, 0)])
        knobs = tuple(np.concatenate([a, np.repeat(a[-1:], pad, 0)])
                      for a in knobs)
    per = (spec.size + pad) // n
    mine = slice(rank() * per, (rank() + 1) * per)
    out: List[Dict[str, int]] = []
    if rank() < n:
        s = init_state(cfg, traces[mine], dev)
        mig, thr, cen, eja = (torch.as_tensor(a[mine], device=dev)
                              for a in knobs)
        s = s._replace(knob_mig=mig, knob_mig_thr=thr, knob_central=cen,
                       knob_ej_age=eja)
        s, aux = _drive(s, cfg, max_cycles or cfg.max_cycles, chunk)
        out = stats_list(s, aux)
    if world_size() > 1:
        parts: List = [None] * world_size()
        dist.all_gather_object(parts, out)
        out = [d for p in parts for d in p][:spec.size]
    return out


def run_sequential(spec: SweepSpec, max_cycles: Optional[int] = None,
                   chunk: int = 1, device=None) -> List[Dict[str, int]]:
    """Reference path: one solo ``run()`` per scenario, on the padded
    trace of the stacked block.  Used by the bit-exactness tests."""
    spec.validate()
    traces = spec.traces()
    return [run(sc.resolve_cfg(spec.cfg), traces[b], max_cycles, chunk,
                device=device)
            for b, sc in enumerate(spec.scenarios)]
