"""Execution-plan layer: one planner in front of every simulator run.

A *plan* turns a heterogeneous list of :class:`Scenario` — any mix of mesh
shapes, apps, seeds and policy knobs — into the fewest batched runs:

1. **Bucket** scenarios by structural configuration: everything that
   changes array shapes (mesh shape, cache geometry, latencies, directory
   layout, queue/ROB depths, cycle budget).  Policy knobs (migration
   on/off, migrate threshold, centralized vs distributed directory, the
   ejection age threshold) are per-scenario state in the batched driver
   (``SimState.knob_*``), so they never split a bucket — scenarios that
   differ only in workload or knobs share ONE batched state.
2. **Choose a backend per bucket** with a cost model over
   ``(batch, nodes, devices)``:

   * ``sweep`` — the batched driver (:mod:`repro_torch.core.sweep`).  A
     batch of one is the classic solo run.
   * ``sharded`` — a 2-D spatial decomposition of one huge scenario's
     node grid over devices (:func:`choose_tiling`); on one device, or
     when no factoring divides the mesh, the plan falls back to ``sweep``.
   * ``composed`` — both axes at once, a ``(scenario, rows, cols)``
     device grid (:func:`choose_grid`).

3. **Execute** buckets one after another and reassemble per-scenario
   statistics in the original scenario order — bit-identical to running
   each scenario through a solo :func:`repro_torch.core.sim.run`.

A copy of the JAX package's ``repro.core.engine``: the planner (buckets,
costs, notes, memory budget, :meth:`ExecutionPlan.describe`) gives the
same plans for the same device count, and the same ``REPRO_COST_MODEL``
calibration file serves both packages.  What differs:

* A device is a rank: :func:`compile_plan` defaults ``ndev`` to
  :func:`run_devices`, the size of the default ``torch.distributed``
  process group (1 without one; ``RUN_DEVICES`` reads it too).  An
  explicit ``ndev`` plans exactly as the JAX package does,
  ``sharded``/``composed`` choices and fall-back notes included.
* :func:`execute_plan` runs each bucket on the ranks of the group (every
  rank must call it; :mod:`repro_torch.core.sharded` for the spatial and
  composed backends, the sweep's scenario split for ``sweep``), each
  rank on its own ``device``; a bucket planned for more ranks than the
  group has runs on the sweep backend, as the JAX package's does when
  its process has too few devices.
* The cost constants are the JAX package's CPU-calibrated defaults.
  They were never fitted to a GPU, so the backend a plan picks on the
  card means nothing until a calibration file from a GPU run exists
  (``REPRO_COST_MODEL``).
* The JAX package's ``expose_host_devices`` (which widens XLA's host
  device list before JAX is imported) has no meaning in torch and is
  left out.

Manifests: :func:`load_manifest` accepts a JSON object/list (or a path to
one), or the compact CLI grammar ``ROWSxCOLS[:APP][:SEED[:REFS]]`` joined
with ``;`` or ``,`` — APP is any workload-registry source spec
(``matmul``, ``loop:matmul``, ``hotspot:frac=0.8,hot=2``, ...)::

    {"base": {"addr_bits": 16, "centralized_directory": false},
     "scenarios": [
       {"rows": 8,  "cols": 8,  "app": "matmul", "seed": 0, "refs_per_core": 50},
       {"rows": 16, "cols": 16, "app": "equake", "seed": 1,
        "migration_enabled": false}]}
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple, Union

from .config import CacheConfig, SimConfig
from .workloads import source_summary, valid_source

__all__ = [
    "Scenario", "Bucket", "ExecutionPlan", "make_scenario", "bucket_key",
    "choose_tiling", "choose_grid", "backend_cost", "choose_backend",
    "compile_plan", "execute_plan", "plan_and_run", "load_manifest",
    "CostConstants", "cost_constants",
    "set_cost_constants", "load_cost_constants", "save_cost_constants",
    "parse_mem_budget", "plan_state_bytes", "run_devices",
]


#: SimConfig fields carried as per-scenario state by the batched driver
#: (SimState.knob_*) — these never force a new bucket.
#: ``eject_age_threshold`` is one (a per-flit comparison constant);
#: ``pc_depth`` is NOT — it sizes the pending-completion queue array, so
#: it is structural and splits buckets like every other shape knob.
KNOB_FIELDS = ("migration_enabled", "migrate_threshold",
               "centralized_directory", "eject_age_threshold")
_KNOB_NORM = dict(migration_enabled=True, migrate_threshold=3,
                  centralized_directory=False, eject_age_threshold=0)


def run_devices() -> int:
    """Devices a run uses: the ranks of the default ``torch.distributed``
    process group, or 1 without one.  Imports no torch: a process that
    has not imported ``torch.distributed`` has no group."""
    d = sys.modules.get("torch.distributed")
    if d is None or not d.is_available() or not d.is_initialized():
        return 1
    return d.get_world_size()


def __getattr__(name: str):
    # RUN_DEVICES follows the process group (run_devices())
    if name == "RUN_DEVICES":
        return run_devices()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


@dataclasses.dataclass(frozen=True)
class CostConstants:
    """Cost-model constants: driver work per simulated cycle, node-units.

    The defaults are the JAX package's CPU-calibrated guesses, never
    fitted to a GPU: on the card the backend they pick means nothing
    until a calibration exists.  A JSON file
    of calibrated values (the JAX package's calibration emits one) is
    loaded by :func:`load_cost_constants`, or automatically from the path
    in ``$REPRO_COST_MODEL`` at import.

    Attributes:
        halo_overhead: relative per-node cost of a sharded tile vs the
            dense single-device step (the halo exchange and the
            termination reduction), multiplying the tile's bandwidth
            term.
        shard_fixed: fixed per-cycle cost of the spatial backend's
            collectives (latency-bound, independent of tile size) —
            keeps small meshes off the spatial backend.
        batch_fixed: the composed backend's incremental fixed per-cycle
            cost for each *additional* local scenario stepped through a
            spatially-sharded tile: the halo slabs still ride one
            exchange per direction, but every extra scenario adds its
            own slab payload to those fixed-latency collectives.  This is
            what makes the planner prefer sharding the scenario axis
            (which needs no collectives) over deeper spatial tiling when
            the devices could do either.
    """

    halo_overhead: float = 1.25
    shard_fixed: float = 4096.0
    batch_fixed: float = 1024.0


_COST = CostConstants()


def cost_constants() -> CostConstants:
    """The cost-model constants currently in force."""
    return _COST


def set_cost_constants(c: CostConstants) -> None:
    """Install ``c`` as the constants used by :func:`backend_cost` (and
    therefore every subsequent :func:`compile_plan`)."""
    global _COST
    _COST = c


def load_cost_constants(path: str) -> CostConstants:
    """Load calibrated constants from a JSON file (the JAX package's
    calibration writes the same format) and install them.

    The file must hold an object with ``halo_overhead`` /
    ``shard_fixed`` / ``batch_fixed`` keys; anything else (calibration
    metadata) is ignored.  Returns the installed :class:`CostConstants`.
    """
    with open(path) as f:
        obj = json.load(f)
    c = CostConstants(**{k: float(obj[k])
                         for k in ("halo_overhead", "shard_fixed",
                                   "batch_fixed") if k in obj})
    set_cost_constants(c)
    return c


def save_cost_constants(path: str, c: CostConstants,
                        meta: Optional[Dict] = None) -> None:
    """Write ``c`` (plus optional calibration ``meta``) as a JSON file
    round-trippable through :func:`load_cost_constants`."""
    obj = dataclasses.asdict(c)
    if meta:
        obj["meta"] = meta
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
        f.write("\n")


if os.environ.get("REPRO_COST_MODEL"):
    load_cost_constants(os.environ["REPRO_COST_MODEL"])


# ---------------------------------------------------------------------------
# Memory model
# ---------------------------------------------------------------------------

_MEM_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}


def parse_mem_budget(text: Optional[str]) -> Optional[int]:
    """Parse a per-device memory budget: a byte count, optionally with a
    binary suffix (``512M``, ``4G``, ``1.5g``).  ``None``/empty → no
    budget."""
    if text is None or not str(text).strip():
        return None
    t = str(text).strip().lower().rstrip("b").rstrip("i")
    mul = 1
    if t and t[-1] in _MEM_SUFFIX:
        mul = _MEM_SUFFIX[t[-1]]
        t = t[:-1]
    try:
        val = int(float(t) * mul)
    except ValueError:
        raise ValueError(f"bad memory budget {text!r}; expected bytes with "
                         "an optional K/M/G/T suffix, e.g. '512M'") from None
    if val <= 0:
        raise ValueError(f"memory budget must be positive, got {text!r}")
    return val


def plan_state_bytes(cfg: SimConfig, batch: int, backend: str,
                     grid: Tuple[int, int, int], ndev: int,
                     trace_len: int = 200) -> int:
    """Estimated *resident* :class:`SimState` bytes per device for one
    bucket under ``backend``/``grid``.

    This counts the persistent simulation state only (at ``cfg``'s
    ``state_dtype_policy``); per-cycle transients ride on top, so treat
    budgets as a floor on what the device must hold, not an exact
    high-water mark."""
    from .state import state_bytes
    sb = state_bytes(cfg, trace_len=trace_len)
    if backend == "sweep":
        from .sweep import scenario_device_count
        n = scenario_device_count(batch, ndev)
        return -(-batch // n) * sb
    if backend in ("sharded", "composed"):
        nt = grid[-2] * grid[-1]
        local_b = -(-batch // max(grid[0], 1)) if backend == "composed" else 1
        return -(-local_b * sb // max(nt, 1))
    raise ValueError(f"unknown backend {backend!r}")


def _fmt_bytes(n: int) -> str:
    for suf, mul in (("G", 1 << 30), ("M", 1 << 20), ("K", 1 << 10)):
        if n >= mul:
            return f"{n / mul:.1f}{suf}"
    return f"{n}B"


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One unit of work for the planner: a fully-resolved config plus a
    workload.

    Attributes:
        cfg: the scenario's complete :class:`SimConfig`, *including*
            policy knobs — the planner decides what is structural (splits
            buckets) and what rides as per-scenario ``SimState.knob_*``
            state.
        app: workload source spec, dispatched through the traffic-
            generator registry (:mod:`repro_torch.core.workloads`): an app
            model (``matmul``/``apsi``/``mgrid``/``wupwise``/``equake``),
            ``random``, ``loop:<app>`` (the historical per-node-loop
            reference generator), or a synthetic NoC pattern with
            optional parameters (``transpose``, ``bitcomp``,
            ``hotspot:frac=0.8,hot=2``, ``tornado``, ``neighbor:rate=0.5``).
        seed: trace-synthesis seed.
        refs_per_core: memory references each core issues; the synthesized
            trace is ``(cfg.num_nodes, refs_per_core)`` int32 addresses.
    """

    cfg: SimConfig
    app: str = "matmul"            # trace source (workloads registry spec)
    seed: int = 0
    refs_per_core: int = 200

    def validate(self) -> None:
        """Raise ``ValueError``/``AssertionError`` on an invalid config,
        unknown app name, or non-positive refs_per_core."""
        self.cfg.validate()
        if not valid_source(self.app):
            # re-parse to surface the specific parse error (unknown
            # generator vs bad parameter) with the registry roll-call
            from .workloads import parse_source
            try:
                parse_source(self.app)
            except ValueError as e:
                raise ValueError(f"bad scenario app: {e}") from None
        if self.refs_per_core < 1:
            raise ValueError("refs_per_core must be >= 1")


def make_scenario(base: SimConfig, rows: Optional[int] = None,
                  cols: Optional[int] = None, app: str = "matmul",
                  seed: int = 0, refs_per_core: int = 200,
                  **overrides) -> Scenario:
    """Scenario constructor: ``base`` config + shape + any SimConfig
    overrides (structural or knob — the planner sorts out which).

    Args:
        base: the config every non-overridden field comes from.
        rows: mesh rows override (default: ``base.rows``).
        cols: mesh columns override (default: ``base.cols``).
        app: workload source spec (registry grammar).
        seed: trace-synthesis seed.
        refs_per_core: memory references per core.
        **overrides: any further SimConfig field overrides.
    """
    kw = dict(overrides)
    if rows is not None:
        kw["rows"] = rows
    if cols is not None:
        kw["cols"] = cols
    cfg = dataclasses.replace(base, **kw) if kw else base
    return Scenario(cfg=cfg, app=app, seed=seed, refs_per_core=refs_per_core)


def bucket_key(cfg: SimConfig) -> SimConfig:
    """Structural identity of a config: the config with every policy knob
    normalized away.  Two scenarios with equal keys share one batched
    run."""
    return dataclasses.replace(cfg, **_KNOB_NORM)


def choose_tiling(rows: int, cols: int, ndev: int) -> Tuple[int, int]:
    """Factor the device count into a ``(row_tiles, col_tiles)`` grid that
    divides the simulated mesh, using as many devices as possible and
    preferring near-square tilings (halo perimeter ~ rt+ct).  Returns
    ``(1, 1)`` when nothing but a single device fits — the planner then
    falls back to the dense backend instead of asserting."""
    best = (1, 1)
    for d in range(min(ndev, rows * cols), 1, -1):
        cands = [(rt, d // rt) for rt in range(1, d + 1)
                 if d % rt == 0 and rows % rt == 0 and cols % (d // rt) == 0]
        if cands:
            return min(cands, key=lambda t: abs(t[0] - t[1]))
    return best


def backend_cost(backend: str, batch: int, nodes: int, ndev: int,
                 tiles: Union[Tuple[int, int], Tuple[int, int, int]] = (1, 1)
                 ) -> float:
    """Estimated driver work per simulated cycle, in node-units on the
    critical path (lower is better).

    Args:
        backend: ``"sweep"`` | ``"sharded"`` | ``"composed"``.
        batch: scenarios in the bucket.
        nodes: simulated nodes per scenario (``rows * cols``).
        ndev: devices the plan may use.
        tiles: ``(row_tiles, col_tiles)`` for ``sharded``;
            ``(batch_shards, row_tiles, col_tiles)`` for ``composed``
            (a 2-tuple is treated as ``batch_shards = 1``).

    Returns: the estimated cost; ``inf`` for a structurally impossible
    combination (e.g. ``sharded`` with ``batch > 1``)."""
    c = _COST
    if backend == "sweep":
        # deferred import: sweep pulls in torch, which planning otherwise
        # never needs
        from .sweep import scenario_device_count
        # run_sweep pads the batch to a multiple of the device count, so
        # wall-clock work is ceil(batch / devices) scenario-steps
        n = scenario_device_count(batch, ndev)
        return nodes * -(-batch // n)
    if backend == "sharded":
        nt = tiles[-2] * tiles[-1]
        if batch != 1 or nt <= 1:
            return float("inf")
        return nodes / nt * c.halo_overhead + c.shard_fixed
    if backend == "composed":
        bs = tiles[0] if len(tiles) == 3 else 1
        nt = tiles[-2] * tiles[-1]
        if nt <= 1 or bs < 1:
            return float("inf")
        # each device carries ceil(batch / batch_shards) scenarios, all
        # stepped through one tile; the four halo exchanges are paid
        # once per cycle (batched slabs), so the bandwidth term scales
        # with the local batch and each extra local scenario adds only
        # its slab payload (batch_fixed) to the fixed collectives
        local_b = -(-batch // min(bs, batch))
        return (local_b * nodes / nt * c.halo_overhead + c.shard_fixed
                + (local_b - 1) * c.batch_fixed)
    raise ValueError(f"unknown backend {backend!r}")


def choose_grid(batch: int, rows: int, cols: int, ndev: int,
                cfg: Optional[SimConfig] = None,
                mem_budget: Optional[int] = None, trace_len: int = 200
                ) -> Tuple[Tuple[int, int, int], float]:
    """Factor ``ndev`` into the cheapest composed ``(batch_shards,
    row_tiles, col_tiles)`` grid for a ``batch``-scenario bucket of
    ``rows x cols`` meshes.

    Every split of the device count between the scenario axis and the
    spatial tiling (``choose_tiling`` on the remainder) is costed with
    :func:`backend_cost`; grids whose spatial part collapses to ``1x1``
    are skipped (that regime belongs to the sweep backend).  With a
    ``mem_budget`` (and ``cfg`` to size the state), grids whose
    per-device resident state exceeds the budget are skipped too — the
    planner re-tiles toward deeper spatial splits that fit.

    Returns: ``(grid, cost)``; ``((1, 1, 1), inf)`` when no composed
    grid is structurally possible (or none fits the budget)."""
    best, best_cost = (1, 1, 1), float("inf")
    nodes = rows * cols
    for bs in range(1, max(min(ndev, batch), 1) + 1):
        rt, ct = choose_tiling(rows, cols, ndev // bs)
        if rt * ct <= 1:
            continue
        grid = (bs, rt, ct)
        if mem_budget is not None and cfg is not None and \
                plan_state_bytes(cfg, batch, "composed", grid, ndev,
                                 trace_len) > mem_budget:
            continue
        cost = backend_cost("composed", batch, nodes, ndev, grid)
        if cost < best_cost:
            best, best_cost = grid, cost
    return best, best_cost


#: 3-D grid meaning per backend: sweep ignores it, sharded uses the
#: spatial part, composed uses all three axes.
_GRID_NONE = (1, 1, 1)


def choose_backend(cfg: SimConfig, batch: int, ndev: int,
                   force: Optional[str] = None,
                   mem_budget: Optional[int] = None, trace_len: int = 200
                   ) -> Tuple[str, Tuple[int, int, int], str]:
    """Pick ``(backend, grid, note)`` for one bucket.

    Args:
        cfg: the bucket's structural config (with ``centralized_directory``
            reflecting whether *any* scenario in the bucket uses it —
            such buckets can never shard spatially).
        batch: scenarios in the bucket.
        ndev: devices available to the plan.
        force: pin the backend (CLI ``--backend``); a forced ``sharded``
            or ``composed`` that is structurally impossible (one device,
            centralized directory, an indivisible mesh, or — for
            ``sharded`` — ``batch > 1``) degrades to ``sweep`` with an
            explanatory note instead of asserting.
        mem_budget: per-device resident-state byte budget.  Candidates
            over budget are dropped (composed re-tiles toward deeper
            spatial splits first); if *no* candidate fits, or a forced
            backend is over budget, ``ValueError`` — the fix is a packed
            ``state_dtype_policy``, more devices, or a bigger budget.
        trace_len: per-core trace length, for sizing the state.

    Returns: the backend name, its ``(batch_shards, row_tiles,
    col_tiles)`` device grid (``(1, 1, 1)`` for sweep), and a short
    explanation when the choice was forced, degraded, cost-driven, or
    shaped by the memory budget."""
    tiles = choose_tiling(cfg.rows, cfg.cols, ndev)
    spatial_ok = not cfg.centralized_directory and tiles != (1, 1)
    grid, c_comp = (choose_grid(batch, cfg.rows, cfg.cols, ndev, cfg=cfg,
                                mem_budget=mem_budget, trace_len=trace_len)
                    if not cfg.centralized_directory
                    else (_GRID_NONE, float("inf")))

    def fits(backend: str, g: Tuple[int, int, int]) -> bool:
        return mem_budget is None or plan_state_bytes(
            cfg, batch, backend, g, ndev, trace_len) <= mem_budget

    def over_budget(backend: str, g: Tuple[int, int, int]) -> ValueError:
        need = plan_state_bytes(cfg, batch, backend, g, ndev, trace_len)
        return ValueError(
            f"{backend} backend needs ~{_fmt_bytes(need)}/device for "
            f"{batch}x{cfg.rows}x{cfg.cols} "
            f"({cfg.state_dtype_policy} state), over the "
            f"{_fmt_bytes(mem_budget)} budget; use state_dtype_policy="
            "'packed', more devices, or a larger budget")

    if force == "sweep":
        if not fits("sweep", _GRID_NONE):
            raise over_budget("sweep", _GRID_NONE)
        return "sweep", _GRID_NONE, "forced"
    if force == "sharded":
        if batch == 1 and spatial_ok:
            if not fits("sharded", (1,) + tiles):
                raise over_budget("sharded", (1,) + tiles)
            return "sharded", (1,) + tiles, "forced"
        why = ("batch > 1" if batch > 1
               else "centralized directory" if cfg.centralized_directory
               else f"no device tiling divides {cfg.rows}x{cfg.cols} "
                    f"over {ndev} device(s)")
        if not fits("sweep", _GRID_NONE):
            raise over_budget("sweep", _GRID_NONE)
        return "sweep", _GRID_NONE, f"sharded unavailable ({why}); fell back"
    if force == "composed":
        if c_comp < float("inf"):
            return "composed", grid, "forced"
        why = ("centralized directory" if cfg.centralized_directory
               else f"no device grid tiles {cfg.rows}x{cfg.cols} over "
                    f"{ndev} device(s)")
        if not fits("sweep", _GRID_NONE):
            raise over_budget("sweep", _GRID_NONE)
        return "sweep", _GRID_NONE, f"composed unavailable ({why}); fell back"
    if force is not None:
        raise ValueError(f"unknown backend {force!r}")
    c_sweep = backend_cost("sweep", batch, cfg.num_nodes, ndev)
    cands = [(c_sweep, "sweep", _GRID_NONE)]
    if batch == 1 and spatial_ok:
        cands.append((backend_cost("sharded", batch, cfg.num_nodes, ndev,
                                   tiles), "sharded", (1,) + tiles))
    if batch > 1:
        # batch == 1 composed degenerates to sharded — already a candidate
        cands.append((c_comp, "composed", grid))
    dropped = [b for c, b, g in cands
               if c < float("inf") and not fits(b, g)]
    cands = [(c, b, g) for c, b, g in cands if fits(b, g)]
    if not cands or min(c for c, _, _ in cands) == float("inf"):
        raise over_budget("sweep", _GRID_NONE)
    cost, backend, grid = min(cands, key=lambda t: t[0])
    note = "" if backend == "sweep" \
        else f"cost {cost:.0f} < sweep {c_sweep:.0f}"
    if dropped:
        over = f"memory budget excluded {'/'.join(dropped)}"
        note = f"{note}; {over}" if note else over
    return backend, grid, note


@dataclasses.dataclass(frozen=True)
class Bucket:
    """Scenarios sharing one structural config → one batched run.

    Attributes:
        cfg: the structural (knob-normalized) config every scenario in
            the bucket shares.
        scenarios: the bucket's scenarios, in input order.
        indices: each scenario's position in the original plan list.
        backend: ``"sweep"`` | ``"sharded"`` | ``"composed"``.
        grid: the ``(batch_shards, row_tiles, col_tiles)`` device grid —
            ``(1, 1, 1)`` for sweep, ``(1, rt, ct)`` for sharded.
        note: why the planner chose/degraded this backend (may be empty).
        mem_bytes: estimated resident state bytes per device
            (:func:`plan_state_bytes`; 0 when not computed).
    """

    cfg: SimConfig                     # structural (knob-normalized) config
    scenarios: Tuple[Scenario, ...]
    indices: Tuple[int, ...]           # positions in the original list
    backend: str                       # "sweep" | "sharded" | "composed"
    grid: Tuple[int, int, int] = (1, 1, 1)
    note: str = ""
    mem_bytes: int = 0                 # est. resident state bytes / device

    @property
    def batch(self) -> int:
        return len(self.scenarios)

    @property
    def tiles(self) -> Tuple[int, int]:
        """The spatial ``(row_tiles, col_tiles)`` part of :attr:`grid`."""
        return self.grid[1:]

    @property
    def devices_needed(self) -> int:
        """Devices this bucket's run is laid out over."""
        return self.grid[0] * self.grid[1] * self.grid[2]


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """A compiled plan: the input scenarios, their buckets (one batched
    run each) and the device count the plan was costed for."""

    scenarios: Tuple[Scenario, ...]
    buckets: Tuple[Bucket, ...]
    ndev: int
    mem_budget: Optional[int] = None

    def describe(self) -> Dict:
        """JSON-friendly summary: shape/batch/backend/grid per bucket,
        plus each bucket's state-dtype policy and estimated resident
        state bytes per device (and the budget they were planned
        against, when one was set)."""
        return {
            "n_scenarios": len(self.scenarios),
            "n_buckets": len(self.buckets),
            "devices": self.ndev,
            **({"mem_budget": self.mem_budget}
               if self.mem_budget is not None else {}),
            "buckets": [{
                "rows": b.cfg.rows, "cols": b.cfg.cols, "batch": b.batch,
                "backend": b.backend,
                "policy": b.cfg.state_dtype_policy,
                "state_bytes_per_device": b.mem_bytes,
                **({"tiles": list(b.tiles)} if b.backend == "sharded" else {}),
                **({"grid": list(b.grid)} if b.backend == "composed" else {}),
                **({"note": b.note} if b.note else {}),
            } for b in self.buckets],
        }


def compile_plan(scenarios: Sequence[Scenario], ndev: Optional[int] = None,
                 force_backend: Optional[str] = None,
                 mem_budget: Optional[int] = None) -> ExecutionPlan:
    """Bucket scenarios by structural config and choose each bucket's
    backend and device grid.

    Args:
        scenarios: the work list — any mix of mesh shapes, apps, seeds
            and policy knobs.  Scenarios differing only in workload or
            knobs share a bucket (ONE batched run).
        ndev: device count to cost the plan for; defaults to
            :func:`run_devices`, the ranks :func:`execute_plan` runs on.
        force_backend: pin every bucket to ``"sweep"`` / ``"sharded"`` /
            ``"composed"``; impossible pins degrade per bucket with a
            note (see :func:`choose_backend`).
        mem_budget: per-device resident-state byte budget; defaults to
            ``$REPRO_MEM_BUDGET`` (``parse_mem_budget`` grammar, e.g.
            ``512M``).  Buckets that cannot fit under any backend raise
            ``ValueError`` (see :func:`choose_backend`).

    Returns: an :class:`ExecutionPlan`.  Deterministic: bucket order
    follows first appearance in ``scenarios``; per-bucket scenario order
    follows the input order."""
    if not scenarios:
        raise ValueError("empty plan")
    for sc in scenarios:
        sc.validate()
    if ndev is None:
        ndev = run_devices()
    if mem_budget is None:
        mem_budget = parse_mem_budget(os.environ.get("REPRO_MEM_BUDGET"))

    groups: Dict[SimConfig, List[int]] = {}
    for i, sc in enumerate(scenarios):
        groups.setdefault(bucket_key(sc.cfg), []).append(i)

    buckets = []
    for key, idxs in groups.items():
        scs = tuple(scenarios[i] for i in idxs)
        # the knob check must see the *scenario* configs, not the
        # normalized key: forced-sharded/composed eligibility depends on
        # them (a centralized-directory scenario bars the home-sharded
        # directory layout both spatial backends require)
        any_central = any(sc.cfg.centralized_directory for sc in scs)
        probe = dataclasses.replace(key, centralized_directory=any_central)
        # the batched drivers stack traces padded to the longest, so the
        # footprint is sized by the bucket's largest refs_per_core
        refs = max(sc.refs_per_core for sc in scs)
        backend, grid, note = choose_backend(probe, len(scs), ndev,
                                             force_backend,
                                             mem_budget=mem_budget,
                                             trace_len=refs)
        mem = plan_state_bytes(key, len(scs), backend, grid, ndev, refs)
        buckets.append(Bucket(cfg=key, scenarios=scs, indices=tuple(idxs),
                              backend=backend, grid=grid, note=note,
                              mem_bytes=mem))
    return ExecutionPlan(tuple(scenarios), tuple(buckets), ndev, mem_budget)


def _bucket_sweep_spec(b: Bucket):
    from .sweep import ScenarioSpec, SweepSpec
    return SweepSpec(b.cfg, tuple(
        ScenarioSpec(
            app=sc.app, seed=sc.seed, refs_per_core=sc.refs_per_core,
            migration_enabled=sc.cfg.migration_enabled,
            migrate_threshold=sc.cfg.migrate_threshold,
            centralized_directory=sc.cfg.centralized_directory,
            eject_age_threshold=sc.cfg.eject_age_threshold,
        ) for sc in b.scenarios))


def _run_bucket_sweep(b: Bucket, max_cycles: Optional[int], chunk: int,
                      device) -> List[Dict[str, int]]:
    from .sweep import run_sweep
    return run_sweep(_bucket_sweep_spec(b), max_cycles=max_cycles,
                     chunk=chunk, device=device)


def _run_bucket_composed(b: Bucket, max_cycles: Optional[int],
                         sharded_chunk: int, device) -> List[Dict[str, int]]:
    from .sharded import run_composed
    return run_composed(_bucket_sweep_spec(b), b.grid, max_cycles=max_cycles,
                        chunk=sharded_chunk, device=device)


def _run_bucket_sharded(b: Bucket, max_cycles: Optional[int],
                        sharded_chunk: int, device) -> List[Dict[str, int]]:
    from .sharded import run_sharded
    from .workloads import resolve_trace
    (sc,) = b.scenarios
    cfg = dataclasses.replace(sc.cfg, dir_layout="home")
    tr = resolve_trace(cfg, sc.app, sc.refs_per_core, sc.seed)
    return [run_sharded(cfg, tr, (1,) + tuple(b.tiles), max_cycles,
                        sharded_chunk, device=device)]


def execute_plan(plan: ExecutionPlan, max_cycles: Optional[int] = None,
                 chunk: int = 8, sharded_chunk: int = 256, device=None
                 ) -> List[Dict[str, int]]:
    """Run every bucket of ``plan`` (one batched run each).

    Args:
        plan: the compiled plan.  A spatial/composed bucket runs on
            the first ranks of the process group; one planned for more
            ranks than the group has (:func:`run_devices`) runs on the
            sweep backend instead.  Every rank of the group must call
            it, and every rank gets every result.
        max_cycles: per-scenario cycle cap (default: each scenario's
            ``cfg.max_cycles``).
        chunk: sweep-backend cycles per termination check.
        sharded_chunk: sharded/composed-backend cycles per termination
            check.
        device: this rank's device: ``None`` (the current GPU),
            ``"cuda"``, ``"cuda:<i>"`` or ``"cpu"``.  Without a GPU only
            ``"cpu"`` runs.

    Returns: one statistics dict per scenario, in the original scenario
    order — bit-identical to solo :func:`repro_torch.core.sim.run` calls."""
    out: List[Optional[Dict[str, int]]] = [None] * len(plan.scenarios)
    for b in plan.buckets:
        if b.backend in ("sharded", "composed"):
            if run_devices() < b.devices_needed:
                res = _run_bucket_sweep(b, max_cycles, chunk, device)
            elif b.backend == "sharded":
                res = _run_bucket_sharded(b, max_cycles, sharded_chunk,
                                          device)
            else:
                res = _run_bucket_composed(b, max_cycles, sharded_chunk,
                                           device)
        else:
            res = _run_bucket_sweep(b, max_cycles, chunk, device)
        for i, r in zip(b.indices, res):
            out[i] = r
    return out  # type: ignore[return-value]


def plan_and_run(scenarios: Sequence[Scenario],
                 max_cycles: Optional[int] = None, chunk: int = 8,
                 force_backend: Optional[str] = None,
                 ndev: Optional[int] = None,
                 mem_budget: Optional[int] = None,
                 device=None) -> List[Dict[str, int]]:
    """Convenience: compile + execute in one call."""
    return execute_plan(compile_plan(scenarios, ndev, force_backend,
                                     mem_budget=mem_budget),
                        max_cycles=max_cycles, chunk=chunk, device=device)


# ---------------------------------------------------------------------------
# Manifests
# ---------------------------------------------------------------------------

_WORKLOAD_KEYS = ("app", "seed", "refs_per_core", "refs")


def _scenario_from_entry(entry: Dict, base: SimConfig) -> Scenario:
    e = dict(entry)
    app = e.pop("app", "matmul")
    seed = int(e.pop("seed", 0))
    refs_long = e.pop("refs_per_core", None)
    refs_short = e.pop("refs", None)
    if refs_long is not None and refs_short is not None:
        raise ValueError(f"scenario {entry} sets both 'refs_per_core' and "
                         "'refs'; use one")
    refs = int(refs_long if refs_long is not None
               else refs_short if refs_short is not None else 200)
    cache = e.pop("cache", None)
    if cache is not None:
        base = dataclasses.replace(base, cache=CacheConfig(**cache))
    bad = [k for k in e if k not in SimConfig.__dataclass_fields__]
    if bad:
        raise ValueError(f"unknown scenario key(s) {bad}; workload keys are "
                         f"{_WORKLOAD_KEYS}, everything else must be a "
                         f"SimConfig field")
    cfg = dataclasses.replace(base, **e) if e else base
    return Scenario(cfg=cfg, app=app, seed=seed, refs_per_core=refs)


_MESH_RE = re.compile(r"^\d+x\d+(?::|$)", re.IGNORECASE)


def _split_compact(text: str) -> List[str]:
    """Split a compact manifest into scenario items.  ``;`` always
    separates scenarios; ``,`` separates too, EXCEPT inside a source
    spec's parameter list (``hotspot:frac=0.8,hot=2``) — a comma
    fragment that does not start with ``ROWSxCOLS`` continues the
    previous item."""
    items: List[str] = []
    for semi in text.split(";"):
        open_item = False      # a ';' hard-closes the current item
        for frag in semi.split(","):
            frag = frag.strip()
            if not frag:
                continue
            if open_item and not _MESH_RE.match(frag):
                items[-1] += "," + frag
            else:
                items.append(frag)
                open_item = True
    return items


def _parse_compact(text: str, base: SimConfig) -> List[Scenario]:
    """``ROWSxCOLS[:APP][:SEED[:REFS]]`` items joined with ``;`` or ``,``.

    APP is any registry source spec and may itself contain ``:`` and
    ``,`` (``loop:matmul``, ``hotspot:frac=0.8,hot=2``): the mesh is
    parsed from the front, up to two trailing *integer* fields parse as
    SEED and REFS, and everything between is the source spec.  Spell
    source parameters ``key=val`` so they are never mistaken for
    SEED/REFS."""
    out = []
    for item in _split_compact(text):
        parts = item.split(":")
        try:
            rows, cols = (int(x) for x in parts[0].lower().split("x"))
        except ValueError:
            raise ValueError(
                f"bad compact scenario {item!r}; expected "
                "ROWSxCOLS[:APP][:SEED[:REFS]] (or a path to an existing "
                "JSON manifest)") from None
        mid = parts[1:]
        tail: List[int] = []
        while mid and len(tail) < 2 and re.fullmatch(r"-?\d+", mid[-1]):
            tail.insert(0, int(mid.pop()))
        app = ":".join(mid) if mid else "matmul"
        seed = tail[0] if tail else 0
        refs = tail[1] if len(tail) > 1 else 200
        if not valid_source(app):
            raise ValueError(f"compact scenario {item!r}: bad source "
                             f"{app!r}; {source_summary()}")
        out.append(make_scenario(base, rows, cols, app, seed, refs))
    if not out:
        raise ValueError("empty compact scenario list")
    return out


def load_manifest(src: Union[str, Dict, List],
                  base: Optional[SimConfig] = None) -> List[Scenario]:
    """Load scenarios from a manifest.

    ``src`` may be a dict (``{"base": {...}, "scenarios": [...]}``), a bare
    list of scenario dicts, a JSON string of either, a path to a JSON file,
    or the compact CLI grammar (see :func:`_parse_compact`)."""
    base = base or SimConfig()
    obj: Union[Dict, List]
    if isinstance(src, str):
        text = src.strip()
        if text.startswith("{") or text.startswith("["):
            obj = json.loads(text)
        elif os.path.exists(src):
            with open(src) as f:
                obj = json.load(f)
        elif text.endswith(".json") or os.sep in text:
            # clearly a file path, not the compact grammar: fail as one
            raise FileNotFoundError(f"manifest file not found: {src}")
        else:
            return _parse_compact(text, base)
    else:
        obj = src
    if isinstance(obj, list):
        obj = {"scenarios": obj}
    base_kw = dict(obj.get("base", {}))
    cache = base_kw.pop("cache", None)
    if cache is not None:
        base = dataclasses.replace(base, cache=CacheConfig(**cache))
    if base_kw:
        base = dataclasses.replace(base, **base_kw)
    entries = obj.get("scenarios")
    if not entries:
        raise ValueError("manifest has no scenarios")
    return [_scenario_from_entry(e, base) for e in entries]
