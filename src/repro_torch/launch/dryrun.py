"""Multi-pod dry run: trace rank 0 of every (arch x shape x mesh) cell.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch noc-sim --shape noc_1m --mesh multi

The counterpart of the JAX package's ``repro.launch.dryrun``, designed for
PyTorch.  The JAX package lowers and compiles each cell on 512 fake XLA
host devices and reads XLA's cost and memory analysis.  Here one process
plays rank 0 of the production mesh:

* the world is a fake process group (torch's ``"fake"`` backend over a
  ``FakeStore``, :func:`fake_world`) of 256 or 512 ranks, whose
  collectives return at once and move nothing;
* parameters, optimizer state, batch and cache are fake tensors
  (``FakeTensorMode``): shapes, dtypes and placements, no storage;
* the real step runs on them, through the DTensor code of
  :mod:`repro_torch.models`: ``make_train_step``, ``make_prefill_step``
  or ``make_serve_step`` with ``mesh=`` (the counterpart of
  ``_lower_lm``), or rank 0's tile of :mod:`repro_torch.core.sharded`
  for the simulator cells.

Per cell it records, under the JAX package's key names where the meaning
carries:

* ``flops``: the FLOPs of rank 0's own operations, by the formulas of
  ``torch.utils.flop_counter`` (``FlopCounterMode``'s registry: matmuls,
  convolutions, attention), counted in a dispatch mode that sees each
  DTensor operation's local computation (``FlopCounterMode`` itself
  would count the DTensor operation at its global shape);
* ``collective_bytes`` by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``, ``collective-permute``): each
  ``_c10d_functional`` or ``c10d`` operation sized by its result buffer,
  the JAX package's convention (the received volume for an all-gather);
  a point-to-point receive counts as a collective-permute.  On a CPU
  mesh DTensor performs an all-to-all as an all-gather and a slice, and
  it is counted as what ran; ``collective_max_bytes``, the largest one
  of each kind;
* ``mem``, per rank: ``argument``, the bytes of rank 0's local shards of
  the parameters, optimizer state and inputs (and cache), from the
  resolved specs (``argument_parts`` splits them); ``temp``, the peak of
  the bytes the step allocates and holds at once (its outputs among them
  once they exist), from ``torch.distributed._tools.mem_tracker.
  MemTracker``; ``output``, the bytes of rank 0's local outputs.  XLA's
  ``alias`` and ``code`` have no meaning for an eager program and are
  left out;
* the analytic figures of :mod:`repro_torch.models.costs`, the parameter
  counts, the tokens and the kind;
* ``trace_s`` (in place of ``lower_s``/``compile_s``): the seconds of
  the measured pass.  The step runs twice: DTensor propagates a sharding
  the first time it meets an operation and shape, and runs extra
  operations on fake tensors to do it, so only the second pass is
  measured (``warmup_s`` is the first).

No layer probes: the JAX package probes 1-4 layer models
(``_probe_plan``/``_extrapolate``) because XLA's cost analysis counts a
scanned layer body once.  Eager tracing runs every layer, so
``corrected`` equals the measured figures.

What runs is the port's own path on a CPU mesh of fake tensors, so each
kernel takes its plain version (the wrappers choose by device): a
prefill's attention is K2's plain version (``attention_ref``), whose
(B, H, S, T) scores count in ``temp`` and its FLOPs in ``flops`` where
the kernel keeps them on chip and skips the masked half; a simulator
cell's Phase 2 is the fused kernel's plain version.  Nothing is
launched.  A decode cell runs ``make_serve_step(mesh=)``, split as the
JAX package's decode cell splits it: the weights as ``param_pspecs``
places them (gathered over the data axes at each use, never over the
model axis), the cache as ``cache_pspecs`` places it.  A cell with
``mesh=None`` traces one device's step (no process group, no DTensor).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import registry
from repro_torch.configs.shapes import SHAPES, ShapeSpec, applicable
from repro_torch.launch.mesh import PRODUCTION

# NoC-simulator cells: simulated router grid sizes (paper max = 43k cores;
# the sharded simulator goes to 16.7M)
NOC_SHAPES = {
    "noc_43k": (256, 256),       # >= the paper's 43,000-core maximum
    "noc_1m": (1024, 1024),
    "noc_16m": (4096, 4096),
}
#: references per core (the paper's M) and cycles per traced call
NOC_REFS, NOC_CYCLES = 200, 8

KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")


# ---------------------------------------------------------------------------
# the fake world and what is measured in it
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of ``size`` ranks, this process rank 0, as
    the default group for the duration (torch's ``"fake"`` backend:
    collectives return at once and move nothing).  Refuses to replace a
    process group that exists."""
    import torch.distributed as dist
    # registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group exists: the dry run makes its "
                           "own fake one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(size))
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_tensors():
    """The fake-tensor mode the cells run in.  Real tensors met inside
    (the mesh's rank map, numpy constants) become fake.  On exit the
    port's ``functools.lru_cache`` tables are emptied: the simulator
    keeps constant tensors per device in them, and one made in here is
    fake."""
    import sys
    from torch._subclasses.fake_tensor import FakeTensorMode

    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            yield mode
    finally:
        for name, mod in list(sys.modules.items()):
            if name.split(".")[0] == "repro_torch":
                for obj in vars(mod).values():
                    if callable(getattr(obj, "cache_clear", None)):
                        obj.cache_clear()


def _collective_table() -> Dict[Any, Tuple[str, bool]]:
    """Each collective operation's packet -> (its kind, whether its
    result is its return value: the functional operations return it,
    ``c10d``'s write into their first argument)."""
    f, c = torch.ops._c10d_functional, torch.ops.c10d
    names = {
        "all-gather": ((f, "all_gather_into_tensor"),
                       (f, "all_gather_into_tensor_coalesced"),
                       (c, "allgather_"), (c, "_allgather_base_"),
                       (c, "allgather_into_tensor_coalesced_")),
        "all-reduce": ((f, "all_reduce"), (f, "all_reduce_coalesced"),
                       (c, "allreduce_"), (c, "allreduce_coalesced_")),
        "reduce-scatter": ((f, "reduce_scatter_tensor"),
                           (f, "reduce_scatter_tensor_coalesced"),
                           (c, "reduce_scatter_"),
                           (c, "_reduce_scatter_base_"),
                           (c, "reduce_scatter_tensor_coalesced_")),
        "all-to-all": ((f, "all_to_all_single"), (c, "alltoall_"),
                       (c, "alltoall_base_")),
        "collective-permute": ((c, "recv_"),),
    }
    out = {}
    for kind, ops in names.items():
        for ns, name in ops:
            if hasattr(ns, name):
                out[getattr(ns, name)] = (kind, ns is f)
    return out


def _nbytes(tree) -> int:
    """Bytes of the tensors of a tree (a DTensor's local shard)."""
    total = 0
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


class Meter(TorchDispatchMode):
    """FLOPs and collective bytes of this rank's own operations, while
    entered: a dispatch mode below DTensor (it lets DTensor desugar each
    operation and sees the local ones).  ``flops`` sums the formulas of
    ``torch.utils.flop_counter``; ``collectives`` maps each kind to the
    bytes of the results, the received buffer of a point-to-point
    receive (the in-place ``c10d`` operations: their output buffers);
    ``largest`` the bytes of the largest single one of each kind."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.collectives: Dict[str, int] = {}
        self.largest: Dict[str, int] = {}
        self._table = _collective_table()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        pk = func._overloadpacket
        count = flop_registry.get(pk)
        if count is not None:
            self.flops += int(count(*args, **kwargs, out_val=out))
        if pk in self._table:
            kind, returned = self._table[pk]
            n = _nbytes(out if returned else args[0])
            self.collectives[kind] = self.collectives.get(kind, 0) + n
            self.largest[kind] = max(self.largest.get(kind, 0), n)
        return out


def measure(fn, warmup: bool) -> Tuple[Any, dict]:
    """Run ``fn()`` (inside a fake world and fake-tensor mode) and
    measure it: (its result, {"flops", "collective_bytes",
    "collective_max_bytes", "temp", "trace_s", "warmup_s"}).  With
    ``warmup`` it runs once unmeasured first (see the module
    docstring)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    warm_s = 0.0
    if warmup:
        t0 = time.perf_counter()
        fn()
        warm_s = time.perf_counter() - t0
    mt = MemTracker()
    t0 = time.perf_counter()
    with mt, Meter() as m:
        out = fn()
    secs = time.perf_counter() - t0
    peak = mt.get_tracker_snapshot("peak")
    temp = max((d["Total"] for d in peak.values()), default=0)
    return out, {"flops": float(m.flops),
                 "collective_bytes": dict(sorted(m.collectives.items())),
                 "collective_max_bytes": dict(sorted(m.largest.items())),
                 "temp": int(temp), "trace_s": round(secs, 3),
                 "warmup_s": round(warm_s, 3)}


def mesh_dims(mesh) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(dims, axes) of ``mesh``: "single" (16, 16) over ("data",
    "model"), "multi" (2, 16, 16) over ("pod", "data", "model"), a
    (dims, axes) pair, or ``None`` (one device, no mesh): ((), ())."""
    if mesh is None:
        return (), ()
    if mesh in ("single", "multi"):
        return PRODUCTION[mesh == "multi"]
    dims, axes = mesh
    return tuple(int(n) for n in dims), tuple(axes)


def _mesh_name(mesh) -> str:
    if mesh is None:
        return "one"
    if mesh in ("single", "multi"):
        return mesh
    return "x".join(map(str, mesh_dims(mesh)[0]))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

def _placed(tree, specs, mesh):
    """Whole (fake) tensors placed as DTensors by their resolved specs
    (left whole without a mesh)."""
    from repro_torch.parallel.sharding import (distribute, placements,
                                               resolve_pspec)
    from repro_torch.train.optim import tree_map

    if mesh is None:
        return tree

    def one(t, spec):
        spec = resolve_pspec(spec, mesh, t.shape)
        return distribute(t, mesh, placements(spec, mesh))
    return tree_map(one, tree, specs)


def _lm_step(cfg, shp: ShapeSpec, mesh):
    """(step function of no arguments, its argument parts' bytes): the
    real step of ``shp.kind`` on fake inputs placed on ``mesh``."""
    from repro_torch.models import api
    from repro_torch.parallel.sharding import P
    from repro_torch.train import optim, step

    params = api.init_params(cfg, 0, "cpu", mesh=mesh)
    parts = {"params": _nbytes(params)}
    b, s = shp.global_batch, shp.seq_len
    if shp.kind in ("train", "prefill"):
        batch = {k: torch.zeros(v.shape, dtype=v.dtype)
                 for k, v in api.input_specs(cfg, shp.kind, b, s).items()}
        batch = _placed(batch, {k: api.input_pspecs(cfg, shp.kind)[k]
                                for k in batch}, mesh)
    if shp.kind == "train":
        opt_cfg = optim.OptConfig()
        opt = optim.init_opt(opt_cfg, params)
        parts["opt_state"] = _nbytes(opt)
        parts["inputs"] = _nbytes(batch)
        fn = step.make_train_step(cfg, opt_cfg, "cpu", mesh)
        return (lambda: fn(params, opt, batch)), parts
    if shp.kind == "prefill":
        parts["inputs"] = _nbytes(batch)
        fn = step.make_prefill_step(cfg, "cpu", mesh)
        return (lambda: fn(params, batch)), parts
    cache = _placed(api.init_cache(cfg, b, s, "cpu"),
                    api.cache_pspecs(cfg, b, s), mesh)
    tokens = _placed({"t": torch.zeros((b, 1), dtype=torch.int32)},
                     {"t": P(api.DP, None)}, mesh)["t"]
    parts["cache"] = _nbytes(cache)
    parts["inputs"] = _nbytes(tokens)
    fn = step.make_serve_step(cfg, "cpu", mesh)
    return (lambda: fn(params, cache, tokens)), parts


def lm_cell(arch: str, shape, mesh="single", cfg=None) -> dict:
    """Trace rank 0 of one LM cell: ``arch`` (a registry id; ``cfg``
    overrides its config), ``shape`` (a name of :data:`SHAPES` or a
    :class:`ShapeSpec`) on ``mesh`` ("single", "multi" or (dims, axes)),
    in a fake world of the mesh's size; ``mesh=None`` traces the step of
    one device, with no process group and no DTensor.  Returns the
    record; an inapplicable cell's record is ``skipped`` with the
    rule's ``why``."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import costs

    cfg = cfg if cfg is not None else registry.get(arch)
    shp = SHAPES[shape] if isinstance(shape, str) else shape
    name = _mesh_name(mesh)
    ok, why = applicable(cfg.family, shp.name)
    if not ok:
        return {"arch": arch, "shape": shp.name, "mesh": name,
                "skipped": True, "why": why}
    dims, axes = mesh_dims(mesh)
    with fake_world(math.prod(dims)) if dims else contextlib.nullcontext():
        # the mesh holds real rank numbers: made before the fake mode
        dmesh = make_mesh(dims, axes, device="cpu") if dims else None
        with fake_tensors():
            fn, parts = _lm_step(cfg, shp, dmesh)
            # DTensor only: its first sharding propagation runs extra ops
            out, m = measure(fn, warmup=dmesh is not None)
            out_bytes = _nbytes(out)
    coll = m["collective_bytes"]
    res = {
        "arch": arch, "shape": shp.name, "mesh": name,
        "mesh_shape": list(dims), "mesh_axes": list(axes),
        "devices": math.prod(dims),
        "flops": m["flops"],
        "collective_bytes": coll,
        "collective_max_bytes": m["collective_max_bytes"],
        # eager tracing runs every layer: nothing to extrapolate
        "corrected": {"flops": m["flops"], "collective_bytes": coll},
        "analytic_flops_global": costs.cell_flops(
            cfg, shp.kind, shp.global_batch, shp.seq_len),
        "attn_hbm_topup_global": costs.attn_hbm_bytes(
            cfg, shp.kind, shp.global_batch, shp.seq_len),
        "mem": {"argument": sum(parts.values()), "output": out_bytes,
                "temp": m["temp"]},
        "argument_parts": parts,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
        "tokens": shp.global_batch * (shp.seq_len if shp.kind != "decode"
                                      else 1),
        "kind": shp.kind,
        "trace_s": m["trace_s"], "warmup_s": m["warmup_s"],
    }
    print(f"[dryrun] {arch} {shp.name} {name} OK flops={res['flops']:.3e} "
          f"temp/device={res['mem']['temp'] / 2**30:.2f}GiB "
          f"argument/device={res['mem']['argument'] / 2**30:.2f}GiB "
          f"trace={m['trace_s']:.1f}s", flush=True)
    return res


# ---------------------------------------------------------------------------
# NoC-simulator cells
# ---------------------------------------------------------------------------

def noc_cell(shape_name: str, mesh="single") -> dict:
    """Trace rank 0's tile of the sharded simulator (``ShardedSim``, one
    call of :data:`NOC_CYCLES` cycles) at a :data:`NOC_SHAPES` grid over
    ``mesh``'s ranks: the row axes ("pod", "data") tile the rows, "model"
    the columns."""
    from repro_torch.core.config import SimConfig
    from repro_torch.core.sharded import ProcessGrid, ShardedSim

    rows, cols = NOC_SHAPES[shape_name]
    cfg = SimConfig(rows=rows, cols=cols, addr_bits=24,
                    centralized_directory=False, dir_layout="home")
    dims, axes = mesh_dims(mesh)
    col_tiles = dims[axes.index("model")]
    row_tiles = math.prod(dims) // col_tiles
    # the whole trace as a zero-strided view: every rank's trace is the
    # same array, and nothing of its size is allocated
    trace = np.lib.stride_tricks.as_strided(
        np.zeros(1, np.int32), (cfg.num_nodes, NOC_REFS), (0, 0))
    with fake_world(math.prod(dims)), fake_tensors():
        grid = ProcessGrid(1, row_tiles, col_tiles)
        sim = ShardedSim(cfg, trace, grid, device="cpu")
        state_bytes = _nbytes(tuple(sim.states))
        ctx_bytes = _nbytes(tuple(sim.ctx))

        def call():
            sim.step(NOC_CYCLES)
            return tuple(sim.states)
        # no DTensor: nothing to propagate, so no warm-up pass
        out, m = measure(call, warmup=False)
        out_bytes = _nbytes(out)
    coll = m["collective_bytes"]
    res = {
        "arch": "noc-sim", "shape": shape_name, "mesh": _mesh_name(mesh),
        "mesh_shape": list(dims), "mesh_axes": list(axes),
        "devices": math.prod(dims),
        "sim_nodes": rows * cols, "tile": [rows // row_tiles,
                                           cols // col_tiles],
        "cycles_per_call": NOC_CYCLES, "refs_per_core": NOC_REFS,
        "flops": m["flops"],
        "collective_bytes": coll,
        "corrected": {"flops": m["flops"], "collective_bytes": coll},
        "mem": {"argument": state_bytes + ctx_bytes, "output": out_bytes,
                "temp": m["temp"]},
        "tile_state_bytes": state_bytes,
        "phase2": "the fused Phase-2 kernel's plain version "
                  "(kernels/ref.py phase2_router_ref) traced: nothing is "
                  "launched on fake tensors",
        "kind": "sim",
        "trace_s": m["trace_s"],
    }
    print(f"[dryrun] noc-sim {shape_name} {res['mesh']} OK "
          f"nodes={rows * cols} tile={res['tile']} "
          f"state/device={state_bytes / 2**20:.1f}MiB "
          f"trace={m['trace_s']:.1f}s", flush=True)
    return res


def run_cell(arch: str, shape: str, mesh="single") -> dict:
    if arch == "noc-sim":
        return noc_cell(shape, mesh)
    return lm_cell(arch, shape, mesh)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Dry run of rank 0 of the production mesh on a fake "
                    "process group with fake tensors (no device needed).")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)

    if args.all:
        cells = [(a, s, mk) for a in registry.ARCH_IDS for s in SHAPES
                 for mk in ("single", "multi")]
        cells += [("noc-sim", s, mk) for s in NOC_SHAPES
                  for mk in ("single", "multi")]
    else:
        if not (args.arch and args.shape):
            raise SystemExit("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape, args.mesh)]

    for a, s, mk in cells:
        path = outdir / f"{a}__{s}__{mk}.json"
        if args.skip_existing and path.exists():
            print(f"[dryrun] skip existing {path.name}")
            continue
        try:
            res = run_cell(a, s, mk)
        except Exception as e:  # record failures for triage
            res = {"arch": a, "shape": s, "mesh": mk, "error": repr(e)[:2000]}
            print(f"[dryrun] FAIL {a} {s} {mk}: {e}")
        path.write_text(json.dumps(res, indent=1))


if __name__ == "__main__":
    main()
