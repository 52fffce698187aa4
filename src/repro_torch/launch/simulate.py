"""NoC-simulation launcher of the PyTorch port (the paper's workload).

    PYTHONPATH=src python -m repro_torch.launch.simulate --rows 16 --cols 16 \\
        --app matmul --refs 100

Every mode (except ``--serial``) routes through the execution-plan layer
(:mod:`repro_torch.core.engine`): scenarios are bucketed by structural
config, each bucket runs as one batched state, and a cost model picks a
backend per bucket.  Run alone, the launcher uses one device, so a bucket
planned as sharded or composed runs on the sweep backend with a note.
Under ``torchrun`` every rank joins one process group and runs the plan
on its own device (``cuda:$LOCAL_RANK``, or ``--device``), the sharded
and composed backends tile the mesh over the ranks, and rank 0 alone
prints the result, with ``ranks`` (and, for a solo run, the bucket's
``grid``):
    torchrun --nproc-per-node 4 -m repro_torch.launch.simulate \
        --backend sharded --rows 64 --cols 64
    torchrun --nproc-per-node 4 -m repro_torch.launch.simulate \
        --backend sharded --rows 8 --cols 8 --device cpu
The group's backend is ``nccl`` on CUDA and ``gloo`` on the CPU;
``--dist-backend gloo`` lets several ranks share one card.

Batched multi-scenario sweep (one batched state for all scenarios):
    ... --sweep --apps matmul,equake,mgrid --seeds 0,1
Heterogeneous plan — mixed mesh shapes/apps/knobs from a manifest (a JSON
file, inline JSON, or the compact ROWSxCOLS[:APP][:SEED[:REFS]] grammar;
APP is any workload-registry source spec):
    ... --plan manifest.json
    ... --plan '8x8:matmul:0:50;16x16:equake:1:50'
Scenario zoo — run a registered family (repro_torch.core.zoo) end to end:
    ... --zoo patterns-small
    ... --zoo patterns-tiny:refs=8,seeds=0
    ... --zoo list
The serial golden model (numpy, no device), to check a run against:
    ... --serial --rows 4 --cols 4 --refs 12

Runs on the GPU unless ``--device cpu`` is given; without a GPU the
default fails rather than falling back to the CPU.  Prints the result as
JSON with the JAX launcher's keys (``repro.launch.simulate``), plus
``device`` and ``arbitration_kernel_launches`` (the launches of the
fused Phase-2 router kernel, which arbitrates, summed over the ranks) in
every planner mode.
On CUDA that kernel is the only Phase-2 route, so the JAX launcher's
``--pallas-router`` has no counterpart.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings

from repro_torch.core.workloads import source_summary

BACKENDS = ("auto", "sweep", "sharded", "composed")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.simulate",
        description="Bufferless-NoC simulator (PyTorch port): solo runs, "
                    "batched sweeps, heterogeneous execution plans and the "
                    "scenario zoo through the repro_torch.core.engine "
                    "planner, and the serial golden model; on the GPU, or "
                    "on the CPU with --device cpu.  The Phase-2 router runs "
                    "the hand-written CUDA kernel on the GPU and its plain "
                    "PyTorch version on the CPU (no switch).")
    ap.add_argument("--rows", type=int, default=16,
                    help="simulated mesh rows")
    ap.add_argument("--cols", type=int, default=16,
                    help="simulated mesh columns")
    ap.add_argument("--app", default="matmul",
                    help="workload source spec, dispatched through the "
                         "traffic-generator registry; " + source_summary())
    ap.add_argument("--refs", type=int, default=100,
                    help="memory references per core")
    ap.add_argument("--seed", type=int, default=0,
                    help="trace-synthesis seed")
    ap.add_argument("--centralized", action="store_true",
                    help="paper-default centralized directory (hot spot!)")
    ap.add_argument("--no-migration", action="store_true",
                    help="disable L2 block migration")
    ap.add_argument("--pc-depth", type=int, default=None,
                    help="pending-completion queue depth per node (default: "
                         "SimConfig.pc_depth); 1 = the paper's single S14 "
                         "completion register")
    ap.add_argument("--eject-age-threshold", type=int, default=None,
                    help="guaranteed-ejection age threshold (default: "
                         "SimConfig.eject_age_threshold)")
    ap.add_argument("--serial", action="store_true",
                    help="run the golden-model serial simulator (numpy) "
                         "instead of the planner")
    ap.add_argument("--backend", choices=BACKENDS, default="auto",
                    help="pin the planner's backend for every bucket: "
                         "'sweep' (batched scenarios), 'sharded' (one "
                         "scenario's mesh over devices), 'composed' "
                         "(scenarios x rows x cols over devices); 'auto' "
                         "lets the cost model choose.  Run alone the "
                         "launcher uses one device, so sharded and composed "
                         "degrade to sweep with a note; under torchrun they "
                         "run over the ranks")
    ap.add_argument("--sharded", action="store_true",
                    help="DEPRECATED legacy alias for --backend sharded "
                         "(emits a DeprecationWarning; will be removed)")
    ap.add_argument("--sweep", action="store_true",
                    help="batched sweep mode: run the --apps x --seeds "
                         "cross-product as one plan (default backend: "
                         "sweep; combine with --backend to override)")
    ap.add_argument("--plan", default=None, metavar="MANIFEST",
                    help="scenario manifest: JSON file path, inline JSON, or "
                         "compact 'ROWSxCOLS[:APP][:SEED[:REFS]];...' items "
                         "(APP = any registry source spec); mixed mesh "
                         "shapes allowed (repro_torch.core.engine)")
    ap.add_argument("--zoo", default=None, metavar="FAMILY",
                    help="run a registered scenario-zoo family "
                         "(repro_torch.core.zoo) through the planner: "
                         "'FAMILY' or 'FAMILY:refs=N,seeds=0+1,meshes=4x4+8x8'"
                         "; '--zoo list' prints the registered families and "
                         "exits")
    ap.add_argument("--apps", default=None,
                    help="comma list of apps for --sweep (default: --app)")
    ap.add_argument("--seeds", default=None,
                    help="comma list of seeds for --sweep (default: --seed)")
    ap.add_argument("--state-dtype", choices=("wide", "packed"),
                    default="wide",
                    help="SimState storage layout: 'wide' (every field "
                         "int32) or 'packed' (each field in the smallest "
                         "dtype its bounds allow; same results)")
    ap.add_argument("--mem-budget", default=None, metavar="BYTES",
                    help="per-device resident-state budget for the planner "
                         "(bytes, optional K/M/G/T suffix, e.g. '512M'; "
                         "default: $REPRO_MEM_BUDGET or unlimited); a plan "
                         "that cannot fit fails fast with the required "
                         "bytes in the error")
    ap.add_argument("--chunk", type=int, default=8,
                    help="simulated cycles per termination check")
    ap.add_argument("--max-cycles", type=int, default=200_000,
                    help="hard cycle cap per scenario")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (default; under "
                         "torchrun cuda:$LOCAL_RANK), 'cuda:<i>' or 'cpu'")
    ap.add_argument("--dist-backend", choices=("auto", "nccl", "gloo"),
                    default="auto",
                    help="under torchrun, the process group's backend: "
                         "'auto' (nccl on CUDA, gloo on the CPU), or name "
                         "one; gloo lets several ranks share one card")
    ap.add_argument("--json", default=None,
                    help="also write the result payload to this file")
    return ap


def _lead() -> bool:
    """Whether this process prints: rank 0 under torchrun, or alone."""
    return os.environ.get("RANK", "0") == "0"


def _emit(payload, path) -> None:
    print(json.dumps(payload, indent=1))
    if path:
        with open(path, "w") as f:
            json.dump(payload, f)


def main(argv=None) -> None:
    """Launcher entry point; ``argv`` defaults to ``sys.argv[1:]``."""
    ap = build_parser()
    args = ap.parse_args(argv)

    if args.sharded:
        warnings.warn(
            "--sharded is deprecated and will be removed; "
            "use --backend sharded instead",
            DeprecationWarning, stacklevel=2)
        print("warning: --sharded is deprecated; use --backend sharded",
              file=sys.stderr)

    if args.zoo == "list":
        from repro_torch.core.zoo import zoo_summary
        if _lead():
            print(zoo_summary())
        return

    modes = [m for m in ("serial", "sweep", "plan", "zoo") if getattr(args, m)]
    if len(modes) > 1:
        ap.error(f"choose at most one of --serial/--sweep/--plan/--zoo "
                 f"(got {modes})")
    if args.serial and (args.sharded or args.backend != "auto"):
        ap.error("--serial does not route through the planner; "
                 "--backend/--sharded do not apply")
    if args.sharded and args.backend not in ("auto", "sharded"):
        ap.error(f"--sharded conflicts with --backend {args.backend}")

    from repro_torch.core.config import SimConfig
    kw = {}
    if args.pc_depth is not None:
        kw["pc_depth"] = args.pc_depth
    if args.eject_age_threshold is not None:
        kw["eject_age_threshold"] = args.eject_age_threshold
    cfg = SimConfig(rows=args.rows, cols=args.cols,
                    centralized_directory=args.centralized,
                    migration_enabled=not args.no_migration,
                    max_cycles=args.max_cycles,
                    state_dtype_policy=args.state_dtype, **kw)

    if args.serial:
        from repro_torch.core.ref_serial import SerialSim
        from repro_torch.core.workloads import resolve_trace
        tr = resolve_trace(cfg, args.app, args.refs, args.seed)
        t0 = time.perf_counter()
        stats = SerialSim(cfg, tr).run()
        stats["wall_s"] = round(time.perf_counter() - t0, 3)
        stats["nodes"] = cfg.num_nodes
        if _lead():
            _emit(stats, args.json)
        return

    if "WORLD_SIZE" not in os.environ:
        from repro_torch.device import resolve_device
        _run_planner(args, cfg, resolve_device(args.device), None)
        return
    # under torchrun: one rank of a process group
    import torch.distributed as dist
    from repro_torch.dist import init_rank
    device = init_rank(None if args.device == "cuda" else args.device,
                       None if args.dist_backend == "auto"
                       else args.dist_backend)
    try:
        _run_planner(args, cfg, device, dist)
    finally:
        dist.destroy_process_group()


def _run_planner(args, cfg, device, dist) -> None:
    """The planner modes on this rank.  Inside a process group (``dist``
    is ``torch.distributed``, else ``None``) every rank runs the plan and
    rank 0 alone prints."""
    from repro_torch.core import engine
    from repro_torch.kernels.router_phase import LAUNCHES

    force = args.backend if args.backend != "auto" else None
    if args.sharded:
        force = "sharded"
    if args.zoo:
        from repro_torch.core.zoo import expand_zoo
        scenarios = expand_zoo(args.zoo, base=cfg)
    elif args.plan:
        scenarios = engine.load_manifest(args.plan, base=cfg)
    elif args.sweep:
        apps = (args.apps or args.app).split(",")
        seeds = [int(x) for x in (args.seeds or str(args.seed)).split(",")]
        scenarios = [engine.make_scenario(cfg, app=a, seed=s,
                                          refs_per_core=args.refs)
                     for a in apps for s in seeds]
        force = force or "sweep"
    else:
        scenarios = [engine.make_scenario(cfg, app=args.app, seed=args.seed,
                                          refs_per_core=args.refs)]

    plan = engine.compile_plan(
        scenarios, force_backend=force,
        mem_budget=engine.parse_mem_budget(args.mem_budget))
    LAUNCHES.reset()
    t0 = time.perf_counter()
    per_scenario = engine.execute_plan(plan, chunk=args.chunk, device=device)
    dt = time.perf_counter() - t0
    launches = LAUNCHES.n
    if dist is not None:
        counts = [None] * dist.get_world_size()
        dist.all_gather_object(counts, launches)
        launches = sum(counts)
        if dist.get_rank() != 0:
            return

    # payload schema follows the *mode*, not the scenario count: --sweep,
    # --plan and --zoo always emit the {plan, scenarios, ...} form, even
    # for a single scenario
    if not (args.sweep or args.plan or args.zoo):
        payload = dict(per_scenario[0])
        payload["wall_s"] = round(dt, 3)
        payload["nodes"] = scenarios[0].cfg.num_nodes
        payload["backend"] = plan.buckets[0].backend
        if plan.buckets[0].note:
            payload["backend_note"] = plan.buckets[0].note
        if plan.buckets[0].backend in ("sharded", "composed"):
            payload["grid"] = list(plan.buckets[0].grid)
    else:
        payload = {
            **({"zoo": args.zoo} if args.zoo else {}),
            "plan": plan.describe(),
            "scenarios": [
                {"rows": sc.cfg.rows, "cols": sc.cfg.cols, "app": sc.app,
                 "seed": sc.seed, **st}
                for sc, st in zip(scenarios, per_scenario)],
            "n_scenarios": len(scenarios),
            "wall_s": round(dt, 3),
            "scenarios_per_sec": round(len(scenarios) / dt, 3),
        }
    payload["device"] = str(device)
    payload["arbitration_kernel_launches"] = launches
    if dist is not None:
        payload["ranks"] = dist.get_world_size()
    _emit(payload, args.json)


if __name__ == "__main__":
    main()
