"""NoC-simulation launcher of the PyTorch port: one solo run.

    PYTHONPATH=src python -m repro_torch.launch.simulate --rows 16 --cols 16 \\
        --app matmul --refs 20

Runs on the GPU unless ``--device cpu`` is given; without a GPU the
default fails rather than falling back to the CPU.  Prints the run's
statistics as JSON (the same keys as the JAX launcher's solo mode, plus
``wall_s``, ``nodes``, ``device`` and ``arbitration_kernel_launches``,
the launches of the fused Phase-2 router kernel, which arbitrates).
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.core.workloads import source_summary


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.simulate",
        description="Bufferless-NoC simulator (PyTorch port): one solo run "
                    "on the GPU, or on the CPU with --device cpu.")
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
    ap.add_argument("--state-dtype", choices=("wide", "packed"),
                    default="wide",
                    help="SimState storage layout: 'wide' (every field "
                         "int32) or 'packed' (each field in the smallest "
                         "dtype its bounds allow; same results)")
    ap.add_argument("--chunk", type=int, default=8,
                    help="simulated cycles per termination check")
    ap.add_argument("--max-cycles", type=int, default=200_000,
                    help="hard cycle cap")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (default), "
                         "'cuda:<i>' or 'cpu'")
    ap.add_argument("--json", default=None,
                    help="also write the result payload to this file")
    return ap


def main(argv=None) -> None:
    """Launcher entry point; ``argv`` defaults to ``sys.argv[1:]``."""
    args = build_parser().parse_args(argv)

    from repro_torch.core.config import SimConfig
    from repro_torch.core.sim import resolve_device, run
    from repro_torch.core.workloads import resolve_trace
    from repro_torch.kernels.router_phase import LAUNCHES

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
    device = resolve_device(args.device)
    tr = resolve_trace(cfg, args.app, args.refs, args.seed)

    LAUNCHES.reset()
    t0 = time.perf_counter()
    payload = dict(run(cfg, tr, chunk=args.chunk, device=device))
    payload["wall_s"] = round(time.perf_counter() - t0, 3)
    payload["nodes"] = cfg.num_nodes
    payload["device"] = str(device)
    payload["arbitration_kernel_launches"] = LAUNCHES.n
    print(json.dumps(payload, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f)


if __name__ == "__main__":
    main()
