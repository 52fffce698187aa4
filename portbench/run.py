"""Run one cell of the benchmark of the simulator's PyTorch and CUDA port.

    python3 portbench/run.py --workload paper-208.random --seed 7 \
        --seconds 10 --trace 0

prints, as its last line, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace
0``, its per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; ``checks`` comes last, each number compared with its
limit, and the same numbers end standard error.  It needs as many CUDA
devices as the cell asks for, and fails without them.

``--rehearse-cpu`` runs the same control flow on the CPU at an 8x8 mesh,
to try the harness without a card: the device is reported as the CPU and
no metric that only the card can give is written.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rehearse-cpu", action="store_true",
                    help="run on the CPU at an 8x8 mesh; no device metrics")
    args = ap.parse_args(argv)

    import torch
    from portbench import bench

    cell = bench.load_cell(args.workload, rehearse=args.rehearse_cpu)
    if args.rehearse_cpu:
        torch.set_num_threads(1)
        device, name = torch.device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            print("portbench: no CUDA device; the benchmark does not run on "
                  "the CPU (--rehearse-cpu tries its control flow there)",
                  file=sys.stderr)
            return 1
        if torch.cuda.device_count() < cell.chips:
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"devices, {torch.cuda.device_count()} found",
                  file=sys.stderr)
            return 1
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        name = torch.cuda.get_device_name(device)
    try:
        out = bench.measure(cell, args.seed, args.seconds, bool(args.trace),
                            device, T_START, name)
    except bench.ForbiddenModules as e:
        print(f"portbench: the process holds {e.args[0]} once the window "
              "has closed (JAX or the JAX package)", file=sys.stderr)
        return 3
    held = bench.forbidden_modules()
    if held:
        print(f"portbench: the process holds {held} (JAX or the JAX "
              "package)", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
