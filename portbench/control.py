"""Readings that set the limit of the comparison deciding ``correct``.

    python3 portbench/control.py --workload paper-208.random \
        --seeds 11,12,13 --seconds 10

For each seed, at the cell's own size and for as many cycles as a run
of ``--seconds`` steps: the port's statistics against the plain
reference's (the lower reading, the program's), and the control's
against the reference's (the upper reading).  The control is the
reference with every leaf of the state passed through the integer type
one width below the configuration's packed layout at each cycle's end,
the step that would tempt a change to the state's layout.  Prints one
JSON line a seed.  Needs a CUDA device, or ``--rehearse-cpu``.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]


def readings(cell, seeds, seconds: float, device):
    """Yield one dict of readings per seed."""
    from portbench import bench, yardstick
    clock = bench.Clock(device)
    cycles = bench.window_cycles(cell.mix, seconds)
    for seed in seeds:
        traces, entry = bench.prepare(cell, seed, device)
        bench.warm_up(cell, entry, clock)
        got, window_s = clock.time(lambda: entry(cycles))
        del entry
        want = bench.reference_stats(cell, traces, cycles, device)
        ctl = bench.reference_stats(cell, traces, cycles, device,
                                    control=True)
        prog = yardstick.compare(got, want)
        lower = yardstick.compare(ctl, want)
        yield {"workload": cell.name, "seed": seed, "cycles": cycles,
               "window_s": window_s,
               "program_mismatches": prog[0], "program_failed": prog[1],
               "control_mismatches": lower[0], "control_failed": lower[1],
               "finished": sum(int(g["finished"]) for g in got)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rehearse-cpu", action="store_true")
    args = ap.parse_args(argv)
    import torch
    from portbench import bench
    cell = bench.load_cell(args.workload, rehearse=args.rehearse_cpu)
    if args.rehearse_cpu:
        torch.set_num_threads(1)
        device = torch.device("cpu")
    elif not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 1
    else:
        device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    for r in readings(cell, [int(s) for s in args.seeds.split(",")],
                      args.seconds, device):
        r["elapsed_s"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
