"""Scale demo on the PyTorch port: simulate a large LCMP, its router mesh
tiled over the ranks of a process group.

The paper's headline is 43,000 simulated cores on one GTX 690.  The port's
counterpart of ``examples/simulate_large_noc.py``: the same tiling choice,
made over the ranks that ``torchrun`` starts, each rank with a GPU of its
own (NCCL), or over CPU ranks (gloo, ``--device cpu``).  Alone, without
``torchrun``, it runs on one device.

    torchrun --nproc-per-node 8 examples/simulate_large_noc_torch.py \\
        --rows 64 --cols 64
    torchrun --nproc-per-node 4 examples/simulate_large_noc_torch.py \\
        --rows 16 --cols 16 --refs 10 --device cpu
"""
import argparse
import os
import sys
import time

sys.path.insert(0, "src")

import torch.distributed as dist

from repro_torch.core.config import SimConfig
from repro_torch.core.sharded import ProcessGrid, ShardedSim
from repro_torch.core.workloads import app_trace
from repro_torch.device import resolve_device
from repro_torch.dist import init_rank


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--cols", type=int, default=64)
    ap.add_argument("--refs", type=int, default=40)
    ap.add_argument("--app", default="mgrid")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (under torchrun cuda:$LOCAL_RANK), "
                         "'cuda:<i>' or 'cpu'")
    args = ap.parse_args()

    if "WORLD_SIZE" in os.environ:
        dev = init_rank(None if args.device == "cuda" else args.device)
    else:
        dev = resolve_device(args.device)
    n_dev = dist.get_world_size() if dist.is_initialized() else 1
    rt = 1
    for cand in range(int(n_dev ** 0.5), 0, -1):
        if n_dev % cand == 0 and args.rows % cand == 0 \
                and args.cols % (n_dev // cand) == 0:
            rt = cand
            break
    grid = ProcessGrid(1, rt, n_dev // rt)
    lead = grid.rank == 0
    if lead:
        print(f"simulating {args.rows}x{args.cols} = {args.rows*args.cols} "
              f"cores over {n_dev} rank(s) on {dev.type} (tiles "
              f"{rt}x{n_dev//rt})")

    cfg = SimConfig(rows=args.rows, cols=args.cols, addr_bits=20,
                    centralized_directory=False, dir_layout="home")
    trace = app_trace(cfg, args.app, args.refs, seed=1)
    sim = ShardedSim(cfg, trace, grid, device=dev)
    t0 = time.time()
    stats = sim.run(chunk=128)
    dt = time.time() - t0
    grid.close()
    if dist.is_initialized():
        dist.destroy_process_group()
    if lead:
        print(f"finished={stats['finished']} cycles={stats['cycles']} "
              f"wall={dt:.1f}s")
        for k in ("req_made", "trap", "redirection", "migrations",
                  "deflections", "injected"):
            print(f"  {k:12s} {stats[k]}")


if __name__ == "__main__":
    main()
