"""Quickstart on the PyTorch port: simulate an 8x8-core bufferless LCMP on
the GPU (or the CPU with ``--device cpu``), and hold its statistics
against the serial golden model.  The port's counterpart of
``examples/quickstart.py``: the same configuration and trace.

    PYTHONPATH=src python examples/quickstart_torch.py
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.core import SimConfig, run
from repro_torch.core.ref_serial import SerialSim
from repro_torch.core.trace import app_trace

SHOWN = ("cycles", "req_made", "reply_sent", "trap", "redirection",
         "migrations", "dir_search", "l1_hits", "l1_misses", "deflections",
         "injected")


def main(argv=None, rows: int = 8, cols: int = 8, refs: int = 60) -> dict:
    """The quickstart; ``rows``, ``cols`` and ``refs`` (references a
    core) size it, the original's 8x8 and 60 by default."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:<i>' or "
                         "'cpu'")
    args = ap.parse_args(argv)
    cfg = SimConfig(rows=rows, cols=cols, addr_bits=18, migrate_threshold=2)
    trace = app_trace(cfg, "matmul", refs_per_core=refs, seed=1)

    print(f"== vectorized simulator on {args.device} "
          f"(the paper's GPU version) ==")
    stats = run(cfg, trace, chunk=8, device=args.device)
    for k in SHOWN:
        print(f"  {k:14s} {stats[k]}")

    print("== serial golden model (the paper's C++ version) ==")
    ref = SerialSim(cfg, trace).run()
    same = all(ref[k] == stats[k] for k in ref)
    print(f"  identical statistics: {same}")
    if not same:
        raise SystemExit("the simulator and the serial model disagree")
    return stats


if __name__ == "__main__":
    main()
