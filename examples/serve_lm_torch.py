"""Serve a small LM with batched requests (continuous batching) on the
PyTorch port, on the GPU (or the CPU with ``--device cpu``).  The port's
counterpart of ``examples/serve_lm.py``: reduced tinyllama-1.1b, 4 slots,
10 requests of 12 new tokens, greedy.

    PYTHONPATH=src python examples/serve_lm_torch.py
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np

from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.serve.server import Request, Server


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:<i>' or "
                         "'cpu'")
    args = ap.parse_args(argv)
    cfg = registry.reduced("tinyllama-1.1b")
    params = api.init_params(cfg, 0, args.device)
    server = Server(cfg, params, slots=4, cache_len=128, temperature=0.0,
                    device=args.device)

    rng = np.random.default_rng(0)
    for rid in range(10):
        prompt = rng.integers(0, cfg.vocab, size=rng.integers(2, 8)
                              ).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=12))

    finished = server.run_until_drained()
    if len(finished) != 10:
        raise SystemExit(f"served {len(finished)} of 10 requests")
    for req in finished:
        print(f"req {req.rid}: prompt {req.prompt.tolist()} -> {req.out}")
    print(f"served {len(finished)} requests with continuous batching "
          f"on {args.device}")
    return finished


if __name__ == "__main__":
    main()
