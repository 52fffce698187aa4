"""Serving launcher of the PyTorch port: batched greedy/sampled decoding
with continuous batching.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
        --requests 8 --max-new 16

Any ``--arch`` of the registry (``repro_torch.configs.registry.ARCH_IDS``:
dense, moe, ssm, hybrid, vlm and audio families), as the JAX package's
launcher.  The flags of the JAX package's ``repro.launch.serve``, plus
``--device``:
runs on the GPU unless ``--device cpu`` is given, and without a GPU the
default fails rather than falling back to the CPU.  Parameters are random,
from ``--seed`` (the port's own initialisation).  Prints the JAX
launcher's line, plus the device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Continuous-batching LM serving (PyTorch port) on the "
                    "GPU, or on the CPU with --device cpu.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (default), "
                         "'cuda:<i>' or 'cpu'")
    return ap


def main(argv=None) -> None:
    """Launcher entry point; ``argv`` defaults to ``sys.argv[1:]``."""
    args = build_parser().parse_args(argv)

    import torch

    from repro_torch.configs import registry
    from repro_torch.device import resolve_device
    from repro_torch.models import api
    from repro_torch.serve.server import Request, Server

    device = resolve_device(args.device)
    cfg = registry.reduced(args.arch) if args.reduced \
        else registry.get(args.arch)
    params = api.init_params(cfg, args.seed, device)
    server = Server(cfg, params, slots=args.slots, cache_len=args.cache_len,
                    temperature=args.temperature, seed=args.seed,
                    device=device)
    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab,
                              size=int(rng.integers(2, 9))).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new))

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    done = server.run_until_drained()
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {dt:.1f}s "
          f"({toks/max(dt,1e-9):.1f} tok/s) with {args.slots} slots "
          f"on {device}")


if __name__ == "__main__":
    main()
