"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 256

The flags of the JAX package's ``repro.launch.train``, plus ``--device``:
runs on the GPU unless ``--device cpu`` is given, and without a GPU the
default fails rather than falling back to the CPU.  One device only:
``--mesh single`` and ``--mesh multi`` raise ``NotImplementedError``
(multi-GPU is ``ROADMAP.md`` §1, item 5).  Prints the JAX launcher's
``[train] done: {...}`` line.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.train",
        description="LM training (PyTorch port) on the GPU, or on the CPU "
                    "with --device cpu.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="checkpoints")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi"])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on: 'cuda' (default), "
                         "'cuda:<i>' or 'cpu'")
    return ap


def build_trainer(args: argparse.Namespace):
    """The ``Trainer`` that the launcher runs for parsed ``args``."""
    if args.mesh != "none":
        raise NotImplementedError(
            f"--mesh {args.mesh}: the port trains on one device; meshes "
            f"over several GPUs are ROADMAP.md §1, item 5 (multi-GPU)")

    from repro_torch.configs import registry
    from repro_torch.train.data import DataConfig
    from repro_torch.train.loop import LoopConfig, Trainer
    from repro_torch.train.optim import OptConfig

    cfg = registry.reduced(args.arch) if args.reduced \
        else registry.get(args.arch)
    return Trainer(
        cfg,
        OptConfig(lr=args.lr, warmup=min(20, args.steps // 5 + 1),
                  total_steps=args.steps),
        DataConfig(batch=args.batch, seq=args.seq),
        LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                   ckpt_every=args.ckpt_every, resume=not args.no_resume),
        device=args.device,
    )


def main(argv=None) -> None:
    """Launcher entry point; ``argv`` defaults to ``sys.argv[1:]``."""
    out = build_trainer(build_parser().parse_args(argv)).run()
    print(f"[train] done: {out}")


if __name__ == "__main__":
    main()
