"""Training launcher of the PyTorch port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --reduced --steps 50 --batch 8 --seq 256

The flags of the JAX package's ``repro.launch.train``, plus ``--device``:
runs on the GPU unless ``--device cpu`` is given, and without a GPU the
default fails rather than falling back to the CPU.  ``--mesh single``
and ``--mesh multi`` train over the production mesh (16x16, or 2x16x16
with a ``pod`` axis) and so need 256 or 512 ranks under ``torchrun``
(``--nproc-per-node``; each rank on ``cuda:$LOCAL_RANK`` over NCCL, or on
the CPU over gloo with ``--device cpu``); with another world size they
raise, naming the ranks they need.  Other meshes are reached through
``Trainer(mesh=launch.mesh.make_mesh(...))``.  Prints the JAX
launcher's ``[train] done: {...}`` line (rank 0 alone on a mesh).
"""
from __future__ import annotations

import argparse
import os


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
    device, mesh = args.device, None
    if args.mesh != "none":
        import torch.distributed as dist

        from repro_torch import dist as rdist
        from repro_torch.launch.mesh import make_production_mesh
        if "WORLD_SIZE" in os.environ and not dist.is_initialized():
            device = rdist.init_rank(args.device)         # under torchrun
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=device)

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
        device=device, mesh=mesh,
    )


def main(argv=None) -> None:
    """Launcher entry point; ``argv`` defaults to ``sys.argv[1:]``."""
    trainer = build_trainer(build_parser().parse_args(argv))
    out = trainer.run()
    if trainer.verbose:
        print(f"[train] done: {out}")


if __name__ == "__main__":
    main()
