"""Train the reduced tinyllama on a device mesh with the PyTorch port: FSDP
over the ``data`` axis, tensor (and sequence) parallelism over ``model``,
one process per rank under ``torchrun``; checkpoints restore onto any
mesh.

    PYTHONPATH=src OMP_NUM_THREADS=1 torchrun --standalone \\
        --nproc-per-node 4 examples/train_lm_sharded_torch.py \\
        --mesh 2,2 --stop-at 20 --device cpu

stops (and checkpoints) at step 20 of 40; the same command with another
``--mesh`` (``1,4``, ``4,1``) and without ``--stop-at`` resumes it there.
On GPUs each rank takes ``cuda:$LOCAL_RANK`` over NCCL (the default
``--device cuda``).
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.configs import registry
from repro_torch.dist import init_rank
from repro_torch.launch.mesh import make_mesh
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import OptConfig


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="2,2",
                    help="data,model: the mesh's shape over the world")
    ap.add_argument("--steps", type=int, default=40,
                    help="the run's length (its learning-rate schedule)")
    ap.add_argument("--stop-at", type=int, default=None,
                    help="stop (and checkpoint) at this step")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default: cuda:$LOCAL_RANK) or 'cpu'")
    args = ap.parse_args()

    device = init_rank(args.device)
    shape = tuple(int(n) for n in args.mesh.split(","))
    mesh = make_mesh(shape, ("data", "model"), device=device)
    cfg = registry.reduced("tinyllama-1.1b")
    trainer = Trainer(
        cfg, OptConfig(lr=1e-3, warmup=5, total_steps=args.steps),
        DataConfig(batch=8, seq=128, seed=3),
        LoopConfig(steps=args.stop_at or args.steps,
                   ckpt_dir="checkpoints/lm-sharded-torch", ckpt_every=10,
                   log_every=10),
        device=device, mesh=mesh)
    out = trainer.run()
    if trainer.verbose:
        print(f"{cfg.name} on a {shape} mesh: {out['steps']} steps to step "
              f"{trainer.lcfg.steps}, final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
