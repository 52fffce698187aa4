"""End-to-end example on the PyTorch port: train a ~100M-param llama-style
LM for a few hundred steps with checkpoint/restart, on the GPU (or the
CPU with ``--device cpu``).  The port's counterpart of
``examples/train_lm.py``: the same model, optimizer, data and loop.

    PYTHONPATH=src python examples/train_lm_torch.py --steps 300
"""
import argparse
import sys

sys.path.insert(0, "src")

from repro_torch.models.config import ModelConfig
from repro_torch.train.data import DataConfig
from repro_torch.train.loop import LoopConfig, Trainer
from repro_torch.train.optim import OptConfig


def small_lm() -> ModelConfig:
    """~100M params (tinyllama family, narrowed)."""
    return ModelConfig(
        name="lm-100m", family="dense", n_layers=8, d_model=640,
        n_heads=10, n_kv_heads=2, d_ff=1792, vocab=32000, max_seq=1024,
        remat=False)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt-dir", default="checkpoints/lm-100m-torch")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default) or 'cpu'")
    args = ap.parse_args()

    cfg = small_lm()
    n = cfg.n_params()
    print(f"model: {cfg.name} ({n/1e6:.0f}M params) on {args.device}")

    trainer = Trainer(
        cfg,
        OptConfig(lr=6e-4, warmup=30, total_steps=args.steps),
        DataConfig(batch=args.batch, seq=args.seq, seed=3),
        LoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir, ckpt_every=100,
                   log_every=20),
        device=args.device,
    )
    out = trainer.run()
    if not trainer.metrics_log:
        print(f"nothing to run: resumed at step {args.steps}")
        return
    first = trainer.metrics_log[0]["loss"]
    print(f"first loss {first:.3f} -> final loss {out['final_loss']:.3f}")
    if not out["final_loss"] < first:
        raise SystemExit("training did not reduce loss")


if __name__ == "__main__":
    main()
