"""Dev harness: run every reduced architecture of the PyTorch port
through forward, loss, gradient and two decode steps, on the GPU (or the
CPU with ``--device cpu``).  The port's counterpart of
``scripts/smoke_zoo.py``.

    PYTHONPATH=src python scripts/smoke_zoo_torch.py --device cpu
    PYTHONPATH=src python scripts/smoke_zoo_torch.py --device cpu mamba2-130m hymba-1.5b
"""
import argparse
import sys
import traceback

sys.path.insert(0, "src")

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.train import optim, step


def check(arch_id: str, device: str) -> float:
    """One reduced arch through the checks; returns its loss."""
    cfg = registry.reduced(arch_id)
    rng = np.random.default_rng(0)
    params = api.init_params(cfg, 0, device)
    nleaves = len(list(optim.tree_items(params)))

    batch = api.make_inputs(cfg, "train", 2, 32, rng, device=device)
    logits, _ = api.forward_logits(cfg, params, batch, device=device)
    assert logits.shape == (2, 32, cfg.vocab), (arch_id, logits.shape)
    loss, grads = step.value_and_grad(cfg, params, batch, device=device)
    assert torch.isfinite(loss), (arch_id, loss)
    # grad step sanity
    gn = sum(float(g.float().abs().sum()) for _, g in optim.tree_items(grads))
    assert np.isfinite(gn) and gn > 0, (arch_id, gn)

    # two decode steps; the second advances the index
    cache = api.init_cache(cfg, 2, 64, device)
    tok = rng.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
    for n in (1, 2):
        out, cache = api.decode_step(cfg, params, cache, tok, device=device)
        assert out.shape == (2, cfg.vocab), (arch_id, out.shape)
        assert bool(torch.all(torch.isfinite(out.float()))), arch_id
        assert int(cache["idx"]) == n, (arch_id, int(cache["idx"]))

    full = registry.get(arch_id)
    print(f"OK {arch_id:24s} loss={float(loss):8.4f} leaves={nleaves:3d} "
          f"N={full.n_params()/1e9:6.2f}B "
          f"active={full.n_active_params()/1e9:6.2f}B")
    return float(loss)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("arch", nargs="*", help="registry ids (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: 'cuda' (default), 'cuda:<i>' or "
                         "'cpu'")
    args = ap.parse_args(argv)
    failed = 0
    for a in args.arch or registry.ARCH_IDS:
        try:
            check(a, args.device)
        except Exception as e:  # report every arch, then fail
            failed += 1
            print(f"FAIL {a}: {type(e).__name__}: {e}")
            traceback.print_exc(limit=8)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
