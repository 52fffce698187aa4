#!/usr/bin/env python
"""K2 (flash attention) timed four ways in one process, in turns, to
show which clock a kernel time can rest on.

    python3 scripts/k2_clocks_torch.py     # from the repo root, on a GPU

At the tinyllama-1.1b prefill shape (4, 32 heads / 4 KV heads, 2048,
64), causal: the float32 kernel (three TF32 passes on the tensor cores,
after the pre-pass that splits K and V; the profiler's time sums both),
``scaled_dot_product_attention`` in float32 (K and V expanded to the
query heads) and the bf16 kernel (``wgmma`` + TMA), each
timed with CUDA events over back-to-back calls, with CUDA events while
the card is held busy as the host issues the calls, with
``torch.profiler``'s device time, and with the host's clock around calls
ended by a synchronise; three rounds, each line with the card's clocks,
power and throttle reasons from ``nvidia-smi``.  The kernels are built
from the checkout as ``chip_smoke.py`` builds them.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

ROUNDS = 3


def smi() -> str:
    """The card's SM clock, its maximum, the memory clock, power draw,
    power limit, temperature and active throttle reasons."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "power.draw,power.limit,temperature.gpu,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def host_ms(fn, iters: int) -> float:
    """Milliseconds a call on the host's clock, ``iters`` calls ended by
    a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters * 1e3


def main() -> int:
    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("k2_clocks: needs a GPU", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention_cuda

    dev = torch.device("cuda:0")
    print(cs.card_line(), torch.__version__, torch.version.cuda, flush=True)
    cs.phase_build()
    q, k, v = cs.k2_case(cs.F32_PREFILL_SHAPE, dev, seed=1)
    rep = q.shape[1] // k.shape[1]
    ke, ve = (x.repeat_interleave(rep, dim=1) for x in (k, v))
    qb, kb, vb = cs.k2_case(cs.PREFILL_SHAPE, dev, seed=1)
    cases = (
        ("f32", lambda: flash_attention_cuda(q, k, v, causal=True),
         "flash_attention"),
        ("sdpa32", lambda: F.scaled_dot_product_attention(
            q, ke, ve, is_causal=True), "fmha"),
        ("bf16", lambda: flash_attention_cuda(qb, kb, vb, causal=True),
         "flash_attention"))
    # work first, so that the card's clocks have left idle
    t0 = time.perf_counter()
    for _ in range(200):
        cases[0][1]()
    torch.cuda.synchronize()
    print(f"warm-up: 200 float32 calls in {time.perf_counter() - t0:.3f} "
          f"s; {smi()}", flush=True)
    for rnd in range(ROUNDS):
        for name, fn, key in cases:
            ev = cs.event_ms(fn, 20)
            held = cs.event_ms(fn, 20, hold=True)
            _, prof = cs.device_profile(fn, 10)
            mine = [x for n, x in prof.items() if key in n]
            pr = sum(x[0] for x in mine) / 10
            hm = host_ms(fn, 50)
            print(f"round {rnd} {name}: events {ev:.6f}, held events "
                  f"{held:.6f}, profiler {pr:.6f} ({sum(x[1] for x in mine)}"
                  f" launches in 10 calls), host {hm:.6f} ms; {smi()}",
                  flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
