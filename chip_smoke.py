"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; nothing
of JAX and nothing of the JAX package ``repro``).  Phases, each printing
what it found; any failure exits non-zero and no phase's failure is
caught:

1. card   — the card's name and power limit, from ``nvidia-smi``;
2. build  — compile the router-arbitration kernel from
   ``src/repro_torch/kernels/csrc/`` with ``nvcc`` for ``sm_90a``;
3. kernel — the kernel against its plain PyTorch version on the card,
   bit-exact on seeded cases (n = 1..400, 127/128/129 and the 208x208
   mesh's 43,264 routers); both timed at 43,264 (device time from
   ``torch.profiler``, and per call with CUDA events);
4. wedge  — the former S14 wedge (16x16, distributed directory,
   ``app_trace_loop(cfg, "matmul", 20, 0)``) run to completion on the
   card through ``run``; its statistics must equal the port's own CPU run
   (plain arbitration), and the kernel must have launched;
5. paper  — the paper's 208x208 mesh, packed state, 32 cycles, exactly as
   ``benchmarks/paper_scale.py --smoke`` runs it; its statistics must
   equal ``BENCH_paper_scale.json`` ``raw.stats`` (the JAX package's
   output, read as data); then a longer run at the same mesh is timed,
   and a window of it profiled (device busy share, launches a cycle).

The two lines before the last are the card (as ``nvidia-smi`` gives it)
and one JSON object with the kernel's numbers; the last line is
``{"ok": true, "device": {...}}``.  Without a GPU it exits non-zero and
prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), the
#: table's rate for scalar ALU work; the kernel's work is scalar int32
SCALAR_OPS_PER_S = 67e12
#: bytes the arbitration moves per router: age, dc, dr as int32 and
#: valid, we as bytes for 5 candidates plus 4 port bytes in; assigned as
#: int32 and deflect as bytes for 5 candidates out
ARB_BYTES_PER_ROUTER = 5 * (3 * 4 + 2 * 1) + 4 + 5 * (4 + 1)
#: integer operations per router, counted from the kernel's source: 5
#: candidate setups (key and 4 scores, about 20 ops, plus a 4-way argmin,
#: about 10) and 5 greedy rounds (a 5-way max, about 15 ops, a 5-way
#: select of 6 values, about 30, a 4-way argmin with the taken costs,
#: about 15, and the updates, about 15)
ARB_OPS_PER_ROUTER = 5 * 30 + 5 * 75

PAPER_CYCLES = 32
TIMED_CYCLES = 256


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def event_ms(fn, iters: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card's timeline, timed
    with CUDA events over ``iters`` back-to-back calls after a warm-up.
    Where the host issues work slower than the card runs it, this is the
    host's issue time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_profile(fn, iters: int):
    """Run ``fn`` ``iters`` times under ``torch.profiler``; returns
    ``(wall_ms, {kernel name: (device ms, launches)})`` summed over the
    calls.  The dict is empty where the profiler records no device
    activity."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            ms, count = kernels.get(e.key, (0.0, 0))
            kernels[e.key] = (ms + e.self_device_time_total / 1e3,
                              count + e.count)
    return wall_ms, kernels


def phase_kernel(dev):
    """Kernel against plain version; returns the kernel's record."""
    import numpy as np
    import torch
    from repro_torch.kernels.ref import arbitrate_ref, random_arb_case
    from repro_torch.kernels.router_phase import router_arbitrate_cuda

    def case(seed, n):
        arrs = random_arb_case(np.random.default_rng(seed), n)
        return [torch.from_numpy(a).to(dev) for a in arrs]

    sizes = list(range(1, 401)) + [127, 128, 129, 43_264]
    max_err = 0
    for seed, n in enumerate(sizes):
        args = case(seed, n)
        got_a, got_d = router_arbitrate_cuda(*args)
        ref_a, ref_d = arbitrate_ref(*args)
        torch.cuda.synchronize()
        err = max(int((got_a - ref_a).abs().max()),
                  int((got_d != ref_d).sum()))
        if err:
            fail(f"kernel disagrees with arbitrate_ref at n={n} "
                 f"(max abs err {err})")
        max_err = max(max_err, err)
    print(f"kernel: router_arbitrate bit-exact against arbitrate_ref on "
          f"{len(sizes)} cases (n = 1..400, 127, 128, 129, 43264)")

    n = 43_264
    args = case(12345, n)
    call_ms = event_ms(lambda: router_arbitrate_cuda(*args), 500)
    plain_call_ms = event_ms(lambda: arbitrate_ref(*args), 50)
    iters = 200
    _, kern = device_profile(lambda: router_arbitrate_cuda(*args), iters)
    _, plain = device_profile(lambda: arbitrate_ref(*args), iters)
    mine = {k: v for k, v in kern.items() if "router_arbitrate" in k}
    if mine and plain:
        ms = sum(v[0] for v in mine.values()) / iters
        plain_ms = sum(v[0] for v in plain.values()) / iters
    else:
        print("kernel: torch.profiler recorded no device time; reporting "
              "the CUDA-event times")
        ms, plain_ms = call_ms, plain_call_ms
    bytes_ms = n * ARB_BYTES_PER_ROUTER / HBM_BYTES_PER_S * 1e3
    ops_ms = n * ARB_OPS_PER_ROUTER / SCALAR_OPS_PER_S * 1e3
    print(f"kernel: n={n} device time (torch.profiler): kernel {ms:.6f} ms, "
          f"plain {plain_ms:.6f} ms ({len(plain)} kernels); per call on "
          f"the card's timeline (CUDA events): kernel {call_ms:.6f} ms, "
          f"plain {plain_call_ms:.6f} ms; bound {max(bytes_ms, ops_ms):.6f} "
          f"ms (bytes {bytes_ms:.6f}, ops {ops_ms:.6f})")
    return {
        "name": "router_arbitrate",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/router_arbitrate.cu",
        "replaces": "src/repro/kernels/router_phase.py:36",
        "launches": None,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,     # no single PyTorch call computes it
    }


def phase_wedge(dev) -> None:
    import torch
    from repro_torch.core.config import SimConfig
    from repro_torch.core.sim import run
    from repro_torch.core.workloads import app_trace_loop
    from repro_torch.kernels.router_phase import LAUNCHES

    cfg = SimConfig(rows=16, cols=16, centralized_directory=False,
                    max_cycles=200_000)
    tr = app_trace_loop(cfg, "matmul", 20, 0)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    gpu = run(cfg, tr, chunk=64, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.n
    if gpu["finished"] != 1 or "aborted" in gpu:
        fail(f"wedge did not complete on the card: {gpu}")
    if launches <= 0:
        fail("wedge ran without launching the arbitration kernel")
    t0 = time.perf_counter()
    cpu = run(cfg, tr, chunk=64, device="cpu")
    cpu_wall = time.perf_counter() - t0
    if cpu != gpu:
        diff = {k: (cpu.get(k), gpu.get(k)) for k in set(cpu) | set(gpu)
                if cpu.get(k) != gpu.get(k)}
        fail(f"wedge: card and CPU statistics differ: {diff}")
    print(f"wedge: 16x16 completed in {gpu['cycles']} cycles "
          f"({gpu['send_drop']} drops recovered), card stats == CPU stats; "
          f"kernel launches {launches}; card {wall:.3f} s "
          f"({gpu['cycles'] / wall:.1f} cycles/s), CPU {cpu_wall:.3f} s")


def phase_paper(dev) -> int:
    """208x208 packed 32-cycle run against the JAX package's baseline;
    returns the kernel launches of that run."""
    import torch
    from repro_torch.core.config import SimConfig
    from repro_torch.core.sim import VectorSim, run
    from repro_torch.core.workloads import random_trace
    from repro_torch.kernels.router_phase import LAUNCHES

    with open(os.path.join(ROOT, "BENCH_paper_scale.json")) as f:
        want = json.load(f)["raw"]["stats"]
    cfg = SimConfig(rows=208, cols=208, max_cycles=PAPER_CYCLES,
                    centralized_directory=False, dir_layout="home",
                    state_dtype_policy="packed")
    tr = random_trace(cfg, refs_per_core=8, seed=0)
    LAUNCHES.reset()
    t0 = time.perf_counter()
    got = run(cfg, tr, max_cycles=PAPER_CYCLES, chunk=PAPER_CYCLES,
              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.n
    if got != want:
        diff = {k: (want.get(k), got.get(k)) for k in set(want) | set(got)
                if want.get(k) != got.get(k)}
        fail(f"208x208 statistics differ from BENCH_paper_scale.json: "
             f"{diff}")
    if launches != PAPER_CYCLES:
        fail(f"208x208: {launches} kernel launches in {PAPER_CYCLES} "
             f"cycles, expected one a cycle")
    print(f"paper: 208x208 packed {PAPER_CYCLES} cycles == "
          f"BENCH_paper_scale.json raw.stats "
          f"({got['flits_delivered']} flits delivered, {got['hops']} hops); "
          f"kernel launches {launches}; {wall:.3f} s including set-up")

    # a longer run at the same mesh, timed after a short warm-up run
    cfg_t = SimConfig(rows=208, cols=208, max_cycles=TIMED_CYCLES,
                      centralized_directory=False, dir_layout="home",
                      state_dtype_policy="packed")
    tr_t = random_trace(cfg_t, refs_per_core=64, seed=0)
    run(cfg_t, tr_t, max_cycles=8, chunk=8, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got_t = run(cfg_t, tr_t, max_cycles=TIMED_CYCLES, chunk=64, device=dev)
    torch.cuda.synchronize()
    wall_t = time.perf_counter() - t0
    rate = cfg_t.num_nodes * got_t["cycles"] / wall_t
    print(f"paper: 208x208 packed, {got_t['cycles']} cycles in "
          f"{wall_t:.3f} s (set-up included): {rate:.1f} node-cycles/s, "
          f"{wall_t / got_t['cycles'] * 1e3:.3f} ms/cycle, "
          f"{got_t['flits_delivered']} flits delivered, card: "
          f"{card_line()}")

    # where a cycle's time goes: a profiled window of steady-state cycles
    vs = VectorSim(cfg_t, tr_t, device=dev)
    for _ in range(16):
        vs.step()
    cycles = 16
    wall_ms, kern = device_profile(
        lambda: [vs.step() for _ in range(cycles)], 1)
    busy = sum(v[0] for v in kern.values())
    launches_per_cycle = sum(v[1] for v in kern.values()) / cycles
    arb = sum(v[0] for k, v in kern.items() if "router_arbitrate" in k)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"profile: 208x208 packed, {cycles} cycles: wall "
          f"{wall_ms / cycles:.3f} ms/cycle, device busy "
          f"{busy / cycles:.3f} ms/cycle (idle share "
          f"{1 - busy / wall_ms:.4f}), {launches_per_cycle:.1f} kernel "
          f"launches/cycle, router_arbitrate {arb / cycles:.6f} ms/cycle")
    for name, (ms, count) in top:
        print(f"profile:   {ms / cycles:.6f} ms/cycle  "
              f"{count / cycles:.1f}/cycle  {name[:90]}")
    return launches


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)
    from repro_torch.kernels.build import build

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")

    built = build("router_arbitrate")
    print(f"build: {built.path.name} in {built.seconds:.1f} s")
    for line in built.log.strip().splitlines():
        print(f"build: {line}")

    rec = phase_kernel(dev)
    phase_wedge(dev)
    rec["launches"] = phase_paper(dev)

    print(card)
    print(json.dumps({"kernels": [rec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
