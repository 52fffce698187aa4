"""Drive the PyTorch port on one NVIDIA GPU and check what comes out.

    python3 chip_smoke.py

Run from the root of a checkout (it imports ``src/repro_torch``; nothing
of JAX and nothing of the JAX package ``repro``).  Phases, each printing
what it found; any failure exits non-zero and no phase's failure is
caught:

1. card      — the card's name and power limit, from ``nvidia-smi``;
2. build     — compile both sources in ``src/repro_torch/kernels/csrc/``
   (the router kernels and K2) with ``nvcc`` for ``sm_90a``, one ``nvcc``
   per source, started together; prints ptxas's register/spill report;
3. kernel    — K1 (router arbitration alone) against its plain PyTorch
   version, bit-exact on seeded cases (n = 1..400, 127/128/129 and the
   208x208 mesh's 43,264 routers: every case launched on the card, one
   synchronise, the plain version run on CPU copies); both timed at
   43,264 (device time from ``torch.profiler``, and per call with CUDA
   events);
3b. kernel-phase2 — K1's redesign, the fused Phase-2 router kernel, which
   the simulator runs once a cycle: bit-exact against its plain version
   (run on CPU copies) on seeded cases (n = 1 to 43,264, the 128-router
   tile's edges, pending depth 1, 2 and 4, views off a 16-byte boundary)
   and on mid-run states of the wedge and of paper-208 taken after Phases
   1a and 1b of a cycle; timed at 43,264 routers beside its byte bound
   and the eager Phase 2 (the plain version on CUDA tensors: device time
   and launches);
4. kernel-K2 — K2 (flash attention: bf16 on the tensor cores, float32
   on the CUDA cores) against ``attention_ref`` at the four
   ``tests/test_kernels.py`` shapes, grouped-query cases at D 32, 64 and
   128, and at D 16 and 14 (padded to D 32: the reduced configs' head
   dims) in both dtypes, S != T cases, the tinyllama-1.1b prefill shape (4, 32, 2048,
   64) and the D-128 prefill shapes of qwen2-moe-a2.7b (4, 16/16, 2048,
   128) and llama-3.2-vision-11b (4, 32/8, 2048, 128), bf16 causal,
   within 1e-5 (float32) and 5e-2 (bfloat16), one launch a call; at the
   three prefill shapes the kernel, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never called
   by the port) are timed (CUDA events, the card held busy while the host
   issues the calls; torch.profiler's device times beside them, since on
   some machines they read about half); and the float32 kernel (off the
   main path) at
   the tinyllama-1.1b prefill shape, checked within 1e-5 and timed against
   its bound at the float32 CUDA-core rate and SDPA in float32 (K and V
   expanded to the query heads), the profile naming
   ``flash_attention_f32_kernel``;
5. wedge     — the former S14 wedge (16x16, distributed directory,
   ``app_trace_loop(cfg, "matmul", 20, 0)``) run to completion on the
   card through ``run``; its statistics must equal the port's own CPU run
   (plain versions), the fused Phase-2 kernel must have launched once a
   stepped cycle and the standalone arbitration never;
6. paper     — the paper's 208x208 mesh, packed state, 32 cycles, exactly
   as ``benchmarks/paper_scale.py --smoke`` runs it; its statistics must
   equal ``BENCH_paper_scale.json`` ``raw.stats`` (the JAX package's
   output, read as data), with one fused Phase-2 launch a cycle and no
   standalone arbitration; then a longer run at the same mesh is timed,
   and a window of it profiled (device busy share, launches a cycle, the
   fused kernel once a cycle by name);
6b. sweep-208 — the multi-scenario front end at the paper's scale: a
   ``run_sweep`` of 4 scenarios over paper-208's config (32 cycles;
   seed 0 default knobs, seed 0 migration off, seed 1 ejection age
   threshold 8, seed 1 migration threshold 1).  Scenario 0 must equal
   ``BENCH_paper_scale.json`` ``raw.stats``, each scenario its solo
   ``run`` on the card (``run_sequential``), with 4 x 32 fused Phase-2
   launches and no standalone arbitration; prints ms per scenario-cycle
   beside the solo runs' and paper-208's, and the peak device memory
   beside the planner's ``plan_state_bytes``;
6d. sharded — the multi-device simulator (``core/sharded.py``) at
   paper-208, its ranks started as subprocesses by
   ``repro_torch.dist.spawn`` (each with a timeout; a rank's failure
   fails the phase): (a) ``ShardedSim`` on one NCCL rank, grid (1, 1,
   1); (b) four gloo ranks on ``cuda:0``, a 2x2 split (10,816-router
   tiles); both runs' statistics on every rank must equal
   ``BENCH_paper_scale.json`` ``raw.stats``, with one fused Phase-2
   launch a cycle on every rank and no standalone arbitration; (c)
   ``run_composed`` of sweep-208's four scenarios over a (2, 2, 1) grid
   of four gloo ranks on ``cuda:0``: every rank's results equal 6b's;
   (d) on every rank of (b) (rank 3's tile is the farthest from the
   mesh's origin), the fused kernel against its plain version (on CPU
   copies) on that tile's Phase-2 inputs after 32 cycles and Phases 1a
   and 1b, bit-exact.  Prints ms a cycle per rank: ranks time-sharing one card
   and one host, not a scaling result.  NCCL with more than one rank
   needs a card a rank, which one card cannot show;
6c. plan     — run beside zoo-cli (10, below), whose subprocesses start
   just before it and are waited for just after: ``BENCH_plan.json``'s
   smoke set (4x4 and 8x8, ``equake``,
   seeds 0 and 1, 10 refs, distributed directory) through
   ``compile_plan`` + ``execute_plan`` on the card: the plan describes
   itself as the file's does (2 buckets), every scenario finishes, the
   port's ``repro_torch.bench.collect.health_metrics`` of the run equal
   the file's ``plan.net.*`` metrics (read with the port's
   ``BenchReport.read``) exactly, and ``compare_reports`` of the file's
   against the fresh ones passes (its findings printed);
7. lm-prefill — tinyllama-1.1b at full width (22 layers, seeded random
   parameters from the port's own init, float32, bf16 compute), the
   prefill step at B=4, S=2048: K2 launches exactly 22 times, the logits
   are finite, and the last-token logits agree with the same forward
   forced through the einsum route (bf16 and float32 compute); timed and
   profiled, and the profile must name the bf16 tensor-core kernel;
8. lm-decode — a 128-token prompt fed one token at a time through
   ``decode_step`` (no K2 launch) tracks the cache-free forward at S=128
   (22 K2 launches);
9. lm-serve  — the continuous-batching ``Server`` answers 8 seeded
   requests with 4 slots, ``cache_len=256`` and ``max_new=16``, as
   ``python -m repro_torch.launch.serve`` does by default; timed, and
   at reduced width its tokens equal the CPU run's;
10. zoo-cli  — the launcher as a user runs it, in subprocesses started
   together beside the plan phase: ``--zoo patterns-tiny:refs=4`` on the card and with ``--device
   cpu`` (all 10 scenarios finish, the payloads' statistics and plans
   equal), and ``--serial`` (the numpy golden model) against the card's
   solo run of the same flags.
10a. drivers — beside zoo-cli, the drivers as a user runs them on the
   card: ``examples/quickstart_torch.py`` (8x8, ``matmul``, 60 refs,
   seed 1: the simulator's statistics identical to the serial model's)
   and ``examples/serve_lm_torch.py`` (reduced tinyllama, 4 slots, 10
   requests served).
10b. dryrun  — the dry run (``repro_torch.launch.dryrun``: rank 0 of a
   mesh on a fake process group, fake tensors, nothing on the card), in
   subprocesses started with the script: the launcher for tinyllama-1.1b
   ``train_4k`` and ``noc-sim noc_43k`` on the 256-rank production mesh,
   tinyllama-1.1b's B=4 S=2048 bf16 prefill, its B=4 decode step (a
   64-slot cache) and its float32 train step at B=8 S=256 on
   lm-sharded's (2, 2) mesh, and its B=1 S=4096 train step on one
   device; each record has its FLOPs, collective
   bytes by kind, memory a rank and the analytic figures (those equal to
   ``models.costs``), and is printed; lm-sharded holds its ranks'
   parameter bytes and what they hold for a decode step against the
   (2, 2) predictions, lm-train (d) prints its peak memory beside the
   one-device prediction.
11. lm-train — LM training on the einsum attention route (K2 has no
   backward and is never launched by a train step): (a) tinyllama-1.1b
   at full width, float32 compute, B=1 S=128, one step's loss, grad norm
   and per-leaf gradients on the card against the same step on this
   machine's CPU; (b) the launcher's defaults at full width (B=8 S=256,
   bf16 compute, remat, ``DataSource`` seed 0), 8 steps through
   ``make_train_step``: finite losses, ms a step, tokens/s, model FLOP
   utilisation against ``models.costs.cell_flops``, peak memory, one
   profiled step (launches, device busy, idle share), K2 launches 0;
   (c) at reduced width, the ``Trainer`` checkpointed at step 6 and
   resumed to 12 equals an uninterrupted 12-step run bit for bit, and
   ``python -m repro_torch.launch.train --arch tinyllama-1.1b --reduced
   --steps 12`` in a subprocess ends at the same loss, lower than the
   first; (d) one bf16 step at full width, B=1 S=4096, past
   ``BLOCK_THRESHOLD`` (the blocked attention, each query and key chunk
   recomputed in the backward): a finite loss, its ms and the peak
   device memory beside the dry run's one-device prediction (10b), and
   its loss and grad norm against the einsum route's (the whole scores
   at once) on the same batch (LONG_LOSS_RTOL, LONG_GNORM_RTOL).
12. lm-moe, lm-ssm, lm-hybrid, lm-vlm, lm-audio — the other LM families,
   each at the full width of one published config (qwen2-moe-a2.7b,
   mamba2-130m, hymba-1.5b, llama-3.2-vision-11b, whisper-small) from the
   port's seeded init, one model on the card at a time: (a) the
   parameter count equals the port's abstract tree's (the JAX package's
   ``n_params()`` counts these trees otherwise, so it is printed beside
   it, not held); (b) the B=4, S=2048 bf16 prefill: K2 launches 24, 0, 3,
   32 and 12 times, the logits are finite, and every K2 launch agrees
   with ``attention_ref`` on its own inputs; timed and profiled; the
   kernel route against the einsum route, held in float32 and printed in
   bf16; (c) 32 decode steps at B 4 (no K2 launch) against the
   cache-free forward of the same tokens, held in float32 (greedy
   agreement at least DECODE_AGREE, last logits within ROUTE_MAX/
   ROUTE_MEAN) and printed and timed in bf16; qwen2-moe's comparisons
   replay the router's choices (``PinnedRouting``), its decode forward
   at a capacity that drops nothing; (d) the ``Server`` at the
   launcher's defaults.  K2 is also timed at their D-128 prefill shapes
   in phase 4.
12b. lm-moe-train, lm-ssm-train, lm-hybrid-train, lm-vlm-train,
   lm-audio-train — after each family's serving phase, its training at
   the launcher's configuration, full width, the depth cut only where one
   card's memory forces it (qwen2-moe-a2.7b to 2 of 24 layers,
   llama-3.2-vision-11b to one cross-attention group of 5 of 40; the
   others whole): (a) one float32 step on the card against the CPU, as
   lm-train (a) (hymba's unread ``layers.mamba.ln`` exactly zero on
   both; the moe router's choices on the card replayed on the CPU;
   vlm's zero gates opened so its cross-attention carries gradient); (b)
   bf16 steps at B=8 S=256 with remat, timed and profiled (ms a step,
   tokens/s, MFU, peak memory, idle share, launches; K2 launches 0);
   (c) for hymba, the reduced-width Trainer resumed bit for bit.
11b. lm-sharded — after lm-train: tinyllama-1.1b at full width on a
   (2, 2) ("data", "model") device mesh of four gloo ranks sharing
   cuda:0 (DTensor; its collectives staged through host copies, since
   gloo's functional collectives of CUDA tensors kill the rank), ranks
   ``spawn``ed as subprocesses: (1) the B=4 S=2048 bf16 prefill, K2 on
   each rank's 16 local heads (22 launches a rank), the last-token
   logits against the one-device prefill (ROUTE_MAX/ROUTE_MEAN), and in
   a second prefill each K2 call against ``attention_ref`` on its
   rank's own inputs (5e-2); (2)
   one float32 train step at B=8 S=256, its loss, grad norm and every
   gathered gradient against the one-device step (the lm-train
   tolerances), the step in the dry run's meter: its all-gather and
   all-reduce bytes equal to the dry run's (2, 2) train cell's (10b;
   the loss reduces over the split vocabulary, no logits gathered);
   (3) the step's parameters saved on (2, 2), restored on
   (1, 4) and on one rank, every leaf equal bit for bit, and the next
   step's loss and grad norm on (1, 4) against one rank's; (4) each
   rank's parameter bytes equal to the dry run's prediction for the same
   mesh and prefill (10b).  Between (1) and (2), (1b): 3 bf16 decode
   steps at B=4 from a zeroed 64-slot cache, the weights left split as
   ``param_pspecs`` places them and the cache as ``cache_pspecs`` does:
   each rank's logits against one device's decode on rank 0
   (ROUTE_MAX/ROUTE_MEAN), ms a step by rank, the all-gathers of the last
   step (in the dry run's meter) beside the dry run's, and each rank's
   parameters, cache and tokens equal to the dry run's decode
   prediction (10b).  Prints ms a prefill and a step per rank:
   ranks time-sharing one card, not a scaling result.

The two lines before the last are the card (as ``nvidia-smi`` gives it)
and one JSON object with the three kernels' numbers (K1 alone, the fused
Phase-2 kernel, K2; the fused kernel's launches count every rank of
the sharded phase, K2's every family's prefill and every rank's sharded
prefill, also listed by rank); the last line is
``{"ok": true, "device": {...}}``.  Without a GPU it exits non-zero and
prints no result.
"""
from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM device-memory rate (NVIDIA data sheet), bytes per second
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet), the
#: table's rate for scalar ALU work; the kernel's work is scalar int32
SCALAR_OPS_PER_S = 67e12
#: H100 SXM dense bf16 tensor-core rate (NVIDIA data sheet): the least
#: time for attention's two products in bf16
BF16_FLOP_PER_S = 989e12
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
#: integer operations per router of the fused Phase-2 kernel, counted
#: from its source at 8 ROB slots and pending depth 4: staging about 116
#: words in and 40 out at about 8 operations a word (address, divide,
#: store), the ROB scan (8 x 17) and pending count (4 x 3), the ejection
#: pick (4 x 15), the injection flit and candidates (about 90), the
#: arbitration (ARB_OPS_PER_ROUTER), routing (4 ports x 10 fields x
#: about 12 selects) and the pop and counts (about 30)
P2_OPS_PER_ROUTER = 156 * 8 + 8 * 17 + 4 * 3 + 4 * 15 + 90 \
    + ARB_OPS_PER_ROUTER + 4 * 10 * 12 + 30
#: the fused kernel's arguments, in order
P2_ARGS = ("inp", "rob", "pc", "q_desc", "q_head", "q_size", "q_fid",
           "node_id", "node_r", "node_c", "valid_port", "knob_ej_age",
           "stats")
#: seeded Phase-2 cases (n, rob slots, pending depth, send queue, rows,
#: cols, view offset in routers): the tile's edges, depth 1 (20 B a
#: router, off the 16-byte grid), an odd ROB slab, offset views, and the
#: 208x208 mesh
P2_CASES = ([(n, 8, 4, 64, 4, 4, 0) for n in (1, 2, 3, 16, 31, 33)]
            + [(n, 8, 4, 64, 16, 16, 0) for n in (127, 128, 129, 255, 256,
                                                    257, 1000)]
            + [(n, 8, 1, 64, 16, 16, 0) for n in (127, 128, 129)]
            + [(129, 3, 2, 4, 5, 7, 0), (300, 8, 1, 16, 3, 5, 1),
               (300, 8, 4, 16, 3, 5, 3), (43_264, 8, 4, 64, 208, 208, 0),
               (43_264, 8, 1, 64, 208, 208, 0)])
#: cycles after which the wedge's and paper-208's states are taken (then
#: Phases 1a and 1b of the next cycle run before the comparison)
WEDGE_SNAPSHOTS = (300, 900)
PAPER_SNAPSHOTS = (8, 24)
P2_SYMBOL = "phase2_router_kernel"

PAPER_CYCLES = 32
TIMED_CYCLES = 256

#: K2's shapes: (B, H, KV, S, D, dtype, causal), with T = S, or T
#: appended; the first four are tests/test_kernels.py's, then
#: grouped-query cases (at yi-6b's heads for D 128), then S != T, then
#: the tinyllama-1.1b prefill (B 4, S 2048) that the main path gives it
K2_SHAPES = [(1, 2, 2, 256, 64, "float32", True),
             (2, 1, 1, 128, 128, "bfloat16", True),
             (1, 4, 4, 384, 64, "float32", False),
             (2, 2, 2, 512, 32, "bfloat16", True),
             (2, 8, 2, 256, 64, "float32", True),
             (2, 8, 2, 256, 64, "bfloat16", True),
             (1, 32, 4, 1024, 128, "bfloat16", True),
             (2, 4, 1, 512, 32, "bfloat16", True),
             (2, 4, 2, 128, 64, "bfloat16", False, 384),
             (1, 4, 1, 128, 128, "bfloat16", False, 384),
             # head dims no kernel is built for, run padded to D 32: the
             # reduced configs' D 16 and D 14
             (2, 4, 2, 256, 16, "bfloat16", True),
             (2, 4, 2, 256, 16, "float32", True),
             (1, 4, 2, 128, 14, "bfloat16", True),
             (1, 4, 2, 128, 14, "float32", True)]
PREFILL_SHAPE = (4, 32, 4, 2048, 64, "bfloat16", True)
#: K2 at D 128 as models give it, B 4 x S 2048 prefills: qwen2-moe-a2.7b
#: (16 heads, 16 KV heads) and llama-3.2-vision-11b's self layers (32
#: heads, 8 KV heads); timed against the kernel's bound and SDPA
D128_SHAPES = ((4, 16, 16, 2048, 128, "bfloat16", True),
               (4, 32, 8, 2048, 128, "bfloat16", True))
#: K2's float32 kernel at the tinyllama-1.1b prefill shape: off the main
#: path (the compute dtype is bf16), checked and timed against its bound
#: at the float32 CUDA-core rate and against SDPA in float32
F32_PREFILL_SHAPE = (4, 32, 4, 2048, 64, "float32", True)
#: test_kernels.py's tolerances of the flash kernel against attention_ref
K2_TOL = {"float32": 1e-5, "bfloat16": 5e-2}
#: cycles the card spins before a held timing (``event_ms(hold=True)``):
#: ~50 ms at the H100's 1,980 MHz, far longer than the host takes to
#: issue 20 K2 calls
HOLD_CYCLES = 10 ** 8
#: the kernels' symbols, as the profiler names them: bf16 on the tensor
#: cores, float32 on the CUDA cores
K2_BF16_SYMBOL = "flash_attention_wgmma_kernel"
K2_F32_SYMBOL = "flash_attention_f32_kernel"

LM_ARCH = "tinyllama-1.1b"
PREFILL_BATCH, PREFILL_SEQ = 4, 2048
#: tolerances on logits (magnitude up to ~4) between two routes through
#: the same full-width forward: max and mean |difference|.  In bf16 two
#: summation orders of the same attention flip bf16 roundings that carry
#: through 22 layers: on the CPU at full width the port's einsum and
#: blocked attention routes differ by max 0.090, mean 0.0155 in the
#: last-token logits (B 4, S 512), and decode against the forward at
#: S 128 by max 0.107, mean 0.0148, with greedy tokens equal on 0.945 of
#: the positions.  The bf16 tolerances are about three times that spread.
#: In float32 the same arithmetic in another order: 1e-3 and 1e-4.
ROUTE_MAX = {"bfloat16": 0.25, "float32": 1e-3}
ROUTE_MEAN = {"bfloat16": 0.05, "float32": 1e-4}
DECODE_PROMPT = 128
#: decode vs cache-free forward: greedy tokens equal on at least this
#: share of the positions (the criterion of
#: tests/test_archs.py::test_decode_matches_forward)
DECODE_AGREE = 0.9
SERVE_REQUESTS, SERVE_SLOTS, SERVE_CACHE, SERVE_NEW = 8, 4, 256, 16
#: the other LM families, each at the full width of one published config:
#: (phase, arch, K2 launches per B 4 x S 2048 prefill).  qwen2-moe: one a
#: layer (D 128); mamba2: no attention; hymba: its 3 global layers (the
#: window layers take the einsum route); llama-vision: its 32 self layers
#: (the cross-attention over 1601 image tokens, not a multiple of 128,
#: takes the einsum route); whisper: its 12 decoder self layers (the
#: encoder's 1500 frames and the cross-attention take the einsum route)
LM_FAMILIES = (("lm-moe", "qwen2-moe-a2.7b", 24),
               ("lm-ssm", "mamba2-130m", 0),
               ("lm-hybrid", "hymba-1.5b", 3),
               ("lm-vlm", "llama-3.2-vision-11b", 32),
               ("lm-audio", "whisper-small", 12))
#: the families' decode check: this many steps at B 4 against the
#: cache-free forward of the same tokens (64 until PR 20, cut to keep the
#: phases inside the time limit on a slow host)
FAMILY_DECODE = 32

#: lm-train (a): full width, float32, card against CPU
TRAIN_CMP_BATCH, TRAIN_CMP_SEQ = 1, 128
#: tolerances, card against CPU, of one float32 step at full width: the
#: same float32 arithmetic in another summation order (cuBLAS against the
#: CPU's GEMMs, TF32 off) through 22 layers and back: loss relative,
#: grad norm relative, and each leaf's max |difference| over its max
#: |gradient|
TRAIN_LOSS_RTOL, TRAIN_GNORM_RTOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4, 1e-3
#: lm-train (b): the launcher's defaults, timed over TRAIN_STEPS steps
#: after TRAIN_WARMUP
TRAIN_STEPS, TRAIN_WARMUP = 8, 2
#: lm-train (c): the reduced-width run and its interruption
TRAIN_CLI_STEPS, TRAIN_CUT = 12, 6
#: lm-<family>-train: the layers kept where one card's 80 GB forces a
#: depth cut (full width always).  The timed step holds the float32
#: parameters, their gradient, two moments and the new parameters and
#: moments at once (36.6 B a parameter at tinyllama-1.1b, lm-train):
#: qwen2-moe-a2.7b whole is 14.32 B parameters and llama-3.2-vision-11b
#: 9.78 B, so the first keeps 2 of its 24 layers (all 60 experts top-4
#: and the 4 shared: 1.76 B) and the second one cross-attention group of
#: 5 of its 40 layers (2.14 B); mamba2-130m (0.17 B), hymba-1.5b (1.31 B)
#: and whisper-small (0.36 B) train whole
FAMILY_TRAIN_LAYERS = {"lm-moe": 2, "lm-vlm": 5}
#: lm-<family>-train (b): steps timed after TRAIN_WARMUP warm-up steps
FAMILY_TRAIN_STEPS = 5
#: lm-<family>-train (a): vlm's tanh gates start at zero, which zeroes
#: every gradient of its gated cross-attention blocks; the comparison
#: opens them to this value
VLM_GATE_OPEN = 0.5
#: the H100's dense bf16 tensor-core peak (data sheet, 700 W)
BF16_FLOPS_PER_S = 989e12

#: sweep-208's scenarios: (seed, knob overrides); scenario 0 is paper-208
SWEEP_SCENARIOS = ((0, {}), (0, {"migration_enabled": False}),
                   (1, {"eject_age_threshold": 8}),
                   (1, {"migrate_threshold": 1}))
#: BENCH_plan.json's smoke set (benchmarks/plan_throughput.py --smoke)
PLAN_MESHES, PLAN_SEEDS, PLAN_APP, PLAN_REFS = (((4, 4), (8, 8)), (0, 1),
                                               "equake", 10)
PLAN_MAX_CYCLES, PLAN_CHUNK = 20_000, 8
#: the sharded phase's grids: one NCCL rank; a 2x2 spatial split and a
#: (2, 2, 1) composed grid, each on four gloo ranks sharing cuda:0
SHARDED_SOLO, SHARDED_SPLIT, SHARDED_COMPOSED = (1, 1, 1), (1, 2, 2), \
    (2, 2, 1)
#: the rank of SHARDED_SPLIT whose tile (d) reports: (0, 1, 1), the tile
#: farthest from the mesh's origin
SHARDED_TILE_RANK = 3
#: seconds each group of ranks may take
SHARDED_TIMEOUT = 600

#: lm-sharded: four gloo ranks sharing cuda:0 on a (2, 2) mesh over
#: ("data", "model"); its checkpoint is restored on (1, 4) and on one rank
SHLM_MESH, SHLM_REMESH, SHLM_RANKS = (2, 2), (1, 4), 4
SHLM_AXES = ("data", "model")
#: the float32 train step's batch
SHLM_BATCH, SHLM_SEQ = 8, 256
#: lm-train (d)'s sequence at B 1: past BLOCK_THRESHOLD (2048 * 2048)
LONG_SEQ = 4096
#: lm-train (d): the blocked step's loss and grad norm against the einsum
#: route's on the same batch, relative (bf16 compute; the two sum the
#: scores' softmax in another order, both in float32)
LONG_LOSS_RTOL, LONG_GNORM_RTOL = 1e-2, 5e-2
#: the decode steps on the mesh (B = PREFILL_BATCH), from a zeroed cache
#: of SHLM_CACHE slots
SHLM_DECODE, SHLM_CACHE = 3, 64
#: seconds the group of ranks may take
SHLM_TIMEOUT = 900
#: the dry run's cells, run from the start by its launcher on the
#: production mesh ("single", 256 fake ranks); and the cell of the
#: lm-sharded phase, tinyllama-1.1b's bf16 prefill at B 4 x S 2048 on its
#: (2, 2) mesh, whose predicted parameter bytes a rank must equal what
#: each lm-sharded rank holds
DRYRUN_CELLS = (("tinyllama-1.1b", "train_4k"), ("noc-sim", "noc_43k"))
DRYRUN_TIMEOUT = 900
#: zoo-cli's family: patterns-tiny (10 scenarios at 4x4) with 4 refs a
#: core, up to 394 cycles (12 refs until PR 20: 1,162 cycles, 161.5 s of
#: the card's time, the longest phase)
ZOO_FAMILY = "patterns-tiny:refs=4"
SERIAL_FLAGS = ["--rows", "4", "--cols", "4", "--app", "matmul", "--refs",
                "12"]
#: seconds each launcher subprocess may take
CLI_TIMEOUT = 900


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def paper_config(cycles: int = PAPER_CYCLES):
    from repro_torch.core.config import SimConfig
    return SimConfig(rows=208, cols=208, max_cycles=cycles,
                     centralized_directory=False, dir_layout="home",
                     state_dtype_policy="packed")


def sweep_spec():
    """sweep-208's scenarios (6b) over paper-208's config."""
    from repro_torch.core.sweep import ScenarioSpec, SweepSpec
    return SweepSpec(paper_config(), tuple(
        ScenarioSpec("random", seed, 8, **kw) for seed, kw in SWEEP_SCENARIOS))


def event_ms(fn, iters: int, hold: bool = False) -> float:
    """Mean milliseconds per call of ``fn`` on the card's timeline, timed
    with CUDA events over ``iters`` back-to-back calls after a warm-up.
    Where the host issues work slower than the card runs it, this is the
    host's issue time, unless ``hold``: then the card spins for
    HOLD_CYCLES before the first event, while the host issues every
    call, and the time is the card's own."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
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

    # every case is launched before the one synchronise; the plain
    # version runs on the CPU copies of the same inputs
    sizes = list(range(1, 401)) + [127, 128, 129, 43_264]
    got, want = [], []
    for seed, n in enumerate(sizes):
        arrs = random_arb_case(np.random.default_rng(seed), n)
        host = [torch.from_numpy(a) for a in arrs]
        got.append(router_arbitrate_cuda(*[t.to(dev) for t in host]))
        want.append(arbitrate_ref(*host))
    got_a = torch.cat([a for a, _ in got]).cpu()
    got_d = torch.cat([d for _, d in got]).cpu()
    ref_a = torch.cat([a for a, _ in want])
    ref_d = torch.cat([d for _, d in want])
    max_err = 0
    for n, a, d, ra, rd in zip(sizes, got_a.split(sizes), got_d.split(sizes),
                               ref_a.split(sizes), ref_d.split(sizes)):
        err = max(int((a - ra).abs().max()), int((d != rd).sum()))
        if err:
            fail(f"kernel disagrees with arbitrate_ref at n={n} "
                 f"(max abs err {err})")
        max_err = max(max_err, err)
    print(f"kernel: router_arbitrate bit-exact against arbitrate_ref on "
          f"{len(sizes)} cases (n = 1..400, 127, 128, 129, 43264; the plain "
          f"version on CPU copies)")

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


def p2_bytes(args) -> int:
    """Bytes the fused Phase-2 kernel must move for these inputs: each
    input read once (of ``q_desc`` only the head rows), each output
    written once."""
    n = args["inp"].shape[0]
    nbytes = lambda t: t.numel() * t.element_size()  # noqa: E731
    read = (sum(nbytes(args[k]) for k in P2_ARGS if k != "q_desc")
            + n * args["q_desc"].shape[2] * args["q_desc"].element_size())
    # out, ej_port (int64), has_ej, the three queue words; stats and the
    # two 0-d counts
    written = n * (nbytes(args["inp"]) // n + 8 + 1 + 3 * 4) \
        + nbytes(args["stats"]) + 2 * 4
    return read + written


def midrun_phase2_inputs(cfg, trace, snapshots, dev):
    """Phase 2's inputs on the card at each snapshot cycle: the state
    after that many cycles, widened, then Phases 1a and 1b of the next
    cycle, as ``sim.cycle_step`` hands them to ``noc.phase2``."""
    from repro_torch.core.cache import phase1a, phase1b
    from repro_torch.core.sim import VectorSim
    from repro_torch.core.state import widen_state
    vs = VectorSim(cfg, trace, device=dev)
    out = []
    for c in range(max(snapshots) + 1):
        if c in snapshots:
            s = phase1b(phase1a(widen_state(vs.state), cfg, vs.ctx), cfg,
                        vs.ctx)
            ctx = vs.ctx
            out.append((c, dict(
                inp=s.inp, rob=s.rob, pc=s.pc, q_desc=s.q_desc,
                q_head=s.q_head, q_size=s.q_size, q_fid=s.q_fid,
                node_id=ctx.node_id, node_r=ctx.node_r, node_c=ctx.node_c,
                valid_port=ctx.valid_port, knob_ej_age=s.knob_ej_age,
                stats=s.stats)))
        if c < max(snapshots):
            vs.step()
    return out


def phase_kernel_phase2(dev):
    """The fused Phase-2 router kernel against its plain version; returns
    the kernel's record."""
    import numpy as np
    import torch
    from repro_torch.core.config import SimConfig
    from repro_torch.core.workloads import app_trace_loop, random_trace
    from repro_torch.kernels.ref import phase2_router_ref, random_phase2_case
    from repro_torch.kernels.router_phase import LAUNCHES, phase2_router_cuda

    max_err = 0

    def compare(card, cols, what):
        nonlocal max_err
        before = LAUNCHES.n
        got = phase2_router_cuda(*(card[k] for k in P2_ARGS), cols=cols)
        if LAUNCHES.n != before + 1:
            fail(f"kernel-phase2: {LAUNCHES.n - before} launches counted "
                 f"for one call ({what})")
        want = phase2_router_ref(*(card[k].cpu() for k in P2_ARGS),
                                 cols=cols)
        torch.cuda.synchronize()
        for name, g, w in zip(want._fields, got, want):
            if g.dtype != w.dtype or g.shape != w.shape:
                fail(f"kernel-phase2: {name} is {g.dtype} {tuple(g.shape)}, "
                     f"the plain version's {w.dtype} {tuple(w.shape)} "
                     f"({what})")
            err = int((g.cpu().long() - w.long()).abs().max()) \
                if w.numel() else 0
            if err:
                fail(f"kernel-phase2: {name} differs from "
                     f"phase2_router_ref by up to {err} ({what})")
            max_err = max(max_err, err)

    for seed, (n, k, depth, qp, rows, cols, off) in enumerate(P2_CASES):
        arrs = random_phase2_case(np.random.default_rng(seed), n, k, depth,
                                  qp, rows, cols)
        card = {}
        for name in P2_ARGS:
            t = torch.from_numpy(arrs[name]).to(dev)
            if off and t.dim() and t.shape[0] == n:
                # a contiguous view that starts off routers into its storage
                t = torch.cat([t[:off], t])[off:]
            card[name] = t
        compare(card, cols, f"seeded n={n} K={k} depth={depth} "
                            f"offset={off}")
    print(f"kernel-phase2: phase2_router bit-exact against "
          f"phase2_router_ref on {len(P2_CASES)} seeded cases (n = 1 to "
          f"43264, pending depth 1/2/4, offset views)")

    wedge = SimConfig(rows=16, cols=16, centralized_directory=False,
                      max_cycles=200_000)
    paper = paper_config()
    states = [("wedge", wedge, c, a) for c, a in midrun_phase2_inputs(
        wedge, app_trace_loop(wedge, "matmul", 20, 0), WEDGE_SNAPSHOTS, dev)]
    states += [("paper-208", paper, c, a) for c, a in midrun_phase2_inputs(
        paper, random_trace(paper, refs_per_core=8, seed=0),
        PAPER_SNAPSHOTS, dev)]
    for name, cfg, cyc, args in states:
        compare(args, cfg.cols, f"{name} after cycle {cyc}")
        flits = int((args["inp"][..., 0] > 0).sum())
        print(f"kernel-phase2: {name} mid-run state after {cyc} cycles "
              f"(+ phases 1a, 1b; {flits} flits in the network): "
              f"bit-exact")

    # timed at 43,264 routers on the paper run's own inputs (the timed
    # config: 64 refs/core, mid-run)
    cfg_t = paper_config(TIMED_CYCLES)
    (_, args), = midrun_phase2_inputs(
        cfg_t, random_trace(cfg_t, refs_per_core=64, seed=0), (16,), dev)
    vals = [args[k] for k in P2_ARGS]
    kernel = lambda: phase2_router_cuda(*vals, cols=cfg_t.cols)  # noqa: E731
    plain = lambda: phase2_router_ref(*vals, cols=cfg_t.cols)    # noqa: E731
    call_ms = event_ms(kernel, 500)
    plain_call_ms = event_ms(plain, 50)
    iters = 200
    _, kern = device_profile(kernel, iters)
    _, pl = device_profile(plain, 20)
    mine = {k: v for k, v in kern.items() if P2_SYMBOL in k}
    plain_launches = sum(v[1] for v in pl.values()) / 20
    if mine and pl:
        ms = sum(v[0] for v in mine.values()) / iters
        plain_ms = sum(v[0] for v in pl.values()) / 20
    else:
        print("kernel-phase2: torch.profiler recorded no device time; "
              "reporting the CUDA-event times")
        ms, plain_ms = call_ms, plain_call_ms
    n = cfg_t.num_nodes
    nbytes = p2_bytes(args)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = n * P2_OPS_PER_ROUTER / SCALAR_OPS_PER_S * 1e3
    print(f"kernel-phase2: n={n} (paper-208 after 16 cycles) device time "
          f"(torch.profiler): kernel {ms:.6f} ms, eager Phase 2 (plain "
          f"version on the card) {plain_ms:.6f} ms in {plain_launches:.1f} "
          f"launches a call; per call on the card's timeline (CUDA "
          f"events): kernel {call_ms:.6f} ms, eager {plain_call_ms:.6f} "
          f"ms; bound {max(bytes_ms, ops_ms):.6f} ms (bytes {bytes_ms:.6f}: "
          f"{nbytes} B, {nbytes / n:.1f} B a router, at 3.35 TB/s; ops "
          f"{ops_ms:.6f}); bound / kernel "
          f"{max(bytes_ms, ops_ms) / ms:.4f}; kernels {sorted(mine)}")
    return {
        "name": "phase2_router",
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


def wedge_case():
    """The former S14 wedge: (config, trace)."""
    from repro_torch.core.config import SimConfig
    from repro_torch.core.workloads import app_trace_loop

    cfg = SimConfig(rows=16, cols=16, centralized_directory=False,
                    max_cycles=200_000)
    return cfg, app_trace_loop(cfg, "matmul", 20, 0)


def wedge_on_cpu(src: str):
    """The wedge's CPU run (plain versions), in a child process started
    with the script: (statistics, seconds)."""
    sys.path.insert(0, src)
    import torch
    from repro_torch.core.sim import run

    torch.set_num_threads(2)
    cfg, tr = wedge_case()
    t0 = time.perf_counter()
    return run(cfg, tr, chunk=64, device="cpu"), time.perf_counter() - t0


def phase_wedge(dev, cpu_run) -> None:
    """The wedge on the card, against its CPU run (``cpu_run``, the
    future of ``wedge_on_cpu``)."""
    import torch
    from repro_torch.core.sim import run
    from repro_torch.kernels.router_phase import ARB_LAUNCHES, LAUNCHES

    cfg, tr = wedge_case()
    LAUNCHES.reset()
    ARB_LAUNCHES.reset()
    t0 = time.perf_counter()
    gpu = run(cfg, tr, chunk=64, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = LAUNCHES.n
    if gpu["finished"] != 1 or "aborted" in gpu:
        fail(f"wedge did not complete on the card: {gpu}")
    # the driver steps whole 64-cycle chunks, then cycle by cycle
    if not gpu["cycles"] <= launches < gpu["cycles"] + 64:
        fail(f"wedge: {launches} fused Phase-2 launches for "
             f"{gpu['cycles']} cycles, expected one a stepped cycle")
    if ARB_LAUNCHES.n:
        fail(f"wedge launched the standalone arbitration {ARB_LAUNCHES.n} "
             f"times")
    cpu, cpu_wall = cpu_run.result()
    if cpu != gpu:
        diff = {k: (cpu.get(k), gpu.get(k)) for k in set(cpu) | set(gpu)
                if cpu.get(k) != gpu.get(k)}
        fail(f"wedge: card and CPU statistics differ: {diff}")
    print(f"wedge: 16x16 completed in {gpu['cycles']} cycles "
          f"({gpu['send_drop']} drops recovered), card stats == CPU stats; "
          f"fused Phase-2 launches {launches}, standalone arbitration "
          f"{ARB_LAUNCHES.n}; card {wall:.3f} s "
          f"({gpu['cycles'] / wall:.1f} cycles/s), CPU {cpu_wall:.3f} s "
          f"(two threads, in a child process beside the earlier phases)")


def phase_paper(dev):
    """208x208 packed 32-cycle run against the JAX package's baseline;
    returns the launches of the fused Phase-2 kernel and of the
    standalone arbitration in that run, and the timed run's ms a
    cycle."""
    import torch
    from repro_torch.core.sim import VectorSim, run
    from repro_torch.core.workloads import random_trace
    from repro_torch.kernels.router_phase import ARB_LAUNCHES, LAUNCHES

    with open(os.path.join(ROOT, "BENCH_paper_scale.json")) as f:
        want = json.load(f)["raw"]["stats"]
    cfg = paper_config()
    tr = random_trace(cfg, refs_per_core=8, seed=0)
    LAUNCHES.reset()
    ARB_LAUNCHES.reset()
    t0 = time.perf_counter()
    got = run(cfg, tr, max_cycles=PAPER_CYCLES, chunk=PAPER_CYCLES,
              device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, arb_launches = LAUNCHES.n, ARB_LAUNCHES.n
    if got != want:
        diff = {k: (want.get(k), got.get(k)) for k in set(want) | set(got)
                if want.get(k) != got.get(k)}
        fail(f"208x208 statistics differ from BENCH_paper_scale.json: "
             f"{diff}")
    if launches != PAPER_CYCLES:
        fail(f"208x208: {launches} fused Phase-2 launches in {PAPER_CYCLES} "
             f"cycles, expected one a cycle")
    if arb_launches:
        fail(f"208x208: the standalone arbitration launched {arb_launches} "
             f"times, expected none")
    print(f"paper: 208x208 packed {PAPER_CYCLES} cycles == "
          f"BENCH_paper_scale.json raw.stats "
          f"({got['flits_delivered']} flits delivered, {got['hops']} hops); "
          f"fused Phase-2 launches {launches}, standalone arbitration "
          f"{arb_launches}; {wall:.3f} s including set-up")

    # a longer run at the same mesh, timed after a short warm-up run
    cfg_t = paper_config(TIMED_CYCLES)
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
    p2 = [v for k, v in kern.items() if P2_SYMBOL in k]
    p2_ms, p2_count = sum(v[0] for v in p2), sum(v[1] for v in p2)
    arb_count = sum(v[1] for k, v in kern.items() if "router_arbitrate" in k)
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:5]
    print(f"profile: 208x208 packed, {cycles} cycles: wall "
          f"{wall_ms / cycles:.3f} ms/cycle, device busy "
          f"{busy / cycles:.3f} ms/cycle (idle share "
          f"{1 - busy / wall_ms:.4f}), {launches_per_cycle:.1f} kernel "
          f"launches/cycle, {P2_SYMBOL} {p2_ms / cycles:.6f} ms/cycle "
          f"({p2_count / cycles:.1f}/cycle)")
    for name, (ms, count) in top:
        print(f"profile:   {ms / cycles:.6f} ms/cycle  "
              f"{count / cycles:.1f}/cycle  {name[:90]}")
    if kern and (p2_count != cycles or arb_count):
        fail(f"profile: {p2_count} {P2_SYMBOL} and {arb_count} "
             f"router_arbitrate launches in {cycles} cycles, expected one "
             f"fused launch a cycle and no other")
    return launches, arb_launches, wall_t / got_t["cycles"] * 1e3


def _diff(want, got) -> dict:
    return {k: (want.get(k), got.get(k)) for k in set(want) | set(got)
            if want.get(k) != got.get(k)}


def phase_sweep(dev, paper_ms: float):
    """Four scenarios of paper-208 in one ``run_sweep``; returns the fused
    Phase-2 launches of the sweep and its results."""
    import torch
    from repro_torch.core.engine import plan_state_bytes
    from repro_torch.core.sweep import run_sequential, run_sweep
    from repro_torch.kernels.router_phase import ARB_LAUNCHES, LAUNCHES

    with open(os.path.join(ROOT, "BENCH_paper_scale.json")) as f:
        want0 = json.load(f)["raw"]["stats"]
    spec = sweep_spec()
    cfg = spec.cfg
    b = spec.size
    spec.traces()                      # host set-up, outside the timing
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    LAUNCHES.reset()
    ARB_LAUNCHES.reset()
    t0 = time.perf_counter()
    got = run_sweep(spec, max_cycles=PAPER_CYCLES, chunk=PAPER_CYCLES,
                    device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, arb_launches = LAUNCHES.n, ARB_LAUNCHES.n
    peak = torch.cuda.max_memory_allocated(dev) - base_mem
    if got[0] != want0:
        fail(f"sweep-208: scenario 0 differs from BENCH_paper_scale.json: "
             f"{_diff(want0, got[0])}")
    if launches != b * PAPER_CYCLES or arb_launches:
        fail(f"sweep-208: {launches} fused Phase-2 launches and "
             f"{arb_launches} standalone arbitrations, expected "
             f"{b * PAPER_CYCLES} and 0")
    t0 = time.perf_counter()
    solo = run_sequential(spec, max_cycles=PAPER_CYCLES, chunk=PAPER_CYCLES,
                          device=dev)
    torch.cuda.synchronize()
    solo_wall = time.perf_counter() - t0
    for i, (g, w) in enumerate(zip(got, solo)):
        if g != w:
            fail(f"sweep-208: scenario {i} differs from its solo run on the "
                 f"card: {_diff(w, g)}")
    plan_bytes = plan_state_bytes(cfg, b, "sweep", (1, 1, 1), 1,
                                  trace_len=spec.traces().shape[-1])
    per = wall / (b * PAPER_CYCLES) * 1e3
    solo_per = solo_wall / (b * PAPER_CYCLES) * 1e3
    for i, g in enumerate(got):
        print(f"sweep-208: scenario {i} {SWEEP_SCENARIOS[i]}: "
              f"{g['flits_delivered']} flits delivered, {g['hops']} hops, "
              f"{g['migrations']} migrations == its solo run")
    distinct = len({json.dumps(g, sort_keys=True) for g in got})
    print(f"sweep-208: {b} scenarios x {PAPER_CYCLES} cycles ({distinct} "
          f"distinct results), scenario 0 == "
          f"BENCH_paper_scale.json raw.stats; fused Phase-2 launches "
          f"{launches}, standalone arbitration {arb_launches}; "
          f"{wall:.3f} s set-up included: {per:.3f} ms per scenario-cycle "
          f"(solo runs of the same scenarios {solo_per:.3f}, paper-208's "
          f"timed run {paper_ms:.3f} ms a cycle); peak device memory "
          f"{peak} B over the {base_mem} B held before, "
          f"plan_state_bytes {plan_bytes} B (peak / plan "
          f"{peak / plan_bytes:.3f}); card: {card_line()}")
    return launches, got


def tile_phase2_check(sim) -> dict:
    """(d): each local scenario's Phase-2 inputs on this rank's tile
    (widened, then Phases 1a and 1b of the next cycle, as the tile step
    hands them to ``noc.phase2``), through the fused kernel and through
    its plain version on CPU copies; every output must agree exactly."""
    import torch
    from repro_torch.core.cache import phase1a, phase1b
    from repro_torch.core.state import widen_state
    from repro_torch.kernels.ref import phase2_router_ref
    from repro_torch.kernels.router_phase import phase2_router_cuda
    ctx, cfg = sim.ctx, sim.cfg
    flits, max_err = 0, 0
    with torch.inference_mode():
        for st in sim.states:
            s = phase1b(phase1a(widen_state(st), cfg, ctx), cfg, ctx)
            args = dict(inp=s.inp, rob=s.rob, pc=s.pc, q_desc=s.q_desc,
                        q_head=s.q_head, q_size=s.q_size, q_fid=s.q_fid,
                        node_id=ctx.node_id, node_r=ctx.node_r,
                        node_c=ctx.node_c, valid_port=ctx.valid_port,
                        knob_ej_age=s.knob_ej_age, stats=s.stats)
            got = phase2_router_cuda(*(args[k] for k in P2_ARGS),
                                     cols=cfg.cols)
            want = phase2_router_ref(*(args[k].cpu() for k in P2_ARGS),
                                     cols=cfg.cols)
            torch.cuda.synchronize()
            for name, g, w in zip(want._fields, got, want):
                if g.dtype != w.dtype or g.shape != w.shape:
                    raise AssertionError(f"{name}: {g.dtype} {g.shape} vs "
                                         f"{w.dtype} {w.shape}")
                err = int((g.cpu().long() - w.long()).abs().max()) \
                    if w.numel() else 0
                max_err = max(max_err, err)
            flits += int((args["inp"][..., 0] > 0).sum())
    return {"max_abs_err": max_err, "flits": flits,
            "first_id": int(ctx.node_id[0]), "routers": int(ctx.node.numel())}


def sharded_rank(grid, composed: bool, check_tile: bool) -> dict:
    """One rank of the sharded phase, in a subprocess: paper-208 through
    ``ShardedSim`` (``composed``: sweep-208 through ``run_composed``),
    this rank's fused and standalone launches, its wall ms a cycle, and
    on request (d) on its tile."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.sharded import ProcessGrid, ShardedSim, \
        run_composed
    from repro_torch.core.workloads import random_trace
    from repro_torch.kernels.router_phase import ARB_LAUNCHES, LAUNCHES
    out = {"backend": dist.get_backend(),
           "device": torch.cuda.current_device()}
    if composed:
        spec = sweep_spec()
        spec.traces()                           # host set-up, untimed
        run_composed(spec, grid, 2, 2)          # warm-up
        torch.cuda.synchronize()
        LAUNCHES.reset()
        ARB_LAUNCHES.reset()
        t0 = time.perf_counter()
        out["res"] = run_composed(spec, grid, PAPER_CYCLES, PAPER_CYCLES)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["what"] = "set-up included, after a warm-up run"
        out.update(launches=LAUNCHES.n, arb=ARB_LAUNCHES.n)
    else:
        cfg = paper_config()
        tr = random_trace(cfg, refs_per_core=8, seed=0)
        pg = ProcessGrid(*grid)
        try:
            # a short warm-up run first: the timed one then starts warm
            ShardedSim(cfg, tr, pg).run(2, chunk=2)
            sim = ShardedSim(cfg, tr, pg)
            torch.cuda.synchronize()
            LAUNCHES.reset()
            ARB_LAUNCHES.reset()
            t0 = time.perf_counter()
            out["res"] = sim.run(PAPER_CYCLES, chunk=PAPER_CYCLES)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            out.update(launches=LAUNCHES.n, arb=ARB_LAUNCHES.n,
                       what="run only, after a warm-up run",
                       routers=int(sim.ctx.node.numel()))
            if check_tile:
                out["tile"] = tile_phase2_check(sim)
        finally:
            pg.close()
    out["ms"] = wall / PAPER_CYCLES * 1e3
    return out


def gloo_cuda_collectives() -> list:
    """On a gloo rank whose device is a CUDA card: the collectives that
    take CUDA tensors and give the right sums.  The sharded backend's
    termination and statistics all-reduces need ``all_reduce``; its
    halo slabs go point to point through host tensors, since gloo's
    send/recv of a CUDA tensor aborts the rank
    (``tests/test_torch_gpu.py``)."""
    import torch
    import torch.distributed as dist
    dev = torch.device("cuda", torch.cuda.current_device())
    r, n = dist.get_rank(), dist.get_world_size()
    t = torch.full((4,), r + 1, device=dev, dtype=torch.int32)
    dist.all_reduce(t)
    ok = ["all_reduce"] if t.tolist() == [n * (n + 1) // 2] * 4 else []
    t = torch.full((4,), r + 5, device=dev, dtype=torch.int32)
    dist.broadcast(t, 0)
    ok += ["broadcast"] if t.tolist() == [5] * 4 else []
    parts = [torch.empty(4, device=dev, dtype=torch.int32) for _ in range(n)]
    dist.all_gather(parts, torch.full((4,), r, device=dev,
                                      dtype=torch.int32))
    ok += ["all_gather"] if [p.tolist() for p in parts] == [
        [i] * 4 for i in range(n)] else []
    dist.barrier()
    return ok


def phase_sharded(sweep_got) -> int:
    """(a)-(d) of the sharded phase; returns the fused Phase-2 launches
    of its main-path runs, over every rank."""
    from repro_torch.dist import spawn

    ops = spawn(gloo_cuda_collectives, 2, device="cuda:0", backend="gloo",
                timeout_s=SHARDED_TIMEOUT)
    if any("all_reduce" not in o for o in ops):
        fail(f"sharded: gloo's all_reduce of CUDA tensors is wrong: {ops}")
    print(f"sharded: gloo collectives of CUDA tensors with the right result "
          f"on both ranks: {ops[0]}")

    with open(os.path.join(ROOT, "BENCH_paper_scale.json")) as f:
        want = json.load(f)["raw"]["stats"]
    runs = (
        ("(a) 1 NCCL rank", SHARDED_SOLO, "nccl", False, want, 1),
        ("(b) 2x2 on 4 gloo ranks", SHARDED_SPLIT, "gloo", False, want, 1),
        ("(c) composed (2, 2, 1) on 4 gloo ranks", SHARDED_COMPOSED, "gloo",
         True, sweep_got, 2))
    total = 0
    for name, grid, backend, composed, expect, local in runs:
        n = grid[0] * grid[1] * grid[2]
        t0 = time.perf_counter()
        outs = spawn(sharded_rank, n, (grid, composed,
                                       grid == SHARDED_SPLIT),
                     device="cuda:0", backend=backend,
                     timeout_s=SHARDED_TIMEOUT)
        wall = time.perf_counter() - t0
        for r, o in enumerate(outs):
            if o["backend"] != backend or o["device"] != 0:
                fail(f"sharded {name}: rank {r} ran {o['backend']} on "
                     f"cuda:{o['device']}")
            if o["res"] != expect:
                diff = (_diff(expect, o["res"]) if isinstance(expect, dict)
                        else [_diff(w, g) for w, g in zip(expect, o["res"])])
                fail(f"sharded {name}: rank {r}'s statistics differ: {diff}")
            if o["launches"] != local * PAPER_CYCLES or o["arb"]:
                fail(f"sharded {name}: rank {r} launched the fused kernel "
                     f"{o['launches']} times and the standalone arbitration "
                     f"{o['arb']}, expected {local * PAPER_CYCLES} and 0")
        total += sum(o["launches"] for o in outs)
        what = ("BENCH_paper_scale.json raw.stats" if isinstance(expect, dict)
                else "sweep-208's four results")
        print(f"sharded {name}: every rank == {what}; fused Phase-2 "
              f"launches {[o['launches'] for o in outs]}, standalone "
              f"arbitration 0; {wall:.1f} s with the ranks' start")
        print(f"sharded {name}: ms a cycle by rank ({outs[0]['what']}; ranks "
              f"time-sharing one card and one host, not a scaling result): "
              f"{[round(o['ms'], 3) for o in outs]}; card: {card_line()}")
        if grid != SHARDED_SPLIT:
            continue
        for r, o in enumerate(outs):
            if o["tile"]["max_abs_err"]:
                fail(f"sharded (d): the fused kernel differs from "
                     f"phase2_router_ref by up to {o['tile']['max_abs_err']}"
                     f" on rank {r}'s tile")
        tile = outs[SHARDED_TILE_RANK]["tile"]
        print(f"sharded (d): every rank's tile after {PAPER_CYCLES} cycles "
              f"+ phases 1a, 1b: fused kernel bit-exact against "
              f"phase2_router_ref; rank {SHARDED_TILE_RANK}'s tile has "
              f"{tile['routers']} routers from node {tile['first_id']} and "
              f"{tile['flits']} flits in flight")
    return total


def phase_plan(dev) -> int:
    """BENCH_plan.json's smoke set through the planner on the card, its
    network health collected and gated by the port's ``bench``; returns
    the fused Phase-2 launches of the plan's run."""
    import torch
    from repro_torch.bench import (BenchReport, compare_reports, gate_passes,
                                   render_findings)
    from repro_torch.bench.collect import health_metrics
    from repro_torch.core.config import SimConfig
    from repro_torch.core.engine import (compile_plan, execute_plan,
                                         make_scenario)
    from repro_torch.kernels.router_phase import ARB_LAUNCHES, LAUNCHES

    bench = BenchReport.read(os.path.join(ROOT, "BENCH_plan.json"))
    want = BenchReport("plan", metrics=[m for m in bench.metrics
                                        if m.name.startswith("plan.net.")])
    base = SimConfig(centralized_directory=False, max_cycles=PLAN_MAX_CYCLES)
    scenarios = [make_scenario(base, r, c, PLAN_APP, seed, PLAN_REFS)
                 for r, c in PLAN_MESHES for seed in PLAN_SEEDS]
    plan = compile_plan(scenarios)
    desc = plan.describe()
    if desc != bench.raw["planned_sweep"]["plan"] or desc["n_buckets"] != 2:
        fail(f"plan: {desc} differs from BENCH_plan.json's plan "
             f"{bench.raw['planned_sweep']['plan']}")
    LAUNCHES.reset()
    ARB_LAUNCHES.reset()
    t0 = time.perf_counter()
    got = execute_plan(plan, chunk=PLAN_CHUNK, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, arb_launches = LAUNCHES.n, ARB_LAUNCHES.n
    if not all(g["finished"] == 1 for g in got):
        fail(f"plan: not every scenario finished: {got}")
    steps = sum(b.batch * max(got[i]["cycles"] for i in b.indices)
                for b in plan.buckets)
    if not steps <= launches < steps + len(got) * PLAN_CHUNK or arb_launches:
        fail(f"plan: {launches} fused Phase-2 launches and {arb_launches} "
             f"standalone arbitrations, expected one a scenario-step "
             f"({steps}) and none")
    # the collector rounds as the file's writer did: every plan.net.*
    # metric equal to the file's, then the gate over them
    fresh = BenchReport("plan", metrics=health_metrics(
        got, "plan.net", tags={"app": PLAN_APP}))
    if want.names() != fresh.names() or len(want.names()) != 5:
        fail(f"plan: plan.net.* metrics {fresh.names()}, BENCH_plan.json "
             f"has {want.names()}")
    for m in want.metrics:
        if fresh.metric(m.name) != m:
            fail(f"plan: {fresh.metric(m.name)} differs from "
                 f"BENCH_plan.json's {m}")
    findings = compare_reports(want, fresh)
    print(render_findings("plan", findings))
    if not gate_passes(findings):
        fail("plan: compare_reports fails plan.net.* against "
             "BENCH_plan.json")
    net = {m.name: m.value for m in fresh.metrics}
    print(f"plan: {len(got)} scenarios in {desc['n_buckets']} buckets "
          f"({[(b['rows'], b['cols'], b['batch']) for b in desc['buckets']]}"
          f"), plan == BENCH_plan.json's, all finished (cycles "
          f"{[g['cycles'] for g in got]}); repro_torch.bench.collect."
          f"health_metrics {net} == BENCH_plan.json plan.net.*, "
          f"compare_reports passes; fused "
          f"Phase-2 launches {launches}, standalone arbitration "
          f"{arb_launches}; {wall:.3f} s")
    return launches


def phase_build() -> None:
    """Build both kernels at once: one nvcc per source, started together."""
    from repro_torch.kernels.build import build
    names = ("router_arbitrate", "flash_attention")
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        futures = {n: pool.submit(build, n) for n in names}
    for n in names:
        built = futures[n].result()       # re-raises a failed build
        print(f"build: {built.path.name} in {built.seconds:.1f} s")
        for line in built.log.strip().splitlines():
            print(f"build: {line}")
    print(f"build: both kernels in {time.perf_counter() - t0:.1f} s")


def k2_case(shape, dev, seed: int = 0):
    """Seeded (q, k, v) on the card for a K2 shape: with numpy, as the
    tests make them, at the small shapes; on the card at the prefill
    shape."""
    import numpy as np
    import torch
    b, h, kv, s, d, dt, _, *t = shape
    t = t[0] if t else s
    dtype = getattr(torch, dt)
    shapes = ((b, h, s, d), (b, kv, t, d), (b, kv, t, d))
    if shape in (PREFILL_SHAPE, F32_PREFILL_SHAPE) or shape in D128_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(seed)
        return [torch.randn(sh, generator=gen, device=dev).to(dtype)
                for sh in shapes]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(sh)).to(dev, dtype)
            for sh in shapes]


def phase_kernel_k2(dev):
    """K2 against attention_ref; returns the kernel's record."""
    import torch
    from repro_torch.kernels.flash_attention import (LAUNCHES,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ref import attention_ref

    # every case launched, kernel and plain version, before one
    # synchronise
    runs = []
    for shape in K2_SHAPES + [PREFILL_SHAPE, F32_PREFILL_SHAPE,
                              *D128_SHAPES]:
        causal = shape[6]
        q, k, v = k2_case(shape, dev)
        before = LAUNCHES.n
        got = flash_attention_cuda(q, k, v, causal=causal)
        if LAUNCHES.n != before + 1:
            fail(f"K2 counted {LAUNCHES.n - before} launches for one call "
                 f"at {shape}")
        runs.append((shape, got, attention_ref(q, k, v, causal=causal)))
        del q, k, v
    torch.cuda.synchronize()
    for shape, got, want in runs:
        b, h, kv, s, d, dt, causal, *t = shape
        if not bool(torch.isfinite(got.float()).all()):
            fail(f"K2 output not finite at {shape}")
        err = float((got.float() - want.float()).abs().max())
        if not err < K2_TOL[dt]:
            fail(f"K2 disagrees with attention_ref at {shape}: max abs err "
                 f"{err} (tolerance {K2_TOL[dt]})")
        print(f"kernel-K2: (B, H, KV, S, T, D) = "
              f"{(b, h, kv, s, t[0] if t else s, d)} {dt} causal={causal}: "
              f"max |err| vs attention_ref {err:.3e} (tolerance "
              f"{K2_TOL[dt]})")
        if shape == PREFILL_SHAPE:
            prefill_err = err
        if shape == F32_PREFILL_SHAPE:
            f32_err = err
    del runs, got, want

    rec = k2_timed(PREFILL_SHAPE, dev, "tinyllama-1.1b prefill")
    for shape, what in zip(D128_SHAPES, ("qwen2-moe-a2.7b prefill, D 128",
                                         "llama-3.2-vision-11b prefill, "
                                         "D 128")):
        k2_timed(shape, dev, what)
    f32 = k2_timed(F32_PREFILL_SHAPE, dev, "tinyllama-1.1b prefill shape, "
                   "float32 (off the main path)")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:22",
        "launches": None,
        "max_abs_err": prefill_err,
        **rec,
        **{f"float32_{k}": x for k, x in f32.items()},
        "float32_max_abs_err": f32_err,
    }


def k2_timed(shape, dev, what: str) -> dict:
    """K2, its plain version and ``scaled_dot_product_attention`` (the
    library yardstick, never called by the port) timed at a causal shape
    in the shape's dtype, bf16 or float32; prints one line and returns
    the timing keys of K2's record (float32: also the launches the timing
    made)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (F32_LAUNCHES,
                                                     flash_attention_cuda)
    from repro_torch.kernels.ref import attention_ref

    b, h, kv, s, d, dt, causal = shape
    f32 = dt == "float32"
    symbol = K2_F32_SYMBOL if f32 else K2_BF16_SYMBOL
    q, k, v = k2_case(shape, dev, seed=1)
    f32_before = F32_LAUNCHES.n
    kernel = lambda: flash_attention_cuda(q, k, v, causal=True)  # noqa: E731
    plain = lambda: attention_ref(q, k, v, causal=True)          # noqa: E731
    if f32:
        # K and V expanded to H heads before the timed call, so that a
        # fused backend can take float32 without grouped-query support
        ke, ve = (x.repeat_interleave(h // kv, dim=1) for x in (k, v))
        library = lambda: F.scaled_dot_product_attention(       # noqa: E731
            q, ke, ve, is_causal=True)
    else:
        library = lambda: F.scaled_dot_product_attention(       # noqa: E731
            q, k, v, is_causal=True, enable_gqa=True)
    lib_err = float((library().float() - plain().float()).abs().max())
    # the card held while the host issues the calls: each time is the
    # card's.  torch.profiler's device times are printed beside: on some
    # machines they read about half of what CUDA events and the host's
    # clock agree on
    ms = event_ms(kernel, 20, hold=True)
    plain_ms = event_ms(plain, 3, hold=True)
    lib_ms = event_ms(library, 20, hold=True)
    iters = 10
    _, kern = device_profile(kernel, iters)
    _, pl = device_profile(plain, 3)
    _, lib = device_profile(library, iters)
    mine = {n: v for n, v in kern.items() if "flash_attention" in n}
    if mine and not any(symbol in n for n in mine):
        fail(f"K2 at {shape} ran {sorted(mine)}, not {symbol}")
    if mine and pl and lib:
        prof = (sum(v[0] for v in mine.values()) / iters,
                sum(v[0] for v in pl.values()) / 3,
                sum(v[0] for v in lib.values()) / iters)
        off = max(abs(p / e - 1) for p, e in zip(prof, (ms, plain_ms,
                                                        lib_ms)))
        prof_txt = (f"kernel {prof[0]:.6f}, plain {prof[1]:.6f}, library "
                    f"{prof[2]:.6f} ms, at most {off:.1%} from the events")
    else:
        prof_txt = "no device time recorded"
    # causal S == T: query s sees s + 1 keys; two products of 2*D FLOP a
    # (query, key) pair, at the tensor cores' bf16 rate or the CUDA
    # cores' float32 rate; each input read once, the output written once
    pairs = s * (s + 1) // 2 if causal else s * s
    flop = 4 * d * pairs * b * h
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    rate, rate_name = ((SCALAR_OPS_PER_S, "67 TFLOP/s float32") if f32
                       else (BF16_FLOP_PER_S, "989 TFLOP/s bf16"))
    flop_ms = flop / rate * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"kernel-K2: {what} (B, H, KV, S, D) = {(b, h, kv, s, d)} {dt} "
          f"per call on the card (CUDA events, the card held while the "
          f"host issues): kernel {ms:.6f} ms ({flop / ms / 1e9:.1f} "
          f"TFLOP/s), plain {plain_ms:.6f} ms ({len(pl)} kernels), "
          f"scaled_dot_product_attention {lib_ms:.6f} ms (max |diff| vs "
          f"plain {lib_err:.3e}; kernels {sorted(lib)}); torch.profiler "
          f"device time: {prof_txt}; bound "
          f"{max(flop_ms, bytes_ms):.6f} ms (operations {flop_ms:.6f}: "
          f"{flop:.4e} FLOP at {rate_name}; bytes {bytes_ms:.6f}: "
          f"{nbytes} B at 3.35 TB/s); kernel / library {ms / lib_ms:.3f}, "
          f"bound / kernel {max(flop_ms, bytes_ms) / ms:.4f}; kernels "
          f"{sorted(mine)} (checked for {symbol})")
    rec = {"ms": ms, "plain_ms": plain_ms,
           "bound_ms": max(flop_ms, bytes_ms),
           "bound_by": "operations" if flop_ms >= bytes_ms else "bytes",
           "library_ms": lib_ms}
    if f32:
        rec["timing_launches"] = F32_LAUNCHES.n - f32_before
    return rec


def _route_err(a, b, dt: str, what: str):
    """(max, mean) |a - b| over logits; fails past ROUTE_MAX/ROUTE_MEAN."""
    d = (a.float() - b.float()).abs()
    err, mean = float(d.max()), float(d.mean())
    if not (err < ROUTE_MAX[dt] and mean < ROUTE_MEAN[dt]):
        fail(f"{what}, {dt}: max |err| {err}, mean {mean} (tolerances "
             f"{ROUTE_MAX[dt]}, {ROUTE_MEAN[dt]})")
    return err, mean


def profile_lines(name: str, fn, steps: int = 1, top: int = 5) -> dict:
    """One profiled run of ``fn`` (``steps`` calls or decode steps inside
    it), printed per call or step: wall, device busy, idle share,
    launches, K2's device time and kernels, and the largest kernels.
    Returns ``{kernel name: (device ms, launches)}``."""
    wall_ms, kern = device_profile(fn, 1)
    busy = sum(v[0] for v in kern.values())
    k2_names = {n: v for n, v in kern.items() if "flash_attention" in n}
    k2 = sum(v[0] for v in k2_names.values())
    print(f"{name} profile: per {'call' if steps == 1 else 'step'}: wall "
          f"{wall_ms / steps:.3f} ms (under the profiler), device busy "
          f"{busy / steps:.3f} ms (idle share {1 - busy / wall_ms:.4f}), "
          f"{sum(v[1] for v in kern.values()) / steps:.1f} kernel launches, "
          f"K2 {k2 / steps:.3f} ms ({k2 / max(busy, 1e-9):.3f} of device "
          f"time)")
    for kname, (ms, count) in sorted(k2_names.items()):
        print(f"{name} profile:   K2 {ms / steps:.3f} ms  "
              f"{count / steps:.1f}x  {kname}")
    for kname, (ms, count) in sorted(kern.items(),
                                     key=lambda kv: -kv[1][0])[:top]:
        print(f"{name} profile:   {ms / steps:.3f} ms  {count / steps:.1f}x"
              f"  {kname[:90]}")
    return kern


def phase_lm_prefill(dev):
    """Full-width tinyllama-1.1b prefill; returns (cfg, params, K2
    launches in the prefill step)."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import F32_LAUNCHES, LAUNCHES
    from repro_torch.models import api, common
    from repro_torch.train import step

    # float32 products in float32, and split-K sums of bf16 products in
    # float32: the route comparisons below then see attention's order only
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = registry.get(LM_ARCH)
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0)                  # default: cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for sub in (params, params["layers"]["attn"],
                                         params["layers"]["mlp"])
                   for t in sub.values() if isinstance(t, torch.Tensor))
    if n_params != cfg.n_params():
        fail(f"lm-prefill: {n_params} parameters, config says "
             f"{cfg.n_params()}")
    batch = api.make_inputs(cfg, "prefill", PREFILL_BATCH, PREFILL_SEQ,
                            np.random.default_rng(0))
    prefill = step.make_prefill_step(cfg)

    LAUNCHES.reset()
    f32_before = F32_LAUNCHES.n
    t0 = time.perf_counter()
    last = prefill(params, batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = LAUNCHES.n
    if launches != cfg.n_layers or F32_LAUNCHES.n != f32_before:
        fail(f"lm-prefill: K2 launched {launches} times, "
             f"{F32_LAUNCHES.n - f32_before} of them float32, expected "
             f"{cfg.n_layers} (one a layer), all bf16")
    if last.shape != (PREFILL_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(last.float()).all()):
        fail(f"lm-prefill: last-token logits {tuple(last.shape)} not "
             f"finite or of the wrong shape")
    reps = 3
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill(params, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with common.einsum_route():
        ref = prefill(params, batch)
    err, mean = _route_err(last, ref, "bfloat16",
                           "lm-prefill: kernel route vs einsum route")
    agree = float((last.float().argmax(-1) == ref.float().argmax(-1))
                  .float().mean())
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    prefill32 = step.make_prefill_step(cfg32)
    last32 = prefill32(params, batch)
    with common.einsum_route():
        ref32 = prefill32(params, batch)
    err32, mean32 = _route_err(last32, ref32, "float32",
                               "lm-prefill: kernel route vs einsum route")
    print(f"lm-prefill: {LM_ARCH} full width ({cfg.n_layers} layers, "
          f"{n_params} params, init {init_s:.3f} s), B={PREFILL_BATCH} "
          f"S={PREFILL_SEQ} bf16: K2 launches {launches}; first call "
          f"{first_s:.3f} s; {wall_ms:.3f} ms per prefill "
          f"({PREFILL_BATCH * PREFILL_SEQ / wall_ms * 1e3:.1f} tok/s); "
          f"last-token logits max |logit| {float(last.float().abs().max()):.3f}, "
          f"vs einsum route max |err| {err:.4e}, mean {mean:.4e} "
          f"(tolerances {ROUTE_MAX['bfloat16']}, "
          f"{ROUTE_MEAN['bfloat16']}), argmax agree {agree:.3f}; float32 "
          f"compute: max |err| {err32:.4e}, mean {mean32:.4e} "
          f"(tolerances {ROUTE_MAX['float32']}, {ROUTE_MEAN['float32']})")

    kern = profile_lines("lm-prefill", lambda: prefill(params, batch),
                         top=6)
    k2_names = [n for n in kern if "flash_attention" in n]
    if kern and not any(K2_BF16_SYMBOL in n for n in k2_names):
        fail(f"lm-prefill: the profile names no {K2_BF16_SYMBOL} among "
             f"K2's kernels {sorted(k2_names)}")
    return cfg, params, launches


def phase_lm_decode(dev, cfg, params) -> None:
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import api

    b = PREFILL_BATCH
    tokens = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (b, DECODE_PROMPT)), dtype=torch.int32, device=dev)
    LAUNCHES.reset()
    full, _ = api.forward_logits(cfg, params, {"tokens": tokens})
    torch.cuda.synchronize()
    fwd_launches = LAUNCHES.n
    if fwd_launches != cfg.n_layers:
        fail(f"lm-decode: the S={DECODE_PROMPT} forward launched K2 "
             f"{fwd_launches} times, expected {cfg.n_layers}")
    cache = api.init_cache(cfg, b, DECODE_PROMPT)
    LAUNCHES.reset()
    outs = []
    t0 = time.perf_counter()
    for t in range(DECODE_PROMPT):
        lg, cache = api.decode_step(cfg, params, cache, tokens[:, t:t + 1])
        outs.append(lg)
    torch.cuda.synchronize()
    dec_s = time.perf_counter() - t0
    if LAUNCHES.n != 0:
        fail(f"lm-decode: decode steps launched K2 {LAUNCHES.n} times")
    got = torch.stack(outs, 1)
    if not bool(torch.isfinite(got.float()).all()):
        fail("lm-decode: logits not finite")
    last_err, last_mean = _route_err(got[:, -1], full[:, -1], "bfloat16",
                                     "lm-decode: last logits vs forward")
    agree = float((got.float().argmax(-1) == full.float().argmax(-1))
                  .float().mean())
    if agree < DECODE_AGREE:
        fail(f"lm-decode: greedy tokens equal the forward's on {agree} of "
             f"the positions (at least {DECODE_AGREE})")
    print(f"lm-decode: {DECODE_PROMPT} tokens x B={b} one at a time "
          f"through decode_step (K2 launches 0) vs the cache-free forward "
          f"(K2 launches {fwd_launches}): last logits max |err| "
          f"{last_err:.4e}, mean {last_mean:.4e}, greedy agreement "
          f"{agree:.4f}; "
          f"{dec_s / DECODE_PROMPT * 1e3:.3f} ms per step "
          f"({b * DECODE_PROMPT / dec_s:.1f} tok/s)")
    cache = api.init_cache(cfg, b, SERVE_CACHE)
    steps = 8
    state = {"c": cache}

    def window():
        for t in range(steps):
            _, state["c"] = api.decode_step(cfg, params, state["c"],
                                            tokens[:, t:t + 1])
    print(f"lm-decode profile: {steps} steps, cache_len {SERVE_CACHE}")
    profile_lines("lm-decode", window, steps)


def _serve(cfg, params, device, n, slots, cache_len, max_new, seed=0):
    """Requests seeded as ``repro_torch.launch.serve`` makes them, served
    to the end; returns (finished requests, seconds, batched decode
    steps)."""
    import numpy as np
    import torch
    from repro_torch.serve.server import Request, Server
    server = Server(cfg, params, slots=slots, cache_len=cache_len,
                    seed=seed, device=device)
    rng = np.random.default_rng(seed)
    for rid in range(n):
        prompt = rng.integers(0, cfg.vocab,
                              size=int(rng.integers(2, 9))).astype(np.int32)
        server.submit(Request(rid=rid, prompt=prompt, max_new=max_new))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = server.run_until_drained()
    return done, time.perf_counter() - t0, int(server.cache["idx"])


def phase_lm_serve(dev, cfg, params) -> None:
    from repro_torch import convert
    from repro_torch.configs import registry
    from repro_torch.models import api

    done, secs, steps = _serve(cfg, params, dev, SERVE_REQUESTS,
                               SERVE_SLOTS, SERVE_CACHE, SERVE_NEW)
    if len(done) != SERVE_REQUESTS or any(
            len(r.out) != SERVE_NEW or not all(0 <= t < cfg.vocab
                                               for t in r.out)
            for r in done):
        fail(f"lm-serve: {len(done)} of {SERVE_REQUESTS} requests done, "
             f"tokens {[r.out for r in done]}")
    toks = sum(len(r.out) for r in done)
    for r in sorted(done, key=lambda r: r.rid):
        print(f"lm-serve: request {r.rid}: prompt {r.prompt.tolist()} -> "
              f"{r.out}")
    print(f"lm-serve: {LM_ARCH} full width, {len(done)} requests / {toks} "
          f"tokens in {secs:.3f} s ({toks / secs:.1f} tok/s) with "
          f"{SERVE_SLOTS} slots, cache_len {SERVE_CACHE}: {steps} batched "
          f"decode steps, {secs / steps * 1e3:.3f} ms per step")

    # at reduced width the card's tokens equal the CPU's
    small = dataclasses.replace(registry.reduced(LM_ARCH),
                                compute_dtype="float32")
    p_cpu = api.init_params(small, 0, device="cpu")
    p_card = convert.params_from_numpy(convert.params_to_numpy(p_cpu), dev,
                                       small)
    on_card, _, _ = _serve(small, p_card, dev, 5, 2, 64, 6)
    on_cpu, _, _ = _serve(small, p_cpu, "cpu", 5, 2, 64, 6)
    if [r.out for r in on_card] != [r.out for r in on_cpu]:
        fail(f"lm-serve: reduced width, card tokens "
             f"{[r.out for r in on_card]} != CPU tokens "
             f"{[r.out for r in on_cpu]}")
    print(f"lm-serve: reduced width, float32: the card's tokens equal the "
          f"CPU's for all {len(on_card)} requests")


def _leaves(tree) -> list:
    """The tensors of a tree of dicts and tuples (parameters, caches)."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _diff_stats(a, b):
    d = (a.float() - b.float()).abs()
    return float(d.max()), float(d.mean())


class PinnedRouting:
    """Within this context ``repro_torch.models.moe.top_k_routing`` records
    the router's choices (ids) call by call; once ``replay`` is set, a
    function ``(call index, ids shape) -> ids``, each call returns those
    ids instead, with weights softmaxed from its own logits at them, and
    counts the token-layers whose own choice differs.  For comparisons
    only: the runs that count launches never enter it."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.own = moe, moe.top_k_routing
        self.recorded, self.replay = [], None
        self.calls = self.changed = self.total = 0

    def __enter__(self):
        self.moe.top_k_routing = self._route
        return self

    def __exit__(self, *exc):
        self.moe.top_k_routing = self.own

    def _route(self, logits, k):
        import torch
        w, ids = self.own(logits, k)
        if self.replay is None:
            self.recorded.append(ids)
            return w, ids
        want = self.replay(self.calls, ids.shape)
        self.calls += 1
        self.total += ids.numel() // k
        self.changed += int((ids.sort(-1).values != want.sort(-1).values)
                            .any(-1).sum())
        return torch.softmax(torch.gather(logits, -1, want).float(),
                             dim=-1), want


class CheckedK2:
    """Within this context every call of ``repro_torch.kernels.ops
    .attention`` (the route to K2) is also computed by ``attention_ref``
    on the same q, k, v; keeps the call count and the largest |difference|.
    For comparisons only: the runs that count launches never enter it."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops, self.own = ops, ops.attention
        self.calls, self.err = 0, 0.0

    def __enter__(self):
        self.ops.attention = self._attention
        return self

    def __exit__(self, *exc):
        self.ops.attention = self.own

    def _attention(self, q, k, v, causal=True):
        from repro_torch.kernels.ref import attention_ref
        out = self.own(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        self.calls += 1
        self.err = max(self.err, float((out.float() - want.float()).abs()
                                       .max()))
        return out


def _family_routes(name, cfg, params, batch, dtype: str, hold: bool):
    """The prefill's last-token logits on the kernel route against the
    einsum route at compute ``dtype``; held to ROUTE_MAX/ROUTE_MEAN when
    ``hold``.  For moe the einsum route replays the kernel route's router
    choices (they are discrete: between the routes the router logits
    differ in their last bits, near-ties flip and the capacity drops
    shift); the free-running difference is printed beside it.  Returns
    a description."""
    from repro_torch.models import common
    from repro_torch.train import step
    prefill = step.make_prefill_step(dataclasses.replace(
        cfg, compute_dtype=dtype))
    moe = cfg.family == "moe"
    pin = PinnedRouting() if moe else contextlib.nullcontext()
    with pin:
        last = prefill(params, batch).clone()
        if moe:
            with common.einsum_route():
                free = prefill(params, batch).clone()
            pin.replay = lambda i, shape: pin.recorded[i]   # noqa: E731
        with common.einsum_route():
            ref = prefill(params, batch).clone()
    what = f"{name}: kernel route vs einsum route"
    if hold:
        err, mean = _route_err(last, ref, dtype, what)
    else:
        err, mean = _diff_stats(last, ref)
    agree = float((last.float().argmax(-1) == ref.float().argmax(-1))
                  .float().mean())
    out = (f"{dtype}: max |err| {err:.4e}, mean {mean:.4e}, argmax agree "
           f"{agree:.3f} ({'held to' if hold else 'printed; ROUTE is'} "
           f"{ROUTE_MAX[dtype]}, {ROUTE_MEAN[dtype]})")
    if moe:
        ferr, fmean = _diff_stats(last, free)
        out += (f", router choices replayed (the einsum route's own differ "
                f"on {pin.changed} of {pin.total} token-layers; "
                f"free-running max |err| {ferr:.4e}, mean {fmean:.4e})")
    return out


def _family_decode(name, cfg, params, dbatch, hold: bool):
    """FAMILY_DECODE decode steps at B 4 against the cache-free forward of
    the same tokens at ``cfg``'s compute dtype: no K2 launch in decode;
    greedy agreement and the last logits' difference, held to
    DECODE_AGREE and ROUTE_MAX/ROUTE_MEAN when ``hold``.  The moe
    forward runs at a capacity that drops nothing (an expert takes every
    copy a group can send it, as ``tests/test_moe_ssm.py`` does) and the
    decode replays its router choices.  Returns (description, seconds a
    step)."""
    import torch
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.models import api, zoo

    moe = cfg.family == "moe"
    if moe:
        cfg = dataclasses.replace(
            cfg, capacity_factor=cfg.moe_experts / cfg.moe_top_k)
    dt = cfg.compute_dtype
    b = PREFILL_BATCH
    tokens = dbatch["tokens"]
    pin = PinnedRouting() if moe else contextlib.nullcontext()
    with pin:
        full, _ = api.forward_logits(cfg, params, dbatch)
    cache = api.init_cache(cfg, b, FAMILY_DECODE)
    if cfg.family == "vlm":
        cache["img"] = dbatch["img"]
    if cfg.family == "audio":    # the encoder's output, as a caller writes it
        cache["enc"] = zoo._encode_audio(cfg, params, dbatch["frames"])
    if moe:
        # step t replays the forward's choices for token t of each row (a
        # group of the forward is 8 consecutive tokens of one row)
        L, k = cfg.n_layers, cfg.moe_top_k
        pin.replay = lambda i, shape: pin.recorded[i % L].reshape(  # noqa
            b, FAMILY_DECODE, k)[:, i // L].reshape(shape)
    torch.cuda.synchronize()
    LAUNCHES.reset()
    outs = []
    t0 = time.perf_counter()
    with pin:
        for t in range(FAMILY_DECODE):
            lg, cache = api.decode_step(cfg, params, cache,
                                        tokens[:, t:t + 1])
            outs.append(lg)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / FAMILY_DECODE
    if LAUNCHES.n != 0:
        fail(f"{name}: decode steps launched K2 {LAUNCHES.n} times")
    got = torch.stack(outs, 1)
    if not bool(torch.isfinite(got.float()).all()):
        fail(f"{name}: decode logits not finite ({dt})")
    what = f"{name}: last decode logits vs forward"
    if hold:
        err, mean = _route_err(got[:, -1], full[:, -1], dt, what)
    else:
        err, mean = _diff_stats(got[:, -1], full[:, -1])
    agree = float((got.float().argmax(-1) == full.float().argmax(-1))
                  .float().mean())
    if hold and agree < DECODE_AGREE:
        fail(f"{name}: greedy tokens ({dt}) equal the forward's on {agree} "
             f"of the positions (at least {DECODE_AGREE})")
    dtypes = sorted({str(t.dtype).replace("torch.", "")
                     for t in _leaves(cache)})
    out = (f"{dt}: greedy agreement {agree:.4f}, last logits max |err| "
           f"{err:.4e}, mean {mean:.4e} ({'held' if hold else 'printed'}), "
           f"cache leaves {dtypes}, {step_s * 1e3:.3f} ms per step")
    if moe:
        out += (f", capacity factor {cfg.capacity_factor}, router choices "
                f"replayed from the forward (decode's own differ on "
                f"{pin.changed} of {pin.total} token-layers)")
    return out, step_s


def phase_lm_family(dev, name: str, arch: str, k2_want: int) -> int:
    """One LM family at the full width of ``arch`` from the port's seeded
    init: (a) the parameter count against the port's abstract tree; (b)
    the B 4 x S 2048 bf16 prefill: K2's launches, finite logits, every K2
    launch against ``attention_ref`` on the same inputs (K2_TOL), timed
    and profiled; the kernel route against the einsum route, held in
    float32 and printed in bf16; (c) FAMILY_DECODE decode steps against
    the cache-free forward, held in float32 and printed (and timed) in
    bf16; (d) the Server at the launcher's defaults.  Frees the model and
    returns K2's launches in the prefill.

    In bf16 the two routes and decode against the forward differ by
    roundings that grow with depth and width: at llama-3.2-vision-11b
    (40 layers, d 4096) the routes' last-token logits differ by max
    0.335, mean 0.051, past ROUTE_MAX/ROUTE_MEAN (calibrated at
    tinyllama), and decode agrees with the forward on 0.848 of the
    greedy tokens, against 1.0000 and ~1e-4 in float32 (NVIDIA H100
    80GB HBM3, 700 W).  So the float32 comparisons are held and the bf16
    ones printed."""
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import F32_LAUNCHES, LAUNCHES
    from repro_torch.models import api
    from repro_torch.train import step

    cfg = registry.get(arch)
    t0 = time.perf_counter()
    params = api.init_params(cfg, 0)                  # default: cuda
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_tree = sum(t.numel() for t in _leaves(api.abstract_params(cfg)))
    n_got = sum(t.numel() for t in _leaves(params))
    if n_got != n_tree:
        fail(f"{name}: {n_got} parameters, the abstract tree has {n_tree}")
    print(f"{name}: {arch} full width ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, vocab {cfg.vocab}), {n_got} parameters == the "
          f"abstract tree's (ModelConfig.n_params() says {cfg.n_params()}, "
          f"{n_got - cfg.n_params():+d}); init {init_s:.3f} s; device "
          f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    # (b) the prefill, as the main path runs it
    batch = api.make_inputs(cfg, "prefill", PREFILL_BATCH, PREFILL_SEQ,
                            np.random.default_rng(0))
    prefill = step.make_prefill_step(cfg)
    LAUNCHES.reset()
    f32_before = F32_LAUNCHES.n
    t0 = time.perf_counter()
    last = prefill(params, batch).clone()   # not the full logits' storage
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = LAUNCHES.n
    if launches != k2_want or F32_LAUNCHES.n != f32_before:
        fail(f"{name}: K2 launched {launches} times in the prefill, "
             f"{F32_LAUNCHES.n - f32_before} of them float32, expected "
             f"{k2_want}, all bf16")
    if last.shape != (PREFILL_BATCH, cfg.vocab) or \
            not bool(torch.isfinite(last.float()).all()):
        fail(f"{name}: last-token logits {tuple(last.shape)} not finite or "
             f"of the wrong shape")
    reps = 2
    t0 = time.perf_counter()
    for _ in range(reps):
        prefill(params, batch)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / reps * 1e3
    with CheckedK2() as chk:
        prefill(params, batch)
    if chk.calls != k2_want or not chk.err < K2_TOL["bfloat16"]:
        fail(f"{name}: K2 against attention_ref on the prefill's own "
             f"inputs: {chk.calls} calls, max |err| {chk.err} (tolerance "
             f"{K2_TOL['bfloat16']})")
    print(f"{name}: prefill B={PREFILL_BATCH} S={PREFILL_SEQ} bf16: K2 "
          f"launches {launches}, each against attention_ref on its own "
          f"inputs max |err| {chk.err:.3e} (tolerance "
          f"{K2_TOL['bfloat16']}); first call {first_s:.3f} s; "
          f"{wall_ms:.3f} ms per prefill "
          f"({PREFILL_BATCH * PREFILL_SEQ / wall_ms * 1e3:.1f} tok/s); "
          f"last-token logits max |logit| "
          f"{float(last.float().abs().max()):.3f}")
    del last
    profile_lines(f"{name} prefill", lambda: prefill(params, batch),
                  top=4)
    print(f"{name}: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    for dt in ("float32", "bfloat16"):
        print(f"{name}: routes, "
              + _family_routes(name, cfg, params, batch, dt,
                               hold=dt == "float32"))
        torch.cuda.empty_cache()

    # (c) decode against the cache-free forward of the same tokens
    step_s = {}
    for dt in ("float32", "bfloat16"):
        dcfg = dataclasses.replace(cfg, compute_dtype=dt)
        # the same draws in each compute dtype
        dbatch = api.make_inputs(dcfg, "prefill", PREFILL_BATCH,
                                 FAMILY_DECODE, np.random.default_rng(1))
        line, step_s[dt] = _family_decode(name, dcfg, params, dbatch,
                                          hold=dt == "float32")
        print(f"{name}: decode {FAMILY_DECODE} tokens x B={PREFILL_BATCH} "
              f"one at a time (K2 launches 0) vs the cache-free forward, "
              + line)
    print(f"{name}: decode bf16 {step_s['bfloat16'] * 1e3:.3f} ms per step "
          f"({PREFILL_BATCH / step_s['bfloat16']:.1f} tok/s)")
    state = {"c": api.init_cache(cfg, PREFILL_BATCH, SERVE_CACHE)}
    steps = 8
    tokens = dbatch["tokens"]

    def window():
        for t in range(steps):
            _, state["c"] = api.decode_step(cfg, params, state["c"],
                                            tokens[:, t:t + 1])
    profile_lines(f"{name} decode", window, steps, top=4)
    del state

    # (d) the server at the launcher's defaults
    done, secs, n_steps = _serve(cfg, params, dev, SERVE_REQUESTS,
                                 SERVE_SLOTS, SERVE_CACHE, SERVE_NEW)
    if len(done) != SERVE_REQUESTS or any(
            len(r.out) != SERVE_NEW or not all(0 <= t < cfg.vocab
                                               for t in r.out)
            for r in done):
        fail(f"{name}: serve: {len(done)} of {SERVE_REQUESTS} requests "
             f"done, tokens {[r.out for r in done]}")
    toks = sum(len(r.out) for r in done)
    print(f"{name}: serve {len(done)} requests / {toks} tokens in "
          f"{secs:.3f} s ({toks / secs:.1f} tok/s) with {SERVE_SLOTS} "
          f"slots, cache_len {SERVE_CACHE}: {n_steps} batched decode "
          f"steps, {secs / n_steps * 1e3:.3f} ms per step")
    del params, batch, dbatch, done
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return launches


def _train_grads_card_vs_cpu(dev, cfg, params, name: str = "lm-train",
                             arch: str = LM_ARCH) -> None:
    """lm-train (a), and (a) of each lm-<family>-train: one float32
    step's loss, grad norm and gradients at full width, on the card and
    on the CPU.  A leaf whose gradient is zero on the CPU (hymba's
    unread ``layers.mamba.ln``) must be exactly zero on the card.  The
    moe family's router choices on the card are replayed on the CPU
    (``PinnedRouting``), and the token-layers whose own choice differs
    are counted and printed."""
    import torch
    from repro_torch.train import optim, step
    from repro_torch.train.data import DataConfig, DataSource, DataState

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    batch = DataSource(DataConfig(batch=TRAIN_CMP_BATCH, seq=TRAIN_CMP_SEQ),
                       cfg32).batch_at(DataState(0))
    pin = PinnedRouting() if cfg.family == "moe" else None
    t0 = time.perf_counter()
    with pin if pin is not None else contextlib.nullcontext():
        loss_d, g_d = step.value_and_grad(cfg32, params, batch)
    gn_d = float(optim.global_norm(g_d))
    loss_d = float(loss_d)
    card_s = time.perf_counter() - t0
    on_cpu = optim.tree_map(lambda t: t.cpu(), params)
    t0 = time.perf_counter()
    if pin is not None:
        pin.replay = lambda i, shape: pin.recorded[i].cpu()
    with pin if pin is not None else contextlib.nullcontext():
        loss_h, g_h = step.value_and_grad(cfg32, on_cpu, batch,
                                          device="cpu")
    gn_h = float(optim.global_norm(g_h))
    loss_h = float(loss_h)
    cpu_s = time.perf_counter() - t0
    del on_cpu
    if not (abs(loss_d - loss_h) <= TRAIN_LOSS_RTOL * abs(loss_h) and
            abs(gn_d - gn_h) <= TRAIN_GNORM_RTOL * gn_h):
        fail(f"{name}: full-width float32 step, card loss {loss_d} grad "
             f"norm {gn_d}, CPU {loss_h}, {gn_h}")
    worst, zero = 0.0, []
    for (path, a), (_, b) in zip(optim.tree_items(g_d),
                                 optim.tree_items(g_h)):
        scale = float(b.abs().max())
        if scale == 0.0:
            if bool(torch.any(a)):
                fail(f"{name}: gradient of {'.'.join(path)} is zero on the "
                     f"CPU and not on the card")
            zero.append(".".join(path))
            continue
        rel = float((a.cpu() - b).abs().max()) / scale
        if not rel <= TRAIN_GRAD_RTOL:
            fail(f"{name}: gradient of {'.'.join(path)}: card vs CPU max "
                 f"|diff| {rel} of its max (tolerance {TRAIN_GRAD_RTOL})")
        worst = max(worst, rel)
    if cfg.family == "hybrid" and "layers.mamba.ln" not in zero:
        fail(f"{name}: the unread layers.mamba.ln has a gradient; zero "
             f"leaves {zero}")
    routing = ""
    if pin is not None:
        routing = (f"; the card's router choices replayed on the CPU, whose "
                   f"own choice differs on {pin.changed} of {pin.total} "
                   f"token-layers")
    print(f"{name}: {arch} full width ({cfg.n_layers} layers), float32, "
          f"B={TRAIN_CMP_BATCH} S={TRAIN_CMP_SEQ}, one step on the card "
          f"({card_s:.3f} s, first call) vs the CPU ({cpu_s:.1f} s, "
          f"{torch.get_num_threads()} threads): loss {loss_d!r} vs "
          f"{loss_h!r} (rel {abs(loss_d - loss_h) / loss_h:.3e}), grad norm "
          f"{gn_d!r} vs {gn_h!r} (rel {abs(gn_d - gn_h) / gn_h:.3e}), worst "
          f"leaf gradient max |diff| / max {worst:.3e} over "
          f"{sum(1 for _ in optim.tree_items(g_d))} leaves, zero on both "
          f"{zero} (tolerances {TRAIN_LOSS_RTOL}, {TRAIN_GNORM_RTOL}, "
          f"{TRAIN_GRAD_RTOL}){routing}")


def _train_timed(dev, cfg, params, name: str = "lm-train",
                 arch: str = LM_ARCH, layers=None,
                 steps: int = TRAIN_STEPS, halves: bool = True) -> None:
    """lm-train (b), and (b) of each lm-<family>-train: the launcher's
    defaults at full width (``layers`` kept where the family's depth is
    cut), ``steps`` steps timed after TRAIN_WARMUP; with ``halves`` the
    gradient and AdamW halves are profiled apart."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import LAUNCHES
    from repro_torch.launch import train as train_cli
    from repro_torch.models import costs
    from repro_torch.train import optim, step
    from repro_torch.train.data import DataSource, DataState

    # PyTorch's default (lm-prefill turned it off for its comparisons)
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = True
    # the configurations the launcher trains with by default (building the
    # Trainer allocates nothing)
    dflt = train_cli.build_trainer(train_cli.build_parser().parse_args(
        ["--arch", arch]))
    want = dflt.mcfg if layers is None else dataclasses.replace(
        dflt.mcfg, n_layers=layers)
    if want != cfg:
        fail(f"{name}: the launcher's model config {want} is not the one "
             f"the phase trains, {cfg}")
    opt, batch_n, seq = dflt.ocfg, dflt.dcfg.batch, dflt.dcfg.seq
    data = DataSource(dflt.dcfg, cfg)
    fn = step.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # each step's batch is drawn before its clock starts, as the Trainer
    # times its steps: vlm's stub image tokens alone are 52.5 M normal
    # draws a batch on the host
    state = {"p": params, "o": optim.init_opt(opt, params), "i": 0,
             "b": data.batch_at(DataState(0))}

    def one():
        state["p"], state["o"], m = fn(state["p"], state["o"], state["b"])
        state["i"] += 1
        return m

    LAUNCHES.reset()
    losses, times, draws = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state["b"] = data.batch_at(DataState(state["i"]))
        t1 = time.perf_counter()
        m = one()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        draws.append((t1 - t0) * 1e3)
        losses.append(float(m["loss"]))
    k2 = LAUNCHES.n
    peak = torch.cuda.max_memory_allocated()
    if k2 != 0:
        fail(f"{name}: the train steps launched K2 {k2} times")
    if not all(np.isfinite(losses)):
        fail(f"{name}: losses {losses}")
    ms = sum(times[TRAIN_WARMUP:]) / (steps - TRAIN_WARMUP)
    flops = costs.cell_flops(cfg, "train", batch_n, seq)
    mfu = flops / (ms / 1e3) / BF16_FLOPS_PER_S
    print(f"{name}: {arch} full width, {cfg.n_layers} layers, bf16 "
          f"compute, remat {cfg.remat}, B={batch_n} S={seq}, {steps} steps "
          f"through make_train_step: losses "
          f"{[round(x, 4) for x in losses]}; K2 launches {k2}")
    print(f"{name}: step ms {[round(t, 3) for t in times]}; {ms:.3f} ms a "
          f"step after {TRAIN_WARMUP} warm-up steps, "
          f"{batch_n * seq / ms * 1e3:.1f} tokens/s, "
          f"{flops:.4e} FLOP a step (models.costs.cell_flops), MFU "
          f"{mfu:.4f} of {BF16_FLOPS_PER_S:.0f} FLOP/s; peak device memory "
          f"{peak} B ({held} B held before the steps); the batches drawn "
          f"on the host apart, {sum(draws) / steps:.3f} ms a batch; card: "
          f"{card_line()}")
    wall, kern = device_profile(one, 1)
    busy = sum(v[0] for v in kern.values())
    launches = sum(v[1] for v in kern.values())
    print(f"{name} profile: one step, wall {wall:.3f} ms (under the "
          f"profiler), device busy {busy:.3f} ms (idle share "
          f"{1 - busy / wall:.4f}), {launches} kernel launches")
    for kname, (t, count) in sorted(kern.items(),
                                    key=lambda kv: -kv[1][0])[:8]:
        print(f"{name} profile:   {t:.3f} ms  {count}x  {kname[:90]}")
    if halves:
        # the step's two halves apart: the gradient, and AdamW on it
        batch = data.batch_at(DataState(0))
        _, grads = step.value_and_grad(cfg, state["p"], batch)
        for what, fn in (("value_and_grad", lambda: step.value_and_grad(
                cfg, state["p"], batch)),
                         ("apply_updates", lambda: optim.apply_updates(
                             opt, state["p"], grads, state["o"]))):
            ms_call = event_ms(fn, 3)
            wall_h, kern_h = device_profile(fn, 1)
            busy_h = sum(v[0] for v in kern_h.values())
            print(f"{name} profile: {what} alone: {ms_call:.3f} ms a call "
                  f"(CUDA events), device busy {busy_h:.3f} ms, "
                  f"{sum(v[1] for v in kern_h.values())} kernel launches, "
                  f"idle share {1 - busy_h / wall_h:.4f} (under the "
                  f"profiler)")
    del state


def _train_reduced(dev, arch: str = LM_ARCH, name: str = "lm-train",
                   launcher: bool = True) -> None:
    """lm-train (c), and (c) of lm-hybrid-train: at reduced width, the
    Trainer checkpointed at TRAIN_CUT and resumed to TRAIN_CLI_STEPS
    against an uninterrupted run, bit for bit; with ``launcher`` also
    the train launcher in a subprocess, ending at the same loss."""
    import ast
    import tempfile

    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.train.loop import Trainer
    from repro_torch.train.optim import tree_items

    with tempfile.TemporaryDirectory() as tmp:
        flags = ["--arch", arch, "--reduced", "--steps",
                 str(TRAIN_CLI_STEPS)]
        whole = train_cli.build_trainer(train_cli.build_parser().parse_args(
            flags + ["--ckpt-dir", os.path.join(tmp, "whole")]))
        whole.run()
        cut = lambda steps, resume, every: Trainer(
            whole.mcfg, whole.ocfg, whole.dcfg, dataclasses.replace(
                whole.lcfg, steps=steps, ckpt_dir=os.path.join(tmp, "cut"),
                ckpt_every=every, resume=resume))
        cut(TRAIN_CUT, False, TRAIN_CUT).run()
        resumed = cut(TRAIN_CLI_STEPS, True, 1000)
        resumed.run()
        if resumed.metrics_log[0]["step"] != TRAIN_CUT:
            fail(f"{name}: the resumed run began at step "
                 f"{resumed.metrics_log[0]['step']}, not {TRAIN_CUT}")
        n = 0
        for tree_a, tree_b in ((whole.params, resumed.params),
                               (whole.opt_state._asdict(),
                                resumed.opt_state._asdict())):
            for (path, a), (_, b) in zip(tree_items(tree_a),
                                         tree_items(tree_b)):
                n += 1
                if not torch.equal(a, b):
                    fail(f"{name}: resumed {'.'.join(path)} differs from "
                         f"the uninterrupted run's by "
                         f"{float((a.float() - b.float()).abs().max())}")
        first = whole.metrics_log[0]["loss"]
        final = whole.metrics_log[-1]["loss"]
        done = ""
        if launcher:
            env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", *flags,
                 "--ckpt-dir", os.path.join(tmp, "cli")], cwd=ROOT, env=env,
                capture_output=True, text=True, timeout=CLI_TIMEOUT)
            if proc.returncode != 0:
                fail(f"{name}: the launcher exited {proc.returncode}: "
                     f"{proc.stderr[-2000:]}")
            done = proc.stdout.strip().splitlines()[-1]
            out = ast.literal_eval(done.split("[train] done: ", 1)[1])
            if out["final_loss"] != final or not final < first or \
                    out["steps"] != TRAIN_CLI_STEPS:
                fail(f"{name}: launcher {done!r}; in-process first loss "
                     f"{first!r}, final {final!r}")
            done = f"; the launcher ({done}) ends at the in-process loss"
    print(f"{name}: {arch} at reduced width on the card: checkpointed at "
          f"step {TRAIN_CUT} and resumed to {TRAIN_CLI_STEPS}, parameters "
          f"and optimizer state ({n} leaves) equal the uninterrupted run's "
          f"bit for bit{done}; losses {first!r} -> {final!r}")


def _train_long(dev, cfg, params, rec: dict) -> None:
    """lm-train (d): a bf16 step at B 1 x S LONG_SEQ, past
    ``BLOCK_THRESHOLD``: the blocked attention, each query and key chunk
    recomputed in the backward.  Prints its peak device memory and ms
    beside the dry run's prediction for the same cell on one device
    (``rec``: its argument and temp bytes; temp counts the step's
    outputs).  Then holds the step's loss and grad norm against those of
    the einsum route (the whole (S, S) scores at once, BLOCK_THRESHOLD
    lifted) on the same batch: a chunk dropped or a recompute in another
    route would move them."""
    import numpy as np
    import torch
    from repro_torch.launch import train as train_cli
    from repro_torch.models import common
    from repro_torch.train import optim, step
    from repro_torch.train.data import DataConfig, DataSource, DataState

    if not LONG_SEQ * LONG_SEQ > common.BLOCK_THRESHOLD:
        fail(f"lm-train (d): S {LONG_SEQ} does not take the blocked path")
    opt = train_cli.build_trainer(train_cli.build_parser().parse_args(
        ["--arch", LM_ARCH])).ocfg
    batch = DataSource(DataConfig(batch=1, seq=LONG_SEQ),
                       cfg).batch_at(DataState(0))
    fn = step.make_train_step(cfg, opt)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # what the card holds besides this cell's parameters
    other = torch.cuda.memory_allocated() - sum(
        t.nbytes for t in _leaves(params))
    torch.cuda.reset_peak_memory_stats()
    o = optim.init_opt(opt, params)
    t0 = time.perf_counter()
    p1, o1, m = fn(params, o, batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    loss = float(m["loss"])
    peak = torch.cuda.max_memory_allocated()
    gnorm = float(m["grad_norm"])
    del p1, o1, o
    if not np.isfinite(loss):
        fail(f"lm-train (d): loss {loss}")
    threshold = common.BLOCK_THRESHOLD
    common.BLOCK_THRESHOLD = LONG_SEQ * LONG_SEQ
    try:
        ref_loss, grads = step.value_and_grad(cfg, params, batch)
        ref_gnorm = float(optim.global_norm(grads))
        ref_loss = float(ref_loss)
    finally:
        common.BLOCK_THRESHOLD = threshold
    del grads
    torch.cuda.empty_cache()
    errs = (abs(loss - ref_loss) / abs(ref_loss),
            abs(gnorm - ref_gnorm) / ref_gnorm)
    if not (errs[0] <= LONG_LOSS_RTOL and errs[1] <= LONG_GNORM_RTOL):
        fail(f"lm-train (d): the blocked step's loss {loss} and grad norm "
             f"{gnorm} against the einsum route's {ref_loss}, {ref_gnorm}: "
             f"relative {errs} (tolerances {LONG_LOSS_RTOL}, "
             f"{LONG_GNORM_RTOL})")
    want = rec["mem"]["argument"] + rec["mem"]["temp"]
    print(f"lm-train (d): {LM_ARCH} full width, bf16 compute, remat "
          f"{cfg.remat}, B=1 S={LONG_SEQ} (the blocked attention, a "
          f"checkpoint per query and key chunk): loss {loss}, grad norm "
          f"{gnorm}; the einsum route on the same batch {ref_loss}, "
          f"{ref_gnorm} (relative {errs[0]:.3e}, {errs[1]:.3e}; tolerances "
          f"{LONG_LOSS_RTOL}, {LONG_GNORM_RTOL}); one step "
          f"{step_ms:.3f} ms (the first at this shape, with the allocator's "
          f"warm-up); peak device memory {peak} B, {peak - other} B without "
          f"the {other} B the card held besides the parameters; the dry "
          f"run's one-device prediction, argument {rec['mem']['argument']} "
          f"+ temp {rec['mem']['temp']} = {want} B ({(peak - other) / want:.4f} "
          f"times it); card: {card_line()}")


def phase_lm_train(dev, cfg, params, long_rec: dict) -> None:
    _train_grads_card_vs_cpu(dev, cfg, params)
    _train_timed(dev, cfg, params)
    _train_long(dev, cfg, params, long_rec)
    _train_reduced(dev)


def phase_lm_family_train(dev, name: str, arch: str) -> None:
    """lm-<family>-train, after the family's serving phase (one model on
    the card at a time): the launcher's configuration of ``arch`` at
    full width, its depth cut to FAMILY_TRAIN_LAYERS where one card
    forces it, from the port's seeded init: (a) one float32 step on the
    card against the CPU; (b) FAMILY_TRAIN_STEPS bf16 steps at the
    launcher's defaults, timed and profiled; (c) for the hybrid family,
    whose tree holds the leaf no forward reads, the reduced-width
    Trainer resumed bit for bit.  Frees the model."""
    import torch
    from repro_torch.configs import registry
    from repro_torch.models import api

    whole = registry.get(arch)
    layers = FAMILY_TRAIN_LAYERS.get(name)
    cfg = whole if layers is None else dataclasses.replace(whole,
                                                           n_layers=layers)
    cut = "no depth cut" if layers is None else \
        f"depth cut to {layers} of {whole.n_layers} layers"
    params = api.init_params(cfg, 0)                  # default: cuda
    n = sum(t.numel() for t in _leaves(params))
    print(f"{name}-train: {arch} full width (d {cfg.d_model}, vocab "
          f"{cfg.vocab}), {cut}: {n} parameters; device memory "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if cfg.family == "vlm":
        for t in (params["xlayers"]["xattn"]["gate"],
                  params["xlayers"]["gate_mlp"]):
            t.fill_(VLM_GATE_OPEN)
        print(f"{name}-train: the gates of the cross-attention blocks "
              f"opened to {VLM_GATE_OPEN} (they start at zero, which "
              f"zeroes the blocks' gradients)")
    _train_grads_card_vs_cpu(dev, cfg, params, f"{name}-train", arch)
    torch.cuda.empty_cache()
    _train_timed(dev, cfg, params, f"{name}-train", arch, layers,
                 FAMILY_TRAIN_STEPS, halves=False)
    del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    if cfg.family == "hybrid":
        _train_reduced(dev, arch, f"{name}-train", launcher=False)


def lm_sharded_rank(root: str) -> dict:
    """One rank of lm-sharded, in a subprocess: tinyllama-1.1b at full
    width on the (2, 2) mesh; (1) the bf16 prefill, (2) one float32 train
    step against the one-device step on rank 0, (3) its parameters
    checkpointed on (2, 2) and restored on (1, 4) and on one rank, and
    the next step's loss and gradient norm on both.  Rank 0 prints its
    progress."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import F32_LAUNCHES, LAUNCHES
    from repro_torch.launch import train as train_cli
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import api
    from repro_torch.parallel.sharding import (P, distribute, placements,
                                               resolve_pspec, tree_shardings)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optim, step
    from repro_torch.train.data import DataConfig, DataSource, DataState

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    r = dist.get_rank()
    dev = torch.device("cuda", torch.cuda.current_device())
    sync = torch.cuda.synchronize
    t_start = time.perf_counter()

    def note(what):
        if r == 0:
            print(f"lm-sharded rank 0: {time.perf_counter() - t_start:.1f} "
                  f"s: {what}; {torch.cuda.memory_allocated() / 2**30:.2f} "
                  f"GiB held", flush=True)

    def clock(fn):
        dist.barrier()
        sync()
        t0 = time.perf_counter()
        res = fn()
        sync()
        return res, (time.perf_counter() - t0) * 1e3

    def free():
        sync()
        torch.cuda.empty_cache()
        dist.barrier()

    out = {"rank": r, "device": dev.index, "backend": dist.get_backend()}
    cfg = registry.get(LM_ARCH)
    mesh = make_mesh(SHLM_MESH, SHLM_AXES)
    params, out["init_ms"] = clock(lambda: api.init_params(cfg, 0,
                                                           mesh=mesh))
    wq = params["layers"]["attn"]["wq"]
    out["wq"] = (str(wq.placements), tuple(wq.to_local().shape))
    # the bytes of this rank's blocks, against the dry run's prediction
    out["param_bytes"] = sum(t.to_local().nbytes for t in _leaves(params))
    note("parameters placed")

    # (1) the prefill, bf16, K2 on each rank's local heads
    batch = api.make_inputs(cfg, "prefill", PREFILL_BATCH, PREFILL_SEQ,
                            np.random.default_rng(0))
    prefill = step.make_prefill_step(cfg, mesh=mesh)
    LAUNCHES.reset()
    F32_LAUNCHES.reset()
    last, out["prefill_first_ms"] = clock(lambda: prefill(params, batch))
    out["k2"], out["k2_f32"] = LAUNCHES.n, F32_LAUNCHES.n
    _, out["prefill_ms"] = clock(lambda: prefill(params, batch))
    with CheckedK2() as chk:            # K2 at this rank's local shapes
        prefill(params, batch)
    out["k2_checked"], out["k2_err"] = chk.calls, chk.err
    last = last.full_tensor().float()
    out["finite"] = bool(torch.isfinite(last).all())
    note(f"prefill {out['prefill_ms']:.1f} ms")
    one = None
    if r == 0:
        one = api.init_params(cfg, 0)
        ref = step.make_prefill_step(cfg)(one, batch).float()
        out["prefill_err"] = float((last - ref).abs().max())
        out["prefill_mean"] = float((last - ref).abs().mean())
        out["prefill_agree"] = float((last.argmax(-1) == ref.argmax(-1))
                                     .float().mean())
        del ref
    free()

    # (1b) decode steps on the mesh, the weights left split as their specs
    # place them and the cache as cache_pspecs places it; rank 0 decodes
    # the same tokens on one device
    from repro_torch.launch.dryrun import Meter
    toks = np.random.default_rng(2).integers(
        0, cfg.vocab, (PREFILL_BATCH, SHLM_DECODE)).astype(np.int32)
    cache = optim.tree_map(lambda c, sp: distribute(c, mesh, placements(
        resolve_pspec(sp, mesh, c.shape), mesh)),
        api.init_cache(cfg, PREFILL_BATCH, SHLM_CACHE),
        api.cache_pspecs(cfg, PREFILL_BATCH, SHLM_CACHE),
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    tok_pl = placements(resolve_pspec(P(api.DP, None), mesh,
                                      (PREFILL_BATCH, 1)), mesh)
    col = lambda t: distribute(torch.as_tensor(  # noqa: E731
        toks[:, t:t + 1], device=dev), mesh, tok_pl)
    # what the rank holds for a step: the dry run's decode argument bytes
    out["decode_held"] = out["param_bytes"] + sum(
        c.to_local().nbytes for c in _leaves(cache)) + \
        col(0).to_local().nbytes
    serve = step.make_serve_step(cfg, mesh=mesh)
    logits, ms = [], []
    for t in range(SHLM_DECODE):
        # the last step runs in the dry run's meter: its collectives
        last_step = t == SHLM_DECODE - 1
        meter = Meter()
        with meter if last_step else contextlib.nullcontext():
            (lg, cache), t_ms = clock(lambda: serve(params, cache, col(t)))
        logits.append(lg.full_tensor().float().cpu().numpy())
        ms.append(t_ms)
        if last_step:
            out["decode_gather_max"] = meter.largest.get("all-gather", 0)
            out["decode_gather"] = meter.collectives.get("all-gather", 0)
    out["decode_ms"], out["decode_logits"] = ms, np.stack(logits, 1)
    if r == 0:
        c1 = api.init_cache(cfg, PREFILL_BATCH, SHLM_CACHE)
        ref = []
        for t in range(SHLM_DECODE):
            lg, c1 = api.decode_step(cfg, one, c1, toks[:, t:t + 1])
            ref.append(lg.float().cpu().numpy())
        out["decode_ref"] = np.stack(ref, 1)
        del c1
    del cache, one
    free()
    note(f"{SHLM_DECODE} decode steps, ms {[round(x, 1) for x in ms]}")

    # (2) one float32 train step at the launcher's optimizer defaults
    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    opt = train_cli.build_trainer(train_cli.build_parser().parse_args(
        ["--arch", LM_ARCH])).ocfg
    data = DataSource(DataConfig(batch=SHLM_BATCH, seq=SHLM_SEQ), cfg32)
    b0, b1 = data.batch_at(DataState(0)), data.batch_at(DataState(1))

    def train_step(p, o, b):
        loss, grads = step.value_and_grad(cfg32, p, b, mesh=mesh)
        p, o, gn = optim.apply_updates(opt, p, grads, o)
        return loss, grads, p, o, gn

    o0 = optim.init_opt(opt, params)
    # the step in the dry run's meter: its collectives
    with Meter() as meter:
        (loss, grads, p1, o1, gn), out["step_ms"] = clock(
            lambda: train_step(params, o0, b0))
    out["step_coll"] = dict(meter.collectives)
    out["loss"], out["gnorm"] = float(loss), float(gn)
    del o0
    del params
    note(f"train step {out['step_ms']:.1f} ms")
    ref_g = {}
    if r == 0:
        one = api.init_params(cfg, 0)
        ref_loss, g = step.value_and_grad(cfg32, one, b0)
        out["ref_loss"] = float(ref_loss)
        out["ref_gnorm"] = float(optim.global_norm(g))
        ref_g = {k: v.cpu() for k, v in optim.tree_items(g)}
        del one, g
    free()
    worst = 0.0
    for k, g in optim.tree_items(grads):
        full = g.full_tensor()
        if r == 0:
            ref = ref_g.pop(k)
            worst = max(worst, float((full.cpu() - ref).abs().max()
                                     / ref.abs().max()))
        del full
    out["grad_worst"] = worst
    out["grad_leaves"] = sum(1 for _ in optim.tree_items(grads))
    del grads
    free()
    note("gradients compared")

    # (3) the step's parameters checkpointed on (2, 2), restored on
    # (1, 4) and on one rank (rank 0); the optimizer state crosses
    # meshes in the CPU tests (tests/test_torch_sharded_lm.py)
    state = {"params": p1}
    del o1
    path, out["save_ms"] = clock(lambda: ckpt.save(root, 1, state))
    note(f"saved in {out['save_ms'] / 1e3:.1f} s")
    mesh14 = make_mesh(SHLM_REMESH, SHLM_AXES)
    s14 = {"params": tree_shardings(api.param_pspecs(cfg), mesh14,
                                    api.abstract_params(cfg))}
    (st14, _), out["restore_ms"] = clock(lambda: ckpt.restore(path, state,
                                                               s14))
    st1 = None
    if r == 0:
        like = optim.tree_map(lambda t: torch.empty(0, dtype=t.dtype,
                                                    device=dev),
                              api.abstract_params(cfg))
        st1, _ = ckpt.restore(path, {"params": like})
    note(f"restored on {SHLM_REMESH} in {out['restore_ms'] / 1e3:.1f} s "
         f"and on one rank")
    n14 = n1 = 0
    ones = {} if st1 is None else dict(ckpt._items(st1))
    for (k, a), (_, b) in zip(ckpt._items(state), ckpt._items(st14)):
        full = a.full_tensor()
        n14 += bool(torch.equal(full, b.full_tensor()))
        if k in ones:
            n1 += bool(torch.equal(full, ones[k]))
        del full
    del ones
    out["restored_equal"] = (n14, n1, sum(1 for _ in ckpt._items(state)))
    del state
    free()
    # the next step's loss and gradient norm from the restored parameters
    loss, g = step.value_and_grad(cfg32, st14["params"], b1, mesh=mesh14)
    out["next14"] = (float(loss), float(optim.global_norm(g)))
    del st14, g
    if r == 0:
        loss, g = step.value_and_grad(cfg32, st1["params"], b1)
        out["next1"] = (float(loss), float(optim.global_norm(g)))
        del st1, g
    free()
    note("next steps on (1, 4) and on one rank")
    return out


def phase_lm_sharded(dry: dict) -> list:
    """lm-sharded: tinyllama-1.1b at full width over four gloo ranks
    sharing cuda:0; returns K2's launches in the prefill, by rank.  Each
    rank's parameter bytes must equal the dry run's prediction for the
    same mesh and prefill (``dry["lm-sharded"]``: ``mem.argument`` less
    the inputs), what it holds for a decode step the prediction for
    the same mesh and decode (``dry["lm-sharded-decode"]``), and the
    float32 step's all-gathers and all-reduces the prediction for the
    same mesh and step (``dry["lm-sharded-train"]``)."""
    import tempfile

    import numpy as np
    from repro_torch.dist import spawn

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        outs = spawn(lm_sharded_rank, SHLM_RANKS, (tmp,), device="cuda:0",
                     backend="gloo", timeout_s=SHLM_TIMEOUT)
        wall = time.perf_counter() - t0
    o0 = outs[0]
    for o in outs:
        if o["backend"] != "gloo" or o["device"] != 0:
            fail(f"lm-sharded: rank {o['rank']} ran {o['backend']} on "
                 f"cuda:{o['device']}")
        if o["k2"] != 22 or o["k2_f32"]:
            fail(f"lm-sharded: rank {o['rank']} launched K2 {o['k2']} "
                 f"times in the prefill, {o['k2_f32']} of them float32, "
                 f"expected 22 (one a layer), all bf16")
        if o["k2_checked"] != 22 or not o["k2_err"] < K2_TOL["bfloat16"]:
            fail(f"lm-sharded: rank {o['rank']}'s K2 against attention_ref "
                 f"on the sharded prefill's own inputs: {o['k2_checked']} "
                 f"calls, max |err| {o['k2_err']} (tolerance "
                 f"{K2_TOL['bfloat16']})")
        if not o["finite"]:
            fail("lm-sharded: the sharded prefill's logits are not finite")
    pre = dry["lm-sharded"]
    predicted = pre["mem"]["argument"] - pre["argument_parts"]["inputs"]
    held = [o["param_bytes"] for o in outs]
    if any(h != predicted for h in held):
        fail(f"lm-sharded: the ranks hold {held} bytes of parameters, the "
             f"dry run of the same mesh and prefill predicts {predicted}")
    print(f"lm-sharded: parameter bytes a rank {held}, equal to the dry "
          f"run's prediction for the {SHLM_MESH} mesh ({predicted} = "
          f"mem.argument {pre['mem']['argument']} less the inputs "
          f"{pre['argument_parts']['inputs']})")
    dec = dry["lm-sharded-decode"]
    held = [o["decode_held"] for o in outs]
    if any(h != dec["mem"]["argument"] for h in held):
        fail(f"lm-sharded: a decode step's parameters, cache and tokens "
             f"come to {held} bytes on the ranks, the dry run of the same "
             f"mesh and decode predicts {dec['mem']['argument']}")
    ref = o0["decode_ref"]
    errs = [(float(np.abs(o["decode_logits"] - ref).max()),
             float(np.abs(o["decode_logits"] - ref).mean())) for o in outs]
    if not all(e <= ROUTE_MAX["bfloat16"] and m <= ROUTE_MEAN["bfloat16"]
               for e, m in errs):
        fail(f"lm-sharded: mesh decode vs one device, max and mean |err| "
             f"by rank {errs} (tolerances {ROUTE_MAX['bfloat16']}, "
             f"{ROUTE_MEAN['bfloat16']})")
    print(f"lm-sharded (1b): {SHLM_DECODE} bf16 decode steps at "
          f"B={PREFILL_BATCH}, cache_len {SHLM_CACHE}, the weights left "
          f"split on the mesh: logits vs one device's decode, max |err| by "
          f"rank {[format(e, '.4e') for e, _ in errs]}, mean "
          f"{[format(m, '.4e') for _, m in errs]} (tolerances "
          f"{ROUTE_MAX['bfloat16']}, {ROUTE_MEAN['bfloat16']}); ms a step "
          f"by rank {[[round(x, 1) for x in o['decode_ms']] for o in outs]} "
          f"(the first call, a step, the last in the dry run's meter); "
          f"the metered step's all-gathers on rank 0: "
          f"{o0['decode_gather']} B, the largest {o0['decode_gather_max']} "
          f"B (the dry run predicts "
          f"{dec['collective_bytes'].get('all-gather', 0)} and "
          f"{dec['collective_max_bytes'].get('all-gather', 0)} B); "
          f"parameters, cache and tokens a rank {held} B, equal to the dry "
          f"run's prediction {dec['mem']['argument']}; card: {card_line()}")
    print(f"lm-sharded: {LM_ARCH} full width on a {SHLM_MESH} mesh over "
          f"{SHLM_AXES}, {SHLM_RANKS} gloo ranks sharing cuda:0 (DTensor's "
          f"collectives staged through host copies); wq on each rank "
          f"{o0['wq'][1]}, placements {o0['wq'][0]}; K2 launches per rank "
          f"{[o['k2'] for o in outs]}, each call against attention_ref on "
          f"its rank's own inputs max |err| by rank "
          f"{', '.join(format(o['k2_err'], '.3e') for o in outs)} (tolerance "
          f"{K2_TOL['bfloat16']}); {wall:.1f} s with the ranks' start")
    if not (o0["prefill_err"] <= ROUTE_MAX["bfloat16"]
            and o0["prefill_mean"] <= ROUTE_MEAN["bfloat16"]):
        fail(f"lm-sharded: sharded prefill vs one device max |err| "
             f"{o0['prefill_err']}, mean {o0['prefill_mean']}")
    print(f"lm-sharded (1): prefill B={PREFILL_BATCH} S={PREFILL_SEQ} bf16, "
          f"last-token logits vs the one-device prefill: max |err| "
          f"{o0['prefill_err']:.4e}, mean {o0['prefill_mean']:.4e} "
          f"(tolerances {ROUTE_MAX['bfloat16']}, {ROUTE_MEAN['bfloat16']}), "
          f"argmax agree {o0['prefill_agree']:.3f}; ms a prefill by rank "
          f"{[round(o['prefill_ms'], 3) for o in outs]} (first call "
          f"{[round(o['prefill_first_ms'], 1) for o in outs]}); card: "
          f"{card_line()}")
    trn = dry["lm-sharded-train"]["collective_bytes"]
    for o in outs:
        got = o["step_coll"]
        if any(got.get(k, 0) != trn.get(k, 0)
               for k in ("all-gather", "all-reduce")):
            fail(f"lm-sharded: rank {o['rank']}'s float32 step ran "
                 f"collectives of {got} B, the dry run of the same mesh "
                 f"and step predicts {trn}")
    rl = abs(o0["loss"] - o0["ref_loss"]) / abs(o0["ref_loss"])
    rg = abs(o0["gnorm"] - o0["ref_gnorm"]) / o0["ref_gnorm"]
    if not (rl <= TRAIN_LOSS_RTOL and rg <= TRAIN_GNORM_RTOL
            and o0["grad_worst"] <= TRAIN_GRAD_RTOL):
        fail(f"lm-sharded: float32 step, sharded loss {o0['loss']} grad "
             f"norm {o0['gnorm']}, one device {o0['ref_loss']}, "
             f"{o0['ref_gnorm']}, worst leaf {o0['grad_worst']}")
    print(f"lm-sharded (2): one float32 train step B={SHLM_BATCH} "
          f"S={SHLM_SEQ}: loss {o0['loss']!r} vs one device "
          f"{o0['ref_loss']!r} (rel {rl:.3e}), grad norm {o0['gnorm']!r} vs "
          f"{o0['ref_gnorm']!r} (rel {rg:.3e}), worst gathered leaf "
          f"gradient max |diff| / max {o0['grad_worst']:.3e} over "
          f"{o0['grad_leaves']} leaves (tolerances {TRAIN_LOSS_RTOL}, "
          f"{TRAIN_GNORM_RTOL}, {TRAIN_GRAD_RTOL}); ms a step by rank "
          f"{[round(o['step_ms'], 1) for o in outs]} (in the dry run's "
          f"meter); its collectives on rank 0 {o0['step_coll']} B, the "
          f"all-gathers and all-reduces equal on every rank to the dry "
          f"run's {trn}; card: {card_line()}")
    n14, n1, n = o0["restored_equal"]
    if n14 != n or n1 != n:
        fail(f"lm-sharded: of {n} restored leaves, {n14} equal the saved "
             f"ones on {SHLM_REMESH}, {n1} on one rank")
    (l14, g14), (l1, g1) = o0["next14"], o0["next1"]
    if not (abs(l14 - l1) <= TRAIN_LOSS_RTOL * abs(l1)
            and abs(g14 - g1) <= TRAIN_GNORM_RTOL * g1):
        fail(f"lm-sharded: the next step's loss and grad norm on "
             f"{SHLM_REMESH} {l14}, {g14} vs {l1}, {g1} on one rank")
    print(f"lm-sharded (3): the step's parameters ({n} leaves) saved on "
          f"{SHLM_MESH} in {o0['save_ms'] / 1e3:.1f} s, restored on "
          f"{SHLM_REMESH} in {o0['restore_ms'] / 1e3:.1f} s and on one rank: "
          f"every leaf equal bit for bit on both; the next step's loss "
          f"{l14!r} and grad norm {g14!r} on {SHLM_REMESH} vs {l1!r}, "
          f"{g1!r} on one rank (tolerances {TRAIN_LOSS_RTOL}, "
          f"{TRAIN_GNORM_RTOL})")
    return [o["k2"] for o in outs]


#: payload keys that only the port prints, or that measure the host
CLI_OWN_KEYS = ("wall_s", "scenarios_per_sec", "device",
                "arbitration_kernel_launches")


#: a dry-run cell of its own shape and config changes, in a subprocess:
#: its record on the line that starts "RECORD "
DRYRUN_CELL = (
    "import dataclasses, json\n"
    "from repro_torch.configs import registry\n"
    "from repro_torch.configs.shapes import ShapeSpec\n"
    "from repro_torch.launch import dryrun\n"
    "cfg = dataclasses.replace(registry.get(%r), **%r)\n"
    "rec = dryrun.lm_cell(%r, ShapeSpec(%r, %d, %d, %r), %r, cfg=cfg)\n"
    "print('RECORD ' + json.dumps(rec))\n")


def dryrun_cells() -> dict:
    """name -> (kind, seq, batch, mesh, config changes) of the dry-run
    cells the phases hold their cards against: lm-sharded's prefill,
    decode and float32 train step on its (2, 2) mesh, and lm-train's
    step at B 1 x S 4096 on one device (no mesh)."""
    mesh = (SHLM_MESH, SHLM_AXES)
    return {"lm-sharded": ("prefill", PREFILL_SEQ, PREFILL_BATCH, mesh, {}),
            "lm-sharded-decode": ("decode", SHLM_CACHE, PREFILL_BATCH, mesh,
                                  {}),
            "lm-sharded-train": ("train", SHLM_SEQ, SHLM_BATCH, mesh,
                                 {"compute_dtype": "float32"}),
            "lm-train-4k": ("train", LONG_SEQ, 1, None, {})}


def start_dryrun(out: str) -> dict:
    """Start the dry run's subprocesses (no card: a fake process group
    and fake tensors on the host): the launcher for each of DRYRUN_CELLS
    on the production mesh, writing its record under ``out``, and the
    cells of ``dryrun_cells()``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    runs = {f"{a} {s}": ["-m", "repro_torch.launch.dryrun", "--arch", a,
                         "--shape", s, "--mesh", "single", "--out", out]
            for a, s in DRYRUN_CELLS}
    for name, (kind, seq, batch, mesh, kw) in dryrun_cells().items():
        runs[name] = ["-c", DRYRUN_CELL % (LM_ARCH, kw, LM_ARCH, name, seq,
                                           batch, kind, mesh)]
    procs = {}
    try:
        for name, args in runs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, *args], cwd=ROOT, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    except BaseException:
        stop(procs)
        raise
    return procs


def phase_dryrun(procs: dict, t0: float, out: str) -> dict:
    """Wait for the dry run's subprocesses (started at ``t0``) and check
    their records: every key the JAX package's record has that carries
    (``flops``, ``collective_bytes``, ``mem``, the analytic figures),
    collectives of the kinds the cell must run (none on one device), and
    the analytic FLOPs of ``models.costs``.  Prints each record; returns
    the records of ``dryrun_cells()`` by name."""
    from repro_torch.configs import registry
    from repro_torch.configs.shapes import SHAPES
    from repro_torch.models import costs

    recs = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=DRYRUN_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"dryrun: {name} ran past {DRYRUN_TIMEOUT} s")
        if proc.returncode != 0:
            fail(f"dryrun: {name} exited {proc.returncode}: "
                 f"{stderr[-2000:]}")
        if name in dryrun_cells():
            line = [x for x in stdout.splitlines()
                    if x.startswith("RECORD ")][-1]
            recs[name] = json.loads(line[len("RECORD "):])
        else:
            arch, shape = name.split()
            with open(os.path.join(out, f"{arch}__{shape}__single.json")) as f:
                recs[name] = json.load(f)
        print(f"dryrun: {name} done {time.perf_counter() - t0:.1f} s after "
              f"the start: {json.dumps(recs[name], sort_keys=True)}")
    for name, rec in recs.items():
        if "error" in rec or not all(k in rec for k in (
                "flops", "collective_bytes", "mem", "devices")) or \
                set(rec["mem"]) != {"argument", "temp", "output"} or \
                not min(rec["mem"].values()) > 0:
            fail(f"dryrun: {name}: record {rec}")
        # a simulator tile trades halos and reduces its flags; an LM step
        # gathers its weights over the data axes and, but for a decode
        # step, reduce-scatters the gradients or sequence back; one
        # device runs no collective
        kinds = {"sim": ("collective-permute", "all-reduce"),
                 "decode": ("all-gather",)}.get(
            rec["kind"], ("all-gather", "reduce-scatter"))
        if rec["devices"] == 1:
            kinds = ()
        if not all(rec["collective_bytes"].get(k, 0) > 0 for k in kinds):
            fail(f"dryrun: {name}: no {kinds} in {rec['collective_bytes']}")
        if rec["kind"] == "sim":
            continue
        cfg = registry.get(rec["arch"])
        shp = SHAPES.get(rec["shape"])
        if shp is not None:
            b, s = shp.global_batch, shp.seq_len
        else:
            _, s, b, _, _ = dryrun_cells()[name]
        want = costs.cell_flops(cfg, rec["kind"], b, s)
        if rec["analytic_flops_global"] != want or not rec["flops"] > 0 \
                or rec["n_params"] != cfg.n_params():
            fail(f"dryrun: {name}: analytic FLOPs "
                 f"{rec['analytic_flops_global']} (models.costs: {want}), "
                 f"flops {rec['flops']}, n_params {rec['n_params']}")
        print(f"dryrun: {name}: rank 0 counts {rec['flops']:.4e} FLOP, "
              f"{rec['flops'] * rec['devices'] / want:.3f} times the "
              f"analytic count's share over {rec['devices']} ranks; "
              f"argument {rec['mem']['argument']} B, temp "
              f"{rec['mem']['temp']} B, output {rec['mem']['output']} B a "
              f"rank; traced in {rec['trace_s']} s")
    return {name: recs[name] for name in dryrun_cells()}


def stop(procs: dict) -> None:
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def start_zoo_cli() -> dict:
    """Start zoo-cli's four launcher subprocesses together: the zoo on the
    card and on the CPU, a solo run on the card and the serial golden
    model."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    runs = {"zoo card": ["--zoo", ZOO_FAMILY],
            "zoo cpu": ["--zoo", ZOO_FAMILY, "--device", "cpu"],
            "solo card": SERIAL_FLAGS,
            "serial": SERIAL_FLAGS + ["--serial"]}
    procs = {}
    try:
        for name, args in runs.items():
            procs[name] = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.simulate", *args],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
    except BaseException:
        stop(procs)
        raise
    return procs


def phase_zoo_cli(procs: dict, t0: float) -> None:
    """Wait for each of zoo-cli's subprocesses (started at ``t0``) and
    check what they printed; the caller stops the rest on a failure."""
    out = {}
    for name, proc in procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"zoo-cli: {name} ran past {CLI_TIMEOUT} s")
        if proc.returncode != 0:
            fail(f"zoo-cli: {name} exited {proc.returncode}: "
                 f"{stderr[-2000:]}")
        out[name] = json.loads(stdout)
        print(f"zoo-cli: {name} done {time.perf_counter() - t0:.1f} s after "
              f"the start (its run {out[name]['wall_s']} s)")

    card, cpu = out["zoo card"], out["zoo cpu"]
    n = card["n_scenarios"]
    if n != 10 or not all(s["finished"] == 1 for s in card["scenarios"]):
        fail(f"zoo-cli: {n} scenarios, finished "
             f"{[s['finished'] for s in card['scenarios']]}")
    mine = lambda p: {k: v for k, v in p.items() if k not in CLI_OWN_KEYS}
    if mine(card) != mine(cpu):
        diffs = [_diff(c, g) for c, g in zip(cpu["scenarios"],
                                             card["scenarios"])]
        fail(f"zoo-cli: the card's payload differs from the CPU's: {diffs}")
    steps = card["arbitration_kernel_launches"] // n
    longest = max(s["cycles"] for s in card["scenarios"])
    if card["device"] != "cuda" or cpu["arbitration_kernel_launches"] or \
            card["arbitration_kernel_launches"] % n or \
            not longest <= steps < longest + 8:
        fail(f"zoo-cli: card run on {card['device']} with "
             f"{card['arbitration_kernel_launches']} fused launches for {n} "
             f"scenarios of up to {longest} cycles; CPU run "
             f"{cpu['arbitration_kernel_launches']}")
    print(f"zoo-cli: --zoo {ZOO_FAMILY}: {n} scenarios in "
          f"{card['plan']['n_buckets']} bucket, all finished (up to "
          f"{longest} cycles), card payload == CPU payload; fused Phase-2 "
          f"launches {card['arbitration_kernel_launches']}; card "
          f"{card['wall_s']} s, CPU {cpu['wall_s']} s (one thread)")
    solo, serial = out["solo card"], out["serial"]
    want = {k: v for k, v in serial.items() if k != "wall_s"}
    if {k: solo.get(k) for k in want} != want or solo["device"] != "cuda":
        fail(f"zoo-cli: --serial differs from the card's solo run: "
             f"{_diff(want, solo)}")
    print(f"zoo-cli: --serial {' '.join(SERIAL_FLAGS)} == the card's solo "
          f"run ({solo['cycles']} cycles, backend {solo['backend']}, fused "
          f"Phase-2 launches {solo['arbitration_kernel_launches']}); serial "
          f"{serial['wall_s']} s, card {solo['wall_s']} s")


#: the drivers outside the package, run on the card as a user runs them
DRIVERS = {"quickstart": ("examples/quickstart_torch.py",
                          "identical statistics: True"),
           "serve_lm": ("examples/serve_lm_torch.py",
                        "served 10 requests with continuous batching on "
                        "cuda")}


def start_drivers() -> dict:
    """Start the drivers' subprocesses on the card (beside zoo-cli's)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = {}
    try:
        for name, (path, _) in DRIVERS.items():
            procs[name] = subprocess.Popen(
                [sys.executable, os.path.join(ROOT, path)], cwd=ROOT,
                env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)
    except BaseException:
        stop(procs)
        raise
    return procs


def phase_drivers(procs: dict, t0: float) -> None:
    """Wait for the drivers (started at ``t0``): the quickstart's
    simulator on the card must give the serial model's statistics, the
    server must answer its 10 requests."""
    for name, proc in procs.items():
        path, want = DRIVERS[name]
        try:
            stdout, stderr = proc.communicate(timeout=CLI_TIMEOUT)
        except subprocess.TimeoutExpired:
            fail(f"drivers: {path} ran past {CLI_TIMEOUT} s")
        if proc.returncode != 0 or want not in stdout:
            fail(f"drivers: {path} exited {proc.returncode} without "
                 f"{want!r}: {stdout[-1500:]} {stderr[-1500:]}")
        tail = [x.strip() for x in stdout.splitlines() if x.strip()]
        print(f"drivers: {path} done {time.perf_counter() - t0:.1f} s after "
              f"the start: {' | '.join(tail[-3:] if name == 'serve_lm' else tail)}")


def timed(name: str, fn, *args):
    """Run one phase and print its seconds."""
    t0 = time.perf_counter()
    res = fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return res


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        fail(f"{src}/repro_torch not found: run from a checkout of the repo")
    sys.path.insert(0, src)

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})")

    # work for the host alone runs beside the phases from the start: the
    # wedge's CPU run and the dry run's subprocesses
    import multiprocessing
    t_start = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn")) as pool, \
            tempfile.TemporaryDirectory() as out:
        dry = {}
        try:
            wedge_cpu = pool.submit(wedge_on_cpu, src)
            dry = start_dryrun(out)
            run_phases(dev, card, wedge_cpu, (dry, t_start, out))
        finally:
            stop(dry)


def run_phases(dev, card: str, wedge_cpu, dryrun) -> None:
    """Every phase in order, then the kernels line and the last line.
    ``wedge_cpu`` is the future of the wedge's CPU run, ``dryrun`` the dry
    run's subprocesses, their start and their output directory."""
    import torch

    timed("build", phase_build)
    rec_k1 = timed("kernel", phase_kernel, dev)
    rec_p2 = timed("kernel-phase2", phase_kernel_phase2, dev)
    rec_k2 = timed("kernel-K2", phase_kernel_k2, dev)
    timed("wedge", phase_wedge, dev, wedge_cpu)
    paper_launches, rec_k1["launches"], paper_ms = timed(
        "paper", phase_paper, dev)
    sweep_launches, sweep_got = timed("sweep-208", phase_sweep, dev,
                                      paper_ms)
    sharded_launches = timed("sharded", phase_sharded, sweep_got)
    # zoo-cli's and the drivers' subprocesses run beside the plan phase
    # (none is timed for a claim); all end before the timed LM phases
    t_zoo = time.perf_counter()
    zoo, drivers = start_zoo_cli(), start_drivers()
    try:
        plan_launches = timed("plan", phase_plan, dev)
        timed("zoo-cli", phase_zoo_cli, zoo, t_zoo)
        timed("drivers", phase_drivers, drivers, t_zoo)
    finally:
        stop(zoo)
        stop(drivers)
    dry = timed("dryrun", phase_dryrun, *dryrun)
    # the fused kernel's main paths: paper-208's run, the sweep's and the
    # sharded runs' (every rank's)
    rec_p2["launches"] = paper_launches + sweep_launches + sharded_launches
    print(f"launches: phase2_router {paper_launches} (paper-208) + "
          f"{sweep_launches} (sweep-208) + {sharded_launches} (sharded, all "
          f"ranks) = {rec_p2['launches']}; the plan's run {plan_launches}; "
          f"router_arbitrate {rec_k1['launches']}")
    cfg, params, rec_k2["launches"] = timed("lm-prefill", phase_lm_prefill,
                                            dev)
    timed("lm-decode", phase_lm_decode, dev, cfg, params)
    timed("lm-serve", phase_lm_serve, dev, cfg, params)
    timed("lm-train", phase_lm_train, dev, cfg, params, dry["lm-train-4k"])
    del params
    torch.cuda.empty_cache()
    sharded_k2 = timed("lm-sharded", phase_lm_sharded, dry)
    family_launches = 0
    for name, arch, k2_want in LM_FAMILIES:
        family_launches += timed(name, phase_lm_family, dev, name, arch,
                                 k2_want)
        timed(f"{name}-train", phase_lm_family_train, dev, name, arch)
    print(f"launches: flash_attention {rec_k2['launches']} (tinyllama "
          f"prefill) + {sum(sharded_k2)} (the sharded prefill, by rank "
          f"{sharded_k2}) + {family_launches} (the other families' "
          f"prefills)")
    rec_k2["launches"] += sum(sharded_k2) + family_launches
    rec_k2["sharded_launches_per_rank"] = sharded_k2
    # the float32 kernel: none on the main path (every prefill above
    # fails on one); the rest of this process's launches are checks
    from repro_torch.kernels.flash_attention import F32_LAUNCHES
    rec_k2["float32_launches"] = 0
    rec_k2["float32_check_launches"] = (F32_LAUNCHES.n
                                        - rec_k2["float32_timing_launches"])
    print(f"launches: flash_attention_f32 0 on the main path, "
          f"{rec_k2['float32_check_launches']} in the checks, "
          f"{rec_k2['float32_timing_launches']} in its timing")

    print(card)
    print(json.dumps({"kernels": [rec_k1, rec_p2, rec_k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
