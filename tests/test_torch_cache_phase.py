"""The cache-phase kernel (``kernels/csrc/cache_phase.cu``) off the card.

The kernel runs only on the card (``tests/test_torch_gpu.py`` holds it
against the torch phases there).  Here, on the CPU:

* the kernel's per-node code, compiled for the host with the system's
  C++ compiler over a small header that stands in for CUDA's (each node
  in turn, as the kernel's threads would run it), is held leaf for leaf
  and in the statistics against ``phase1b(phase1a(...))`` on mid-run
  states where every handler fires;
* the wrapper refuses CPU tensors and what the kernel does not take;
* the ctypes structure, the statistics, message types, states and
  tables copied into the source match the package's;
* the in-place cycle on the CPU still runs the torch phases, and the
  bytes the wrapper counts as ``cache_write_bytes`` are what
  ``cache.put`` counts there.
"""
import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import cache, config, sim
from repro_torch.core.config import CacheConfig, SimConfig
from repro_torch.core.state import (CACHE_LEAVES, STAT_NAMES, SimState,
                                    geometry_to, init_state, make_geometry,
                                    make_node_ctx, widen_state)
from repro_torch.kernels import build, cache_phase

SOURCE = (build.CSRC / "cache_phase.cu").read_text()

#: what the host build includes in place of ``cuda_runtime.h``
HOST_SHIM = r"""
#pragma once
#include <stdint.h>
#include <algorithm>
using std::min;
using std::max;
#define __device__
#define __forceinline__ inline
#define __constant__
"""

#: run in place of the kernel and its launch: every node in turn, its
#: statistic increments added as the kernel's CTAs add them
HOST_DRIVER = r"""
void host_all(const Phase1Args& a) {
  for (int i = 0; i < a.n; ++i) {
    unsigned int cnt[NUM_STATS] = {0};
    const Node d{a, i, cnt};
    phase1a(d, *a.knob_mig, *a.knob_mig_thr, *a.knob_central);
    phase1b(d, *a.knob_central);
    for (int k = 0; k < NUM_STATS; ++k)
      reinterpret_cast<unsigned int*>(a.stats)[k] += cnt[k];
  }
}
}  // namespace
extern "C" void phase1_cache_host(const Phase1Args* a) { host_all(*a); }
"""

TINY = CacheConfig(2, 2, 32, 2, 2, 64)
#: tiny caches over a small address space, short queues and a threshold
#: of 1: every handler, eviction, write-back, drop and timeout fires
STRESS = dict(rows=6, cols=6, cache=TINY, addr_bits=11, mem_cycles=5,
              req_timeout=24, send_queue=4, fwd_entries=2,
              migrate_threshold=1, livelock_window=0)
HOST_CASES = {
    "home-packed-depth4": SimConfig(**STRESS, centralized_directory=False,
                                    dir_layout="home",
                                    state_dtype_policy="packed"),
    "home-packed-depth1": SimConfig(**STRESS, centralized_directory=False,
                                    dir_layout="home",
                                    state_dtype_policy="packed", pc_depth=1),
    "flat-wide-depth2": SimConfig(**STRESS, centralized_directory=False,
                                  pc_depth=2),
    # one directory at node 0: replies come later
    "central-packed": SimConfig(**STRESS, state_dtype_policy="packed"),
    "migration-off-sq8": SimConfig(**dict(STRESS, send_queue=8,
                                          migration_enabled=False,
                                          cache=CacheConfig(4, 2, 32, 2, 4,
                                                            64)),
                                   centralized_directory=False),
}


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's per-node code (the source up to the kernel itself),
    compiled for the host with :data:`HOST_DRIVER` in place of the
    kernel and its launch."""
    d = tmp_path_factory.mktemp("cache_phase_host")
    (d / "cuda_runtime.h").write_text(HOST_SHIM)
    body = SOURCE[:SOURCE.index("__global__")]
    (d / "host.cpp").write_text(body + HOST_DRIVER)
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the host build needs a C++ compiler"
    proc = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                           "-I", str(d), "-o", str(d / "host.so"),
                           str(d / "host.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(d / "host.so"))
    lib.phase1_cache_host.argtypes = [ctypes.POINTER(cache_phase._Phase1Args)]
    lib.phase1_cache_host.restype = None
    return lib


def stress_trace(cfg, seed=5, m=200):
    """Uniform addresses of the whole space, each node's trace ended by
    -1 from a random point on."""
    rng = np.random.default_rng(seed)
    tr = rng.integers(0, 1 << cfg.addr_bits, size=(cfg.num_nodes, m),
                      dtype=np.int32)
    end = m * 3 // 4 + rng.integers(0, m // 4, cfg.num_nodes)
    tr[np.arange(m)[None, :] >= end[:, None]] = -1
    return tr


@pytest.mark.parametrize("name", list(HOST_CASES))
def test_host_build_of_the_kernel_equals_the_torch_phases(host_kernel, name):
    cfg = HOST_CASES[name]
    vs = sim.VectorSim(cfg, stress_trace(cfg), device="cpu")
    ctx = make_node_ctx(cfg, "cpu")
    fired = np.zeros(len(STAT_NAMES), np.int64)
    cycles = 192 if cfg.centralized_directory else 96
    for c in range(1, cycles + 1):
        vs.step()
        if c % 6:
            continue
        s = vs.state
        with torch.inference_mode():
            want = cache.phase1b(cache.phase1a(widen_state(s), cfg, ctx),
                                 cfg, ctx)
        w = SimState(*(x.clone() for x in widen_state(s, CACHE_LEAVES)))
        host_kernel.phase1_cache_host(ctypes.byref(cache_phase._pack(w,
                                                                     cfg)))
        for k, got, ref in zip(SimState._fields, w, want):
            assert got.dtype == getattr(s, k).dtype or k not in CACHE_LEAVES
            assert torch.equal(got.to(torch.int32), ref), (c, k)
        fired += (want.stats - s.stats).numpy()
    # the states held exercised the handlers that write the caches,
    # directory, forwarding table and send queue
    for k in ("reply_sent", "reply_rcvd", "dir_search", "dir_update",
              "mem_req", "l1_misses", "l2_local_misses", "req_made"):
        assert fired[STAT_NAMES.index(k)] > 0, k
    if cfg.migration_enabled:
        assert fired[STAT_NAMES.index("migrations")] > 0
    if cfg.pc_depth > 1:
        assert fired[STAT_NAMES.index("stray")] > 0


def small_state(cfg, dev="cpu"):
    tr = stress_trace(cfg, m=16)
    return widen_state(init_state(cfg, tr, dev), CACHE_LEAVES)


def test_wrapper_refuses_cpu_tensors():
    cfg = HOST_CASES["home-packed-depth4"]
    before = cache_phase.LAUNCHES.n
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cache_phase.phase1_cache_cuda(small_state(cfg), cfg)
    assert cache_phase.LAUNCHES.n == before


def test_checks_refuse_what_the_kernel_does_not_take():
    cfg = HOST_CASES["home-packed-depth4"]
    w = small_state(cfg)
    cache_phase.check_phase1_inputs(w, cfg)            # what it takes
    for policy in ("wide", "packed"):
        c = SimConfig(**dict(STRESS, state_dtype_policy=policy))
        cache_phase.check_phase1_inputs(small_state(c), c)
    bad = {
        "a batch": w._replace(st=w.st[None]),
        "a tile": w._replace(st=w.st[:-1]),
        "an unwidened leaf": w._replace(ctr=w.ctr.to(torch.int16)),
        "a widened cache leaf": w._replace(l1_tag=w.l1_tag.to(torch.int64)),
        "a float trace": w._replace(trace=w.trace.float()),
        "a strided leaf": w._replace(pc=w.pc.transpose(0, 1).contiguous()
                                     .transpose(0, 1)),
        "another device": w._replace(q_size=w.q_size.to("meta")),
        "another geometry": w._replace(l2_lru=w.l2_lru[:, :1]),
        "a flat directory": w._replace(dir_loc=w.dir_loc.reshape(-1)),
    }
    for what, x in bad.items():
        with pytest.raises((ValueError, TypeError)):
            cache_phase.check_phase1_inputs(x, cfg)
            pytest.fail(f"took {what}")
    with pytest.raises(ValueError):
        cache_phase.check_phase1_inputs(
            w, SimConfig(**dict(STRESS, fwd_entries=0)))


def test_ctypes_structure_matches_the_source():
    body = re.search(r"struct Phase1Args \{(.*?)\};", SOURCE, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    ptrs = re.findall(r"\*\s*(\w+);", body)
    ints = [x.strip() for x in
            re.search(r"\bint ([^;]*);", body).group(1).split(",")]
    assert ptrs == list(cache_phase._P1_POINTERS)
    assert ints == list(cache_phase._P1_INTS)
    assert [k for k, _ in cache_phase._Phase1Args._fields_] == ptrs + ints
    assert len(ptrs) + len(ints) == len(re.findall(r"[;,]", body))


def test_copied_constants_match_the_package():
    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", SOURCE).group(1))

    def table(name):
        vals = re.search(rf"{name}\[\d+\] = \{{([^}}]*)\}}", SOURCE).group(1)
        return tuple(int(x) for x in vals.split(","))
    for k, v in vars(config).items():
        if k.startswith(("MSG_", "ST_")) or k in ("INSTALL_L2",
                                                  "INSTALL_L1_ONLY"):
            assert const(k) == v, k
    stats = dict(re.findall(r"STAT_(\w+) = (\d+)", SOURCE))
    assert {k: int(v) for k, v in stats.items() if k != "S"} == {
        k.upper(): STAT_NAMES.index(k) for k in STAT_NAMES
        if k.upper() in stats}
    assert len(stats) == 21                 # every statistic phase 1 bumps
    assert const("NUM_STATS") == len(STAT_NAMES)
    assert table("FLITS_OF") == config.FLITS_OF
    assert table("NEED_OF") == cache.NEED_OF
    assert const("STREAK_MAX") == torch.iinfo(torch.int16).max
    assert 1 << 30 == cache.BIG and "1u << 30" in SOURCE


def test_in_place_cycle_on_the_cpu_runs_the_torch_phases(monkeypatch):
    """``sim._cycle`` with ``in_place`` on the CPU calls ``phase1a`` and
    ``phase1b`` (by their names in ``sim``, as the benchmark wraps them)
    and never the kernel's wrapper; the bytes the kernel's wrapper would
    count a cycle are what ``cache.put`` counts there."""
    cfg = HOST_CASES["home-packed-depth4"]
    s = init_state(cfg, stress_trace(cfg, m=16), "cpu")
    geo = geometry_to(make_geometry(cfg.rows, cfg.cols), "cpu")
    ctx = make_node_ctx(cfg, "cpu")
    called = []
    for k in ("phase1a", "phase1b"):
        fn = getattr(sim, k)
        monkeypatch.setattr(sim, k, lambda *a, _k=k, _fn=fn:
                            called.append(_k) or _fn(*a))

    def refuse(*a):
        raise AssertionError("the kernel's wrapper ran on the CPU")
    monkeypatch.setattr(cache_phase, "phase1_cache_cuda", refuse)
    before = cache_phase.LAUNCHES.n
    tracing.RECORDER.drain()
    tracing.RECORDER.start()
    try:
        with torch.inference_mode():
            for _ in range(3):
                assert sim._cycle(s, cfg, geo, ctx, in_place=True) is not None
    finally:
        tracing.RECORDER.stop()
    spans, counters = tracing.RECORDER.drain()
    assert called == ["phase1a", "phase1b"] * 3
    assert cache_phase.LAUNCHES.n == before
    assert "phase1" not in {sp.name for sp in spans}
    w = widen_state(s, CACHE_LEAVES)
    assert counters["cache_write_bytes"] == 3 * cache_phase.write_bytes(w)
