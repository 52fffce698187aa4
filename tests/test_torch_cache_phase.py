"""The cache-phase kernel (``kernels/csrc/cache_phase.cu``) off the card.

The kernel runs only on the card (``tests/test_torch_gpu.py`` holds it
against the torch phases there).  Here, on the CPU:

* the kernel's per-node code, compiled for the host with the system's
  C++ compiler over a small header that stands in for CUDA's (each node
  in turn, as the kernel's threads would run it;
  ``tests/torch_cache_host.py``), is held leaf for leaf and in the
  statistics against ``phase1b(phase1a(...))`` on mid-run states where
  every handler fires;
* the wrapper refuses CPU tensors and what the kernel does not take;
* the ctypes structure, the statistics, message types, states and
  tables copied into the source match the package's;
* the in-place cycle calls the kernel's wrapper once a cycle, in place
  of the torch phases, and on the CPU it raises without the host build.
"""
import collections
import ctypes
import re

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.core import cache, config, sim
from repro_torch.core.config import CacheConfig, SimConfig
from repro_torch.core.state import (CACHE_LEAVES, STAT_NAMES, SimState,
                                    geometry_to, init_state, make_geometry,
                                    make_node_ctx, widen_state)
from repro_torch.kernels import cache_phase

import torch_cache_host as ch

SOURCE = ch.SOURCE

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
    """The kernel's per-node code compiled for the host."""
    return ch.build_host(tmp_path_factory.mktemp("cache_phase_host"))


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


def test_in_place_cycle_on_the_cpu_runs_the_torch_phases(host_kernel,
                                                        monkeypatch):
    """``sim._cycle`` with ``in_place`` calls the kernel's wrapper
    (``cache_phase.phase1_cache_cuda``, by attribute) once a cycle under
    a ``phase1`` span, and neither ``phase1a`` nor ``phase1b`` (by their
    names in ``sim``, as the benchmark wraps them); on a CPU state it
    raises through the wrapper, and with the host build standing in it
    steps the state in place."""
    cfg = HOST_CASES["home-packed-depth4"]
    s = init_state(cfg, stress_trace(cfg, m=16), "cpu")
    geo = geometry_to(make_geometry(cfg.rows, cfg.cols), "cpu")
    ctx = make_node_ctx(cfg, "cpu")
    for k in ("phase1a", "phase1b"):
        monkeypatch.setattr(sim, k, lambda *a, _k=k: pytest.fail(
            f"the in-place cycle ran {_k}"))
    with torch.inference_mode(), pytest.raises(ValueError,
                                               match="needs CUDA tensors"):
        sim._cycle(s, cfg, geo, ctx, in_place=True)
    before = cache_phase.LAUNCHES.n
    tracing.RECORDER.drain()
    tracing.RECORDER.start()
    try:
        with torch.inference_mode(), ch.standing_in(host_kernel):
            for _ in range(3):
                out = sim._cycle(s, cfg, geo, ctx, in_place=True)
                assert all(x is y for x, y in zip(out, s))
    finally:
        tracing.RECORDER.stop()
    spans, _ = tracing.RECORDER.drain()
    assert cache_phase.LAUNCHES.n == before + 3
    names = collections.Counter(sp.name for sp in spans)
    assert names["phase1"] == 3
    assert names["phase1a"] == names["phase1b"] == 0
    assert int(s.cycle) == 3
