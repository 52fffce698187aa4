"""The driver steps each scenario's state in place (``sim._drive``).

Each cycle's result is written back into the scenario's own tensors (on
a CUDA device by the cycle's CUDA graph, here on the CPU by narrowing
the pure ``cycle_step``'s result into them), so the state is the same
memory from the first cycle to the last.  Against the pure step
(``tests/torch_drive_eager.py``): every statistic and the abort record
of ``_drive`` equal those of stepping each scenario alone through
``VectorSim.step``, solo and as a sweep with differing knobs, over chunk
boundaries and monitor edges; no leaf moves; no output leaf of a cycle
shares memory with another input leaf; and on the CPU nothing is
captured or replayed.  The cycle a CUDA graph captures
(``sim._cycle`` with ``in_place``: the cache-phase kernel, here its host
build, ``tests/torch_cache_host.py``), driven on the CPU in place of the
pure step, equals it too, in every statistic, abort record and leaf, and
reads and writes no whole L1 or L2 array."""
import collections
import functools

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core import sim, sweep
from repro_torch.core.config import CacheConfig, SimConfig
from repro_torch.core.state import (CACHE_LEAVES, STAT_NAMES, SimState,
                                    init_state, leaf_dtypes, narrow_state,
                                    stats_totals)
from repro_torch.core.workloads import resolve_trace

import torch_cache_host as ch
import torch_drive_eager as de


@pytest.fixture(autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


CFG = dict(rows=8, cols=8, state_dtype_policy="packed", mem_cycles=6,
           livelock_window=4, sat_window=16, max_cycles=2000)
#: every core stalls on memory long enough to trip the livelock window
STALL = dict(CFG, mem_cycles=80)

# (config, scenarios as (app, seed, refs, knobs), cycles, chunk, the
# first scenario's abort): one reference a core and a long memory
# latency trip the livelock window; matmul's references with a short one
# keep data replies and multi-flit packets going past the cycle cap; at
# 16x16 the centralized directory saturates at the second window edge
CASES = {
    "solo-livelock": (STALL, [("random", 3, 1, {})], 100, 8,
                      sim.ABORT_LIVELOCK),
    "solo-busy": (dict(CFG, state_dtype_policy="wide"),
                  [("matmul", 3, 8, {})], 61, 8, 0),
    "solo-16x16-saturation": (
        dict(CFG, rows=16, cols=16, centralized_directory=True,
             livelock_window=0), [("random", 5, 8, {})], 36, 8,
        sim.ABORT_SATURATION),
    "sweep3": (CFG, [("matmul", 3, 8, {}),
                     ("matmul", 4, 8, {"migration_enabled": False}),
                     ("random", 5, 8, {"eject_age_threshold": 4,
                                       "migrate_threshold": 1})], 60, 8, 0),
    "sweep3-livelock": (STALL, [("random", 3, 1, {}),
                                ("matmul", 4, 8,
                                 {"migration_enabled": False}),
                                ("matmul", 5, 8, {"eject_age_threshold": 4,
                                                  "migrate_threshold": 1})],
                        100, 8, sim.ABORT_LIVELOCK),
}


@functools.lru_cache(maxsize=None)
def driven(name):
    """Each case driven once; both tests below read it."""
    kw, scenarios, cycles, chunk, _ = CASES[name]
    return de.drive(SimConfig(**kw), scenarios, cycles, chunk, "cpu")


@pytest.mark.parametrize("name", list(CASES))
def test_drive_equals_stepping_the_pure_cycle(name):
    d = driven(name)
    assert sim.stats_list(d.out, d.aux) == [w for w, _, _ in d.want]
    assert d.records() == [r for _, r, _ in d.want]
    assert d.records()[0][0] == CASES[name][-1]     # the abort paths ran
    assert d.unequal_leaves() == []


@pytest.mark.parametrize("name", ["solo-livelock", "solo-busy", "sweep3",
                                  "sweep3-livelock"])
def test_drive_steps_every_leaf_in_place(name):
    d = driven(name)
    b = len(CASES[name][1])
    per = [d.ptrs[i::b] for i in range(b)]
    assert all(len(p) == d.steps for p in per) and d.steps >= 37
    # each scenario's leaves are the same memory at every cycle, and that
    # memory is the input's: the returned state is the input stepped
    assert all(p == p[:1] * len(p) for p in per)
    assert [x.data_ptr() for x in d.state] == d.before
    assert all(x.data_ptr() == y.data_ptr() for k, x, y in
               zip(SimState._fields, d.out, d.state) if k != "cycle")
    assert d.shared == []
    assert d.counters.get("graph_captures", 0) == 0
    assert d.counters.get("graph_replays", 0) == 0
    assert d.launches == 0                  # the plain Phase 2 runs here


def test_run_and_sweep_consume_their_state_with_equal_results():
    """``sim.run`` and ``sweep.run_sweep``, which hand ``_drive`` a state
    it steps in place, equal each scenario's pure steps."""
    cfg = SimConfig(**CFG)
    spec = sweep.SweepSpec(cfg, tuple(
        sweep.ScenarioSpec("random", seed, 8, eject_age_threshold=e)
        for seed, e in ((1, 0), (2, 4))))
    traces = spec.traces()
    want = [de.eager(sc.resolve_cfg(cfg), traces[b], 20, "cpu")[0]
            for b, sc in enumerate(spec.scenarios)]
    assert sweep.run_sweep(spec, max_cycles=20, chunk=8, device="cpu") == want
    assert sim.run(cfg, traces[0], max_cycles=20, chunk=8,
                   device="cpu") == want[0]


def test_narrow_state_into_casts_in_place_and_keeps_shared_leaves():
    cfg = SimConfig(**CFG)
    trace = resolve_trace(cfg, "random", 4, 1)
    dst = init_state(cfg, trace, "cpu")
    dtypes = leaf_dtypes(cfg, trace.shape[-1])
    wide = SimState(*(x.to(torch.int32) for x in dst))
    wide = wide._replace(
        l2_streak=torch.full_like(wide.l2_streak,
                                  torch.iinfo(torch.int16).max + 5),
        pkt_ctr=torch.full_like(wide.pkt_ctr, (1 << 16) + 7),
        stats=wide.stats + 3, trace=dst.trace)
    ptrs = [x.data_ptr() for x in dst]
    out = narrow_state(wide, dtypes, into=dst)
    assert all(x is y for x, y in zip(out, dst))
    assert [x.data_ptr() for x in dst] == ptrs
    assert all(x.dtype == dtypes[k] for k, x in zip(SimState._fields, dst))
    # the two casts that change a value: streaks saturate, packet ids wrap
    assert (dst.l2_streak == torch.iinfo(torch.int16).max).all()
    assert torch.equal(dst.pkt_ctr, narrow_state(wide, dtypes).pkt_ctr)
    assert stats_totals(dst.stats_hi, dst.stats).sum() == 3 * len(STAT_NAMES)


#: Table 4's caches cut to a few entries a node (L1 2 sets x 4 ways, L2 2
#: x 4) under matmul, migration on a single remote hit: within 200
#: cycles L1 and L2 blocks are evicted, L2 hits and migrations fire, and
#: two writes of one cycle land in one node's row of one array.  (At 8
#: L2 ways no L2 block is evicted in a CPU test's few hundred cycles;
#: the card's test runs Table 4 row 1 itself.)
TINY = SimConfig(**dict(CFG, cache=CacheConfig(l1_sets=2, l1_ways=4,
                                               l2_sets=2, l2_ways=4),
                        livelock_window=None, migrate_threshold=1,
                        centralized_directory=False, dir_layout="home"))


def _flat(xs):
    for x in xs:
        if isinstance(x, (list, tuple)):
            yield from x
        else:
            yield x


class Watch(TorchDispatchMode):
    """Every operation that reads or writes one of the arrays ``leaves``
    other than by gathering entries (``index``) or writing them
    (``index_put_``), and every new tensor of an array's shape."""

    def __init__(self, leaves):
        super().__init__()
        self.ptrs = {x.untyped_storage().data_ptr() for x in leaves}
        self.shapes = {tuple(x.shape) for x in leaves}
        self.bad = []

    def mine(self, x):
        return (isinstance(x, torch.Tensor)
                and x.untyped_storage().data_ptr() in self.ptrs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if (any(self.mine(a) for a in _flat(args))
                and func not in (torch.ops.aten.index.Tensor,
                                 torch.ops.aten.index_put_.default)):
            self.bad.append(str(func))
        self.bad.extend(str(func) for o in _flat((out,))
                        if isinstance(o, torch.Tensor) and not self.mine(o)
                        and tuple(o.shape) in self.shapes)
        return out


#: cycles run under :class:`Watch` (it costs ~50 us an operation here):
#: the cycle issues the same operations every cycle, whatever the data
WATCHED = range(0, 200, 20)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The cache-phase kernel's per-node code compiled for the host."""
    return ch.build_host(tmp_path_factory.mktemp("cache_phase_host"))


def drive_in_place(lib, cfg, scenarios, cycles, chunk, cycle=de.in_place):
    """:func:`de.drive` with ``cycle`` (the in-place cycle) in place of
    the pure step and the host build ``lib`` in place of the kernel's
    wrapper."""
    with ch.standing_in(lib):
        return de.drive(cfg, scenarios, cycles, chunk, "cpu", cycle=cycle)


@functools.lru_cache(maxsize=None)
def tiny_in_place(lib):
    """The TINY case driven in place, the cycles of WATCHED watched, and
    the entries of ``l1_tag`` and ``l2_tag`` each cycle replaced by
    another block, by array."""
    watches = []
    evicted = collections.Counter()
    cycle = 0

    def step(x, cfg, geo, ctx):
        nonlocal cycle
        tags = {k: getattr(x, k).clone() for k in ("l1_tag", "l2_tag")}
        if cycle in WATCHED:
            with Watch([getattr(x, k) for k in CACHE_LEAVES]) as w:
                out = de.in_place(x, cfg, geo, ctx)
            watches.append(w)
        else:
            out = de.in_place(x, cfg, geo, ctx)
        for k, old in tags.items():
            new = getattr(x, k)
            evicted[k] += int(((old >= 0) & (new >= 0) & (old != new)).sum())
        cycle += 1
        return out
    d = drive_in_place(lib, TINY, [("matmul", 3, 64, {})], 200, 8,
                       cycle=step)
    return d, watches, evicted


def test_in_place_cycle_equals_the_pure_step_where_caches_evict(host_kernel):
    d, _, evicted = tiny_in_place(host_kernel)
    assert d.steps == 200 and d.cache_launches == d.steps
    got = sim.stats_list(d.out, d.aux)
    assert got == [w for w, _, _ in d.want]
    assert d.records() == [r for _, r, _ in d.want]
    assert d.unequal_leaves() == []
    st = got[0]
    assert st["l2_local_hits"] and st["migrations"] and st["l1_hits"]
    assert st["wb_sent"] + st["wb_miss"]          # L1 victims
    assert evicted["l1_tag"] and evicted["l2_tag"]


def test_in_place_cycle_touches_no_whole_cache_array(host_kernel):
    d, watches, _ = tiny_in_place(host_kernel)
    assert len(watches) == len(WATCHED)
    assert all(w.bad == [] for w in watches)


@pytest.mark.parametrize("name", ["solo-livelock", "sweep3",
                                  "solo-16x16-saturation"])
def test_in_place_drive_equals_the_pure_step(host_kernel, name):
    """``_drive`` stepping every scenario with the in-place cycle, the
    kernel's host build as its phase 1, equals each scenario's pure
    steps: statistics, abort records and every leaf."""
    kw, scenarios, cycles, chunk, abort = CASES[name]
    d = drive_in_place(host_kernel, SimConfig(**kw), scenarios, cycles,
                       chunk)
    assert d.cache_launches == len(scenarios) * d.steps
    assert sim.stats_list(d.out, d.aux) == [w for w, _, _ in d.want]
    assert d.records() == [r for _, r, _ in d.want]
    assert d.records()[0][0] == abort
    assert d.unequal_leaves() == []
