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
captured or replayed."""
import functools

import pytest
import torch

from repro_torch.core import sim, sweep
from repro_torch.core.config import SimConfig
from repro_torch.core.state import (STAT_NAMES, SimState, init_state,
                                    leaf_dtypes, narrow_state, stats_totals)
from repro_torch.core.workloads import resolve_trace

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
