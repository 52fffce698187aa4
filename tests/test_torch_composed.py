"""Port parity of the composed backend (scenarios x rows x cols over
ranks, ``repro_torch.core.sharded.run_composed``), the sweep's scenario
split over ranks and the planner's sharded/composed buckets.

The ``tests/test_composed.py`` contract: every degenerate grid is exact
— ``(1, 1, 1)`` is a solo run, an indivisible scenario axis pads with
copies like ``run_sweep`` — and a livelock-aborted scenario leaves its
healthy batch-mate's result untouched.  Ranks are gloo processes on the
CPU started by :func:`repro_torch.dist.spawn`.  Two JAX programs are
compiled: ``run_sweep`` of the padding case and the batched
``ShardedSim`` of the livelock case.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import engine as jengine
from repro.core import sweep as jsweep
from repro.core.config import SimConfig as JConfig
from repro.core.sharded import ShardedSim as JShardedSim
from repro.core.trace import app_trace, app_trace_loop

from repro_torch import dist as rdist
from repro_torch.core import engine as tengine
from repro_torch.core import sim as tsim
from repro_torch.core import sweep as tsweep
from repro_torch.core.config import SimConfig as TConfig
from repro_torch.core.sharded import run_composed, run_sharded
from repro_torch.core.workloads import resolve_trace

torch.set_num_threads(1)

#: short memory latency, so each scenario ends in a few hundred cycles
KW = dict(rows=4, cols=4, addr_bits=14, mem_cycles=8, migrate_threshold=2,
          centralized_directory=False)
TIMEOUT = 600
S = tsweep.ScenarioSpec


def ranks(tmp_path, fn, n, *args):
    """``fn(*args)`` on ``n`` gloo ranks on the CPU; results by rank."""
    return rdist.spawn(fn, n, args, device="cpu",
                       init_method=f"file://{tmp_path}/store",
                       timeout_s=TIMEOUT)


def diff(want, got):
    return [{k: (w.get(k), g.get(k)) for k in set(w) | set(g)
             if w.get(k) != g.get(k)} for w, g in zip(want, got)]


def solo_runs(spec, max_cycles=None):
    """Each scenario of ``spec`` as a solo run on the home layout."""
    hc = dataclasses.replace(spec.cfg, dir_layout="home")
    out = []
    for sc in spec.scenarios:
        c = sc.resolve_cfg(hc)
        out.append(tsim.run(c, resolve_trace(c, sc.app, sc.refs_per_core,
                                             sc.seed),
                            max_cycles=max_cycles, chunk=16, device="cpu"))
    return out


TWO = tsweep.SweepSpec(TConfig(**KW), (
    S("matmul", 0, 10), S("mgrid", 1, 12, migration_enabled=False)))


def test_composed_single_rank_degenerates_to_solo(tmp_path):
    """grid (1, 1, 1), with no process group and on one gloo rank: the
    composed machinery reproduces solo runs, a per-scenario knob too."""
    want = solo_runs(TWO)
    got = run_composed(TWO, (1, 1, 1), chunk=16, device="cpu")
    assert got == want, diff(want, got)
    (one,) = ranks(tmp_path, run_composed, 1, TWO, (1, 1, 1), None, 16,
                   "cpu")
    assert one == want, diff(want, one)


def test_composed_clamps_max_cycles(tmp_path):
    """Two scenario shards, capped at 100 cycles with chunk 64: every
    scenario stops at exactly the cap, as the dense backend does."""
    spec = tsweep.SweepSpec(TConfig(**{**KW, "mem_cycles": 100}), (
        S("mgrid", 1, 25), S("matmul", 0, 25)))
    want = solo_runs(spec, max_cycles=100)
    got = ranks(tmp_path, run_composed, 2, spec, (2, 1, 1), 100, 64, "cpu")
    for g in got:
        assert [x["cycles"] for x in g] == [100, 100]
        assert not any(x["finished"] for x in g)
        assert g == want, diff(want, g)


PAD = tsweep.SweepSpec(TConfig(**KW), (
    S("mgrid", 2, 12), S("matmul", 0, 10, migration_enabled=False),
    S("equake", 1, 8, migrate_threshold=1)))


def test_composed_pads_an_indivisible_batch(tmp_path):
    """Three scenarios over two scenario shards of 2x1 tiles (four
    ranks): the batch pads to four, and every scenario equals its solo
    run and JAX's ``run_sweep``."""
    want = solo_runs(PAD)
    jspec = jsweep.SweepSpec(JConfig(**{**KW, "dir_layout": "home"}), tuple(
        jsweep.ScenarioSpec(**dataclasses.asdict(sc)) for sc in PAD.scenarios))
    assert jsweep.run_sweep(jspec, chunk=16) == want
    got = ranks(tmp_path, run_composed, 4, PAD, (2, 2, 1), None, 32, "cpu")
    for g in got:
        assert g == want, diff(want, g)


def test_composed_batched_livelock_abort_with_healthy_batchmate(tmp_path):
    """The wedge (16x16 matmul seed 0 refs 20, loop trace, ``pc_depth=1``)
    aborts as livelock at a chunk edge with its diagnostics, while the
    healthy scenario on the other scenario shard finishes as its solo
    run; both equal JAX's batched ``ShardedSim`` (``livelock_window``
    cut to 256, as in ``test_torch_livelock.py``)."""
    kw = dict(rows=16, cols=16, centralized_directory=False,
              dir_layout="home", max_cycles=30_000, pc_depth=1,
              livelock_window=256)
    jc, tc = JConfig(**kw), TConfig(**kw)
    wedge = app_trace_loop(jc, "matmul", 20, 0)
    healthy = app_trace(jc, "equake", 10, 1)
    m = max(wedge.shape[1], healthy.shape[1])
    tr = np.full((2, tc.num_nodes, m), -1, np.int32)   # -1 = exhaustion pad
    tr[0, :, :wedge.shape[1]] = wedge
    tr[1, :, :healthy.shape[1]] = healthy
    got = ranks(tmp_path, run_sharded, 2, tc, tr, (2, 1, 1), None, 128,
                None, "cpu")
    import jax
    mesh = jax.make_mesh((1, 1, 1), ("scenario", "data", "model"))
    want = JShardedSim(jc, tr, mesh, batch_axes=("scenario",)).run(chunk=128)
    for g in got:
        assert g == want, diff(want, g)
    g = got[0]
    assert g[0]["aborted"] == "livelock" and g[0]["finished"] == 0
    assert g[0]["cycles"] < 30_000
    assert g[0]["circulating_flits"] > 50
    assert g[0]["wait_dir_nodes"] + g[0]["wait_data_nodes"] > 128
    assert g[1] == tsim.run(tc, healthy, chunk=64, device="cpu")


def test_composed_rejects_centralized_and_too_few_ranks():
    with pytest.raises(ValueError, match="centralized"):
        run_composed(tsweep.SweepSpec(TConfig(**KW), (
            S("matmul", centralized_directory=True),)), (1, 1, 1))
    with pytest.raises(ValueError, match="needs 4 rank"):
        run_composed(tsweep.SweepSpec(TConfig(**KW), (S("matmul"),)),
                     (1, 2, 2))


def test_sweep_over_two_ranks_equals_one_rank(tmp_path):
    """run_sweep inside a group of two splits three scenarios 2 + 2 (a
    padding copy) and gives every rank the three results in order."""
    one = tsweep.run_sweep(PAD, chunk=8, device="cpu")
    got = ranks(tmp_path, tsweep.run_sweep, 2, PAD, None, 8, "cpu")
    assert got == [one, one]


@pytest.mark.parametrize("force", ["composed", "sharded"])
def test_plan_runs_its_buckets_on_the_ranks(tmp_path, force):
    """A 4x4/6x6 plan on four ranks: ``compile_plan`` costs it for the
    group (ndev 4, as JAX plans it), and each bucket runs on its backend —
    composed grids for both buckets, or the spatial backend for the 6x6
    and the sweep's scenario split for the 4x4 pair (two scenarios are
    not one spatial run) — equal to solo runs."""
    items = [(4, 4, "matmul", 0, 4), (6, 6, "equake", 1, 3),
             (4, 4, "random", 2, 4)]
    base_kw = dict(addr_bits=14, mem_cycles=8, centralized_directory=False)
    tscs = [tengine.make_scenario(TConfig(**base_kw), r, c, a, s, n)
            for r, c, a, s, n in items]
    jscs = [jengine.make_scenario(JConfig(**base_kw), r, c, a, s, n)
            for r, c, a, s, n in items]
    want = [tsim.run(sc.cfg, resolve_trace(sc.cfg, sc.app, sc.refs_per_core,
                                           sc.seed), chunk=8, device="cpu")
            for sc in tscs]
    plan = tengine.compile_plan(tscs, ndev=4, force_backend=force)
    assert plan.describe() == jengine.compile_plan(
        jscs, ndev=4, force_backend=force).describe()
    backends = {"composed": ["composed", "composed"],
                "sharded": ["sweep", "sharded"]}[force]
    assert [b.backend for b in plan.buckets] == backends
    got = ranks(tmp_path, tengine.plan_and_run, 4, tscs, None, 8, force,
                None, None, "cpu")
    for g in got:
        assert g == want, diff(want, g)
