"""Port parity: simulator state layout, dtypes and the stats accumulator.

Every leaf of the port's ``SimState`` must map one to one onto the JAX
package's: same name, shape, storage dtype and values.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import state as jstate
from repro.core.config import SimConfig as JConfig
from repro.core.workloads import app_trace, random_trace

from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import state as tstate
from repro_torch.core.config import SimConfig as TConfig

CONFIGS = [
    dict(rows=4, cols=4, addr_bits=14),
    dict(rows=3, cols=5, addr_bits=13, centralized_directory=False,
         dir_layout="home", pc_depth=2),
    dict(rows=4, cols=4, addr_bits=14, centralized_directory=False,
         pc_depth=1, max_cycles=50_000),
]


def jax_leaves(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def assert_leaves_equal(want, got):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("policy", ["wide", "packed"])
@pytest.mark.parametrize("kw", CONFIGS)
def test_init_state_leaf_by_leaf(kw, policy):
    jc = JConfig(state_dtype_policy=policy, **kw)
    tc = TConfig(state_dtype_policy=policy, **kw)
    solo = app_trace(jc, "matmul", 12, 2)
    batched = np.stack([solo, random_trace(jc, 12, 5)])
    for tr in (solo, batched):
        want = jax_leaves(jstate.init_state(jc, tr))
        got = state_to_numpy(tstate.init_state(tc, tr, "cpu"))
        assert_leaves_equal(want, got)
    want_dt = {k: np.dtype(v) for k, v in jstate.leaf_dtypes(jc, 12).items()}
    got_dt = {k: torch.empty(0, dtype=v).numpy().dtype
              for k, v in tstate.leaf_dtypes(tc, 12).items()}
    assert got_dt == want_dt


@pytest.mark.parametrize("kw", CONFIGS + [
    dict(rows=208, cols=208, max_cycles=32, centralized_directory=False,
         dir_layout="home")])
def test_state_bytes_identical(kw):
    for policy in ("wide", "packed"):
        for trace_len in (8, 200):
            jc = JConfig(**kw)
            tc = TConfig(**kw)
            assert tstate.state_bytes(tc, trace_len, policy) == \
                jstate.state_bytes(jc, trace_len, policy)


def test_geometry_identical():
    jg = jstate.make_geometry(3, 5)
    tg = tstate.make_geometry(3, 5)
    for a, b in zip(jg, tg):
        assert np.array_equal(a, b) and a.dtype == b.dtype


def test_fold_stats_negative_low_word():
    lo = np.array([-1, -(1 << 30) - 5, 5, (1 << 30) + 7, -(1 << 31)],
                  np.int32)
    hi = np.array([3, 2, 0, 1, 4], np.int32)
    jh, jl = jstate.fold_stats(jnp.asarray(hi), jnp.asarray(lo))
    th, tl = tstate.fold_stats(torch.from_numpy(hi), torch.from_numpy(lo))
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert np.array_equal(tl.numpy(), np.asarray(jl))
    assert tl.dtype == torch.int32 and th.dtype == torch.int32
    assert np.array_equal(tstate.stats_totals(th, tl),
                          jstate.stats_totals(jh, jl))


def test_narrow_wraps_pkt_ctr_and_saturates_l2_streak():
    kw = dict(rows=4, cols=4, addr_bits=14, state_dtype_policy="packed")
    jc, tc = JConfig(**kw), TConfig(**kw)
    tr = app_trace(jc, "matmul", 12, 2)
    js = jstate.widen_state(jstate.init_state(jc, tr))
    js = js._replace(
        pkt_ctr=js.pkt_ctr.at[3].set(40_000).at[5].set(70_001),
        l2_streak=js.l2_streak.at[1, 2, 0].set(40_000).at[2, 0, 1].set(7))
    ts = state_from_numpy(jax_leaves(js), "cpu")
    assert ts.pkt_ctr.dtype == torch.int32
    want = jax_leaves(jstate.narrow_state(js, jstate.leaf_dtypes(jc, 12)))
    got = state_to_numpy(tstate.narrow_state(ts, tstate.leaf_dtypes(tc, 12)))
    assert_leaves_equal(want, got)
    assert got["l2_streak"][1, 2, 0] == 32767      # saturated, not wrapped
    assert got["pkt_ctr"][3] == np.int16(-25536)   # wrapped like jnp
    widened = state_to_numpy(tstate.widen_state(state_from_numpy(got, "cpu")))
    assert all(v.dtype == np.int32 for k, v in widened.items()
               if k != "trace")


def test_bump_all_equals_sequential_jax_bumps():
    rng = np.random.default_rng(0)
    stats = torch.from_numpy(rng.integers(0, 100, tstate.NUM_STATS)
                             .astype(np.int32))
    m1 = torch.from_numpy(rng.random(9) < 0.5)
    m2 = torch.from_numpy(rng.random(9) < 0.5)
    grid = torch.from_numpy(rng.integers(0, 3, (9, 4)).astype(np.int32))
    scalar = torch.tensor(7, dtype=torch.int32)
    bumps = [("stray", m1), ("hops", grid), ("stray", m2),
             ("send_drop", scalar), ("mem_req", m2)]
    got = tstate.bump_all(stats, bumps)
    assert got.dtype == torch.int32
    want = jnp.asarray(stats.numpy())
    for name, amount in bumps:
        want = jstate.bump(want, name, jnp.asarray(amount.numpy()))
    assert np.array_equal(got.numpy(), np.asarray(want))
    idx = tstate.STAT_INDEX
    assert got[idx["stray"]] == stats[idx["stray"]] + m1.sum() + m2.sum()
    one = tstate.bump(tstate.bump(stats, "trap", m1), "trap", 5)
    assert one.dtype == torch.int32
    assert np.array_equal(one.numpy(), np.asarray(jstate.bump(jstate.bump(
        jnp.asarray(stats.numpy()), "trap", jnp.asarray(m1.numpy())),
        "trap", 5)))


def test_convert_round_trip_and_rejects_wrong_leaves():
    jc = JConfig(rows=3, cols=3, addr_bits=13, state_dtype_policy="packed")
    leaves = jax_leaves(jstate.init_state(jc, app_trace(jc, "apsi", 9, 1)))
    assert_leaves_equal(leaves, state_to_numpy(state_from_numpy(leaves,
                                                                "cpu")))
    with pytest.raises(ValueError):
        state_from_numpy({k: v for k, v in leaves.items() if k != "pc"},
                         "cpu")
    with pytest.raises(ValueError):
        state_from_numpy({**leaves, "extra": leaves["pc"]}, "cpu")


def test_home_layout_needs_distributed_directory():
    tc = TConfig(rows=4, cols=4, dir_layout="home")
    with pytest.raises(ValueError):
        tstate.init_state(tc, np.zeros((16, 4), np.int32), "cpu")
    assert dataclasses.replace(tc, centralized_directory=False).dir_entries
