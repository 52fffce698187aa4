"""Port parity, end to end: mesh shape, storage and directory layouts,
batching, chunking and the cycle-by-cycle lockstep with ``SerialSim``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import sim as jsim
from repro.core.config import SimConfig as JConfig
from repro.core.ref_serial import SerialSim
from repro.core.workloads import app_trace, random_trace

from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig as TConfig
from test_torch_sim import assert_port_equals_references

torch.set_num_threads(1)


def test_nonsquare_mesh():
    assert_port_equals_references(dict(rows=3, cols=5, addr_bits=14),
                                  "apsi", 11, refs=25)


def test_flat_vs_home_directory_layout():
    kw = dict(rows=3, cols=4, addr_bits=14, centralized_directory=False)
    tc = TConfig(**kw)
    tr = app_trace(JConfig(**kw), "wupwise", 12, 5)
    flat = tsim.run(tc, tr, device="cpu")
    home = tsim.run(dataclasses.replace(tc, dir_layout="home"), tr,
                    device="cpu")
    assert flat == home == jsim.run(JConfig(**kw), tr)


def test_packed_equals_wide_and_batch_equals_solo_runs():
    """A (B, N, M) trace runs as B scenarios that equal the JAX batched
    run (itself equal to solo runs) and their own solo run; chunked
    termination checks change nothing; the packed layout gives the wide
    layout's results."""
    kw = dict(rows=3, cols=3, addr_bits=13, migrate_threshold=2,
              centralized_directory=False)
    jc, tc = JConfig(**kw), TConfig(**kw)
    a = app_trace(jc, "matmul", 10, 4)
    b = random_trace(jc, 6, 6)
    batch = np.full((2, 9, 10), -1, np.int32)
    batch[0], batch[1, :, :6] = a, b
    packed = dataclasses.replace(tc, state_dtype_policy="packed")
    got = tsim.run(packed, batch, chunk=16, device="cpu")
    assert got == jsim.run(jc, batch, chunk=16)
    assert got[1] == tsim.run(tc, b, device="cpu")
    agg = tsim.aggregate_stats(got)
    assert agg == jsim.aggregate_stats(got)
    assert tsim.network_health(agg) == jsim.network_health(agg)


def test_lockstep_state_with_serial_model():
    """Cycle by cycle: the FSM, trace pointer and send-queue fill match
    the serial golden model (as ``test_equivalence.test_lockstep_state``)."""
    kw = dict(rows=3, cols=3, addr_bits=13, migrate_threshold=2)
    jc, tc = JConfig(**kw), TConfig(**kw)
    tr = app_trace(jc, "matmul", 20, 4)
    ss = SerialSim(jc, tr)
    vs = tsim.VectorSim(tc, tr, device="cpu")
    for cyc in range(300):
        ss.step()
        vs.step()
        s = vs.state
        assert np.array_equal(ss.st, s.st.numpy()), cyc
        assert np.array_equal(ss.tr_ptr, s.tr_ptr.numpy()), cyc
        assert np.array_equal(np.array([len(q) for q in ss.sendq]),
                              s.q_size.numpy()), cyc
        if ss.finished():
            break
    assert ss.finished() == bool(vs.stats()["finished"])
    assert vs.run() == SerialSim(jc, tr).run()


def test_packed_cycle_cap_is_checked():
    tc = TConfig(rows=2, cols=2, max_cycles=10, state_dtype_policy="packed")
    tr = np.zeros((4, 2), np.int32)
    with pytest.raises(ValueError, match="max_cycles"):
        tsim.run(tc, tr, max_cycles=11, device="cpu")
