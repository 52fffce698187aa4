"""Port parity, one phase at a time, from mid-run JAX states.

A JAX ``VectorSim`` runs a ``test_equivalence`` config; at a mid-run
cycle its state is carried across (``repro_torch.convert``) and each of the four
phases — and a whole ``cycle_step`` — is applied by both packages to the
same input.  Every state leaf must come out equal (shape, dtype, values),
under the ``wide`` and ``packed`` layouts and the ``flat`` and ``home``
directory layouts.
"""
import numpy as np
import pytest
import torch

from repro.core import cache as jcache
from repro.core import noc as jnoc
from repro.core import sim as jsim
from repro.core import state as jstate
from repro.core.config import SimConfig as JConfig
from repro.core.workloads import app_trace, random_trace

from repro_torch.convert import state_from_numpy, state_to_numpy
from repro_torch.core import cache as tcache
from repro_torch.core import noc as tnoc
from repro_torch.core import sim as tsim
from repro_torch.core import state as tstate
from repro_torch.core.config import SimConfig as TConfig

torch.set_num_threads(1)

CASES = {
    "central-wide-flat": (dict(rows=4, cols=4, migrate_threshold=2),
                          "matmul", 1),
    "dist-wide-home": (dict(rows=4, cols=4, migrate_threshold=2,
                            centralized_directory=False, dir_layout="home"),
                       "mgrid", 2),
    "dist-packed-flat": (dict(rows=4, cols=4, migrate_threshold=2,
                              centralized_directory=False,
                              state_dtype_policy="packed"), "random", 3),
    "dist-packed-home-depth1": (dict(rows=4, cols=4,
                                     centralized_directory=False,
                                     dir_layout="home", pc_depth=1,
                                     state_dtype_policy="packed"),
                                "equake", 7),
    "nonsquare-wide-flat": (dict(rows=3, cols=5), "apsi", 11),
}
SNAPSHOTS = (150,)


def jax_leaves(s):
    return {k: np.asarray(v) for k, v in s._asdict().items()}


def assert_leaves_equal(want, got, where):
    for k in want:
        assert got[k].dtype == want[k].dtype, (where, k)
        assert got[k].shape == want[k].shape, (where, k)
        bad = np.argwhere(got[k] != want[k])
        assert bad.size == 0, (where, k, bad[:4].tolist())


@pytest.mark.parametrize("name", list(CASES))
def test_each_phase_leaves_every_leaf_equal(name):
    kw, app, seed = CASES[name]
    jc = JConfig(addr_bits=14, **kw)
    tc = TConfig(addr_bits=14, **kw)
    tr = (random_trace(jc, 25, seed) if app == "random"
          else app_trace(jc, app, 25, seed))
    vs = jsim.VectorSim(jc, tr)
    jctx = jstate.make_node_ctx(jc)
    jgeo = jstate.make_geometry(jc.rows, jc.cols)
    tctx = tstate.make_node_ctx(tc, "cpu")
    tgeo = tstate.geometry_to(tstate.make_geometry(tc.rows, tc.cols), "cpu")
    port = lambda s: state_from_numpy(jax_leaves(s), "cpu")

    for cyc in range(1, max(SNAPSHOTS) + 1):
        vs.step()
        if cyc not in SNAPSHOTS:
            continue
        # whole cycle (storage dtypes: widen + phases + fold + narrow)
        want = jsim.cycle_step(vs.state, jc, jgeo, jctx)
        got = tsim.cycle_step(port(vs.state), tc, tgeo, tctx)
        assert_leaves_equal(jax_leaves(want), state_to_numpy(got),
                            (cyc, "cycle_step"))
        # phase by phase, each from the JAX state before it
        s = jstate.widen_state(vs.state)
        for phase in ("1a", "1b", "2", "3"):
            inp = port(s)
            if phase == "1a":
                s, got = (jcache.phase1a(s, jc, jctx),
                          tcache.phase1a(inp, tc, tctx))
            elif phase == "1b":
                s, got = (jcache.phase1b(s, jc, jctx),
                          tcache.phase1b(inp, tc, tctx))
            elif phase == "2":
                (s, jarb), (got, tarb) = (jnoc.phase2(s, jc, jctx),
                                          tnoc.phase2(inp, tc, tctx))
                for field in ("out", "ej_port", "has_ej", "n_deflected",
                              "n_injected"):
                    a = np.asarray(getattr(jarb, field))
                    b = getattr(tarb, field).numpy()
                    assert np.array_equal(a, b), (cyc, field)
            else:
                s, got = (jnoc.phase3(s, jc, jgeo, jctx, jarb),
                          tnoc.phase3(inp, tc, tgeo, tctx, tarb))
            assert_leaves_equal(jax_leaves(s), state_to_numpy(got),
                                (cyc, phase))
