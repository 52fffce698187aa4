"""Port parity, end to end: the port's ``run`` on the CPU against the JAX
package's ``repro.core.sim.run`` and the serial golden model ``SerialSim``
on the ``tests/test_equivalence.py`` cases (centralized directory here,
distributed in ``test_torch_sim_dist.py``).  Statistics and cycle counts
must be identical.
"""
import pytest
import torch

from repro.core import sim as jsim
from repro.core.config import SimConfig as JConfig
from repro.core.ref_serial import SerialSim
from repro.core.workloads import app_trace, random_trace

from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig as TConfig

torch.set_num_threads(1)


def equivalence_trace(cfg, app, refs, seed):
    return (random_trace(cfg, refs, seed) if app == "random"
            else app_trace(cfg, app, refs, seed))


def assert_port_equals_references(kw, app, seed, refs=30, serial=True):
    """The port's ``run`` (CPU) equals the JAX run and, if ``serial``,
    the serial golden model, on ``SimConfig(**kw)``."""
    jc, tc = JConfig(**kw), TConfig(**kw)
    tr = equivalence_trace(jc, app, refs, seed)
    got = tsim.run(tc, tr, device="cpu")
    want = jsim.run(jc, tr)
    assert got == want, {k: (want.get(k), got.get(k))
                         for k in set(want) | set(got)
                         if want.get(k) != got.get(k)}
    if serial:
        assert got == SerialSim(jc, tr).run()
    return got


@pytest.mark.parametrize("app,seed", [("matmul", 1), ("equake", 7)])
def test_end_to_end_identical_centralized(app, seed):
    got = assert_port_equals_references(
        dict(rows=4, cols=4, addr_bits=14, migrate_threshold=2,
             centralized_directory=True), app, seed)
    assert got["finished"] == 1
