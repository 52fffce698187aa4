"""Port parity of the serial golden model (``repro_torch.core.ref_serial``).

The port keeps its own copy of the JAX package's numpy ``SerialSim``
(over the port's config, with ``STAT_NAMES`` from the port's state).  It
must give the JAX package's ``SerialSim`` statistics and the port's
vectorized ``run`` (CPU), bit for bit.
"""
import pytest
import torch

from repro.core import ref_serial as jserial
from repro.core.config import SimConfig as JConfig

from repro_torch.core import ref_serial as tserial
from repro_torch.core import sim as tsim
from repro_torch.core import state as tstate
from repro_torch.core.config import SimConfig as TConfig
from repro_torch.core.workloads import resolve_trace

torch.set_num_threads(1)


@pytest.mark.parametrize("kw,app,seed,refs", [
    (dict(rows=4, cols=4, addr_bits=14, mem_cycles=8, migrate_threshold=1,
          centralized_directory=True), "matmul", 3, 8),
    (dict(rows=4, cols=4, addr_bits=14, mem_cycles=8, pc_depth=2,
          centralized_directory=False), "hotspot:frac=0.8,hot=2", 1, 6),
])
def test_serial_model_equals_the_reference_and_the_port(kw, app, seed, refs):
    tc, jc = TConfig(**kw), JConfig(**kw)
    tr = resolve_trace(tc, app, refs, seed)
    got = tserial.SerialSim(tc, tr).run()
    assert got == jserial.SerialSim(jc, tr).run()
    assert got == tsim.run(tc, tr, chunk=8, device="cpu")
    assert got["finished"] == 1


def test_stat_names_are_the_ports():
    assert tserial.STAT_NAMES is tstate.STAT_NAMES
    assert tserial.STAT_NAMES == jserial.STAT_NAMES
