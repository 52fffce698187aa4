"""Port parity on the livelock monitor: the former wedge with the paper's
single completion register (``pc_depth=1``) livelocks, and the port
aborts it at the JAX package's cycle with the same diagnostics."""
import torch

from repro.core import sim as jsim
from repro.core.config import SimConfig as JConfig
from repro.core.workloads import app_trace_loop

from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig as TConfig

torch.set_num_threads(1)


def test_wedge_at_depth_1_aborts_as_livelock_like_jax():
    kw = dict(rows=16, cols=16, centralized_directory=False, pc_depth=1,
              livelock_window=256, max_cycles=30_000)
    jc, tc = JConfig(**kw), TConfig(**kw)
    tr = app_trace_loop(jc, "matmul", 20, 0)
    got = tsim.run(tc, tr, chunk=16, device="cpu")
    assert got.get("aborted") == "livelock" and got["finished"] == 0, got
    assert got["circulating_flits"] > 0
    want = jsim.run(jc, tr, chunk=16)
    assert got == want, {k: (want.get(k), got.get(k))
                         for k in set(want) | set(got)
                         if want.get(k) != got.get(k)}
