"""Port parity on the former S14 wedge (16x16, distributed directory,
``app_trace_loop(cfg, "matmul", 20, 0)``): at the default ``pc_depth``
it runs to completion, identical to the JAX package's run."""
import torch

from repro.core import sim as jsim
from repro.core.config import SimConfig as JConfig
from repro.core.workloads import app_trace_loop

from repro_torch.core import sim as tsim
from repro_torch.core.config import SimConfig as TConfig

torch.set_num_threads(1)


def test_former_wedge_completes_identical_to_jax():
    kw = dict(rows=16, cols=16, centralized_directory=False,
              max_cycles=200_000)
    jc, tc = JConfig(**kw), TConfig(**kw)
    assert tc.pc_depth > 1
    tr = app_trace_loop(jc, "matmul", 20, 0)
    got = tsim.run(tc, tr, chunk=16, device="cpu")
    assert got["finished"] == 1 and "aborted" not in got, got
    want = jsim.run(jc, tr, chunk=16)
    assert got == want, {k: (want.get(k), got.get(k))
                         for k in set(want) | set(got)
                         if want.get(k) != got.get(k)}
