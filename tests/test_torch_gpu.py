"""The port on the card: the CUDA kernel and the main path.

Every test here needs a CUDA GPU (marker ``gpu``) and skips itself
without one; the file imports neither JAX nor ``repro``, so it runs on a
machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import sim
from repro_torch.core.config import SimConfig
from repro_torch.core.workloads import app_trace
from repro_torch.kernels import ops
from repro_torch.kernels.ref import arbitrate_ref, random_arb_case
from repro_torch.kernels.router_phase import LAUNCHES, router_arbitrate_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (the kernel has no CPU mode)")
    return torch.device("cuda")


def case(seed, n, device):
    return [torch.from_numpy(a).to(device)
            for a in random_arb_case(np.random.default_rng(seed), n)]


def test_kernel_bit_exact_against_plain_version(cuda):
    for seed, n in enumerate(list(range(1, 401)) + [127, 128, 129, 43_264]):
        args = case(seed, n, cuda)
        before = LAUNCHES.n
        got_a, got_d = ops.arbitrate(*args)
        assert LAUNCHES.n == before + 1
        ref_a, ref_d = arbitrate_ref(*args)
        assert torch.equal(got_a, ref_a) and torch.equal(got_d, ref_d), n


def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    args = case(0, 8, cuda)
    before = LAUNCHES.n
    with pytest.raises(TypeError):
        router_arbitrate_cuda(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        router_arbitrate_cuda(args[0][:, :4], *args[1:])
    with pytest.raises(ValueError):
        router_arbitrate_cuda(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError):
        router_arbitrate_cuda(args[0], args[1].cpu(), *args[2:])
    assert LAUNCHES.n == before


def test_main_path_on_the_card_equals_the_cpu_run(cuda):
    cfg = SimConfig(rows=4, cols=4, addr_bits=14, migrate_threshold=2,
                    centralized_directory=False,
                    state_dtype_policy="packed")
    tr = app_trace(cfg, "mgrid", 20, 2)
    LAUNCHES.reset()
    got = sim.run(cfg, tr, chunk=16)              # default device: cuda
    assert LAUNCHES.n > 0
    assert got == sim.run(cfg, tr, chunk=16, device="cpu")
    assert got["finished"] == 1
