"""Port parity: Phase-2 router arbitration.

The port's plain ``arbitrate_ref`` must be bit-exact against the JAX
package's ``arbitrate_ref`` and its Pallas kernel (run in interpret mode,
as the JAX package's own tests run it on the CPU).  The CUDA kernel is
held against the same plain version on the card in
``test_torch_gpu.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.ref import arbitrate_ref as jax_arbitrate_ref
from repro.kernels.router_phase import router_arbitrate_pallas
from test_noc_properties import random_arb_case as jax_random_arb_case

from repro_torch.kernels import ops
from repro_torch.kernels.ref import arbitrate_ref, random_arb_case
from repro_torch.kernels.router_phase import (ARB_LAUNCHES,
                                              router_arbitrate_cuda)

torch.set_num_threads(1)

SIZES = list(range(1, 401)) + [127, 128, 129]


def torch_case(arrs, device="cpu"):
    return [torch.from_numpy(a).to(device) for a in arrs]


def test_random_arb_case_matches_the_test_helper():
    for seed, n in ((0, 1), (1, 37), (2, 129), (3, 400)):
        a = random_arb_case(np.random.default_rng(seed), n)
        b = jax_random_arb_case(np.random.default_rng(seed), n)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and np.array_equal(x, y)


def test_arbitrate_ref_matches_jax_ref_every_size():
    cases = [random_arb_case(np.random.default_rng(seed), n)
             for seed, n in enumerate(SIZES)]
    # the JAX oracle is per router, so one call on all cases stacked is
    # the same as one call per case
    stacked = [np.concatenate(xs) for xs in zip(*cases)]
    ja, jd = map(np.asarray, jax_arbitrate_ref(*map(jnp.asarray, stacked)))
    off = 0
    for arrs in cases:
        n = arrs[0].shape[0]
        ta, td = arbitrate_ref(*torch_case(arrs))
        assert ta.dtype == torch.int32 and td.dtype == torch.bool
        assert np.array_equal(ta.numpy(), ja[off:off + n]), n
        assert np.array_equal(td.numpy(), jd[off:off + n]), n
        off += n


@pytest.mark.parametrize("n", [1, 127, 128, 129, 400, sum(SIZES)])
def test_arbitrate_ref_matches_pallas_interpret(n):
    """The Pallas kernel pads to 128-router tiles: the tile edges, and all
    of ``SIZES`` as one stacked case (every size at its own offset)."""
    if n == sum(SIZES):
        cases = [random_arb_case(np.random.default_rng(seed), k)
                 for seed, k in enumerate(SIZES)]
        arrs = [np.concatenate(xs) for xs in zip(*cases)]
    else:
        arrs = random_arb_case(np.random.default_rng(1000 + n), n)
    pa, pd = map(np.asarray, router_arbitrate_pallas(
        *map(jnp.asarray, arrs), interpret=True))
    ta, td = arbitrate_ref(*torch_case(arrs))
    assert np.array_equal(ta.numpy(), pa)
    assert np.array_equal(td.numpy(), pd)


def test_ops_dispatches_cpu_tensors_to_the_plain_version():
    arrs = torch_case(random_arb_case(np.random.default_rng(5), 50))
    before = ARB_LAUNCHES.n
    a, d = ops.arbitrate(*arrs)
    ra, rd = arbitrate_ref(*arrs)
    assert torch.equal(a, ra) and torch.equal(d, rd)
    assert ARB_LAUNCHES.n == before


def test_cuda_wrapper_refuses_cpu_tensors():
    arrs = torch_case(random_arb_case(np.random.default_rng(6), 8))
    before = ARB_LAUNCHES.n
    with pytest.raises(ValueError, match="CUDA"):
        router_arbitrate_cuda(*arrs)
    assert ARB_LAUNCHES.n == before
