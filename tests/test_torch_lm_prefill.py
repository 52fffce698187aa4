"""Port parity: ``api.prefill`` (a prompt written into the cache in one
call) against the JAX package's ``prefill``, and its reference defect R4.

Reduced tinyllama-1.1b, float32 compute, B 2 x S 12 into a 16-slot
cache, parameters carried across from ``repro``'s seeded init
(``tests/torch_lm_parity.py``).  The port keeps the JAX package's mask
as it is: the cache slots past the write index as it stood BEFORE the
write are masked, so each prompt token sees only the first prompt
token's key.  Twelve ``decode_step`` calls give the forward's logits
(1e-4); the one-call prefill does not (its last-token logits are off by
far more than the tolerance, 0.659 in the JAX package).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import api as japi

import torch_lm_parity as lm
from repro_torch.models import api

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
B, S, CACHE = 2, 12, 16


@pytest.fixture(scope="module")
def runs():
    cfg_j, cfg_t, pj, pt = lm.setup(ARCH, "float32")
    tokens = np.random.default_rng(3).integers(
        0, cfg_t.vocab, (B, S)).astype(np.int32)
    jl, jc = japi.prefill(cfg_j, pj, {"tokens": jnp.asarray(tokens)},
                          japi.init_cache(cfg_j, B, CACHE))
    tl, tc = api.prefill(cfg_t, pt, {"tokens": tokens},
                         api.init_cache(cfg_t, B, CACHE, "cpu"),
                         device="cpu")
    cache = api.init_cache(cfg_t, B, CACHE, "cpu")
    for i in range(S):
        dl, cache = api.decode_step(cfg_t, pt, cache, tokens[:, i:i + 1],
                                    device="cpu")
    fwd, _ = api.forward_logits(cfg_t, pt, {"tokens": tokens},
                                device="cpu")
    return {"jax": (np.asarray(jl), jc), "port": (tl.numpy(), tc),
            "decode": (dl.numpy(), cache), "forward": fwd[:, -1].numpy()}


def test_prefill_equals_jax(runs):
    jl, jc = runs["jax"]
    tl, tc = runs["port"]
    assert tl.shape == (B, lm.registry.reduced(ARCH).vocab)
    assert np.max(np.abs(tl - jl)) < lm.F32_TOL
    assert int(tc["idx"]) == int(jc["idx"]) == S
    for name in ("k", "v"):
        assert np.max(np.abs(tc[name].numpy() - np.asarray(jc[name]))) \
            < lm.F32_TOL, name


def test_prefill_keeps_defect_r4_against_decode_steps(runs):
    tl, tc = runs["port"]
    dl, dc = runs["decode"]
    # twelve decode steps track the cache-free forward ...
    assert np.max(np.abs(dl - runs["forward"])) < lm.F32_TOL
    # ... and write the first layer's keys and values (computed before
    # any masked attention) as the one-call prefill does, and its index
    for name in ("k", "v"):
        assert np.max(np.abs(tc[name][0].numpy() - dc[name][0].numpy())) \
            < lm.F32_TOL, name
    assert int(tc["idx"]) == int(dc["idx"]) == S
    # but the prefill's masked attention gives other logits (R4)
    assert np.max(np.abs(tl - dl)) > 0.1
