"""Port parity: the LM layers and K2's plain version against the JAX
package, on the CPU.

* ``attention_ref`` (K2's plain version) against
  ``repro.kernels.ref.attention_ref`` at the four ``test_kernels.py``
  shapes and a grouped-query case, with ``test_kernels.py``'s tolerances
  (1e-5 in float32, 5e-2 in bfloat16);
* ``rmsnorm``, ``rope``, ``swiglu``, ``attn_block`` (without a cache, with
  one, and with the rolling ``window > 0`` slot) and ``_blocked_attention``
  (full and banded) against the JAX functions at float32, within 1e-5
  (different summation orders of the same float32 arithmetic).

The CUDA kernel is held against the same plain version on the card in
``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import api as japi
from repro.models import common as jcommon

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention, ops
from repro_torch.models import common

torch.set_num_threads(1)

#: float32 tolerance of the layer comparisons: the same arithmetic summed
#: in another order
TOL = 1e-5


def f32(x):
    return np.asarray(x, np.float32)


def tt(x, dtype=None):
    """A numpy (or JAX) array as a CPU tensor of its own."""
    a = np.array(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a) if dtype is None else \
        torch.from_numpy(a).to(dtype)


@pytest.mark.parametrize("b,h,kv,s,d,dtype,causal", [
    (1, 2, 2, 256, 64, "float32", True),
    (2, 1, 1, 128, 128, "bfloat16", True),
    (1, 4, 4, 384, 64, "float32", False),
    (2, 2, 2, 512, 32, "bfloat16", True),
    (2, 8, 2, 256, 64, "float32", True),     # GQA: 4 heads per KV head
])
def test_attention_ref_matches_jax(b, h, kv, s, d, dtype, causal):
    rng = np.random.default_rng(0)
    jdt = jnp.dtype(dtype)
    q = jnp.asarray(rng.standard_normal((b, h, s, d)), jdt)
    k = jnp.asarray(rng.standard_normal((b, kv, s, d)), jdt)
    v = jnp.asarray(rng.standard_normal((b, kv, s, d)), jdt)
    rep = h // kv
    want = jax_attention_ref(q, jnp.repeat(k, rep, axis=1),
                             jnp.repeat(v, rep, axis=1), causal=causal)
    got = ops.attention(tt(q), tt(k), tt(v), causal=causal)   # CPU: plain
    assert got.dtype == getattr(torch, dtype)
    err = np.max(np.abs(f32(want) - got.float().numpy()))
    tol = 5e-2 if dtype == "bfloat16" else 1e-5
    assert err < tol, err


def test_kernel_wrapper_needs_cuda_tensors():
    x = torch.zeros((1, 1, 128, 64))
    before = flash_attention.LAUNCHES.n
    with pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(x, x, x)
    assert flash_attention.LAUNCHES.n == before


@functools.lru_cache(maxsize=None)
def _layer_params(cfg_name="tinyllama-1.1b"):
    cfg_j = dataclasses.replace(jregistry.reduced(cfg_name),
                                compute_dtype="float32")
    cfg_t = dataclasses.replace(registry.reduced(cfg_name),
                                compute_dtype="float32")
    pj = jax.jit(lambda key: japi.init_params(cfg_j, key))(
        jax.random.key(3))
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu",
                                   cfg_t)
    lj = jax.tree.map(lambda a: a[0], pj["layers"])
    lt = {k: {n: x[0] for n, x in sub.items()}
          for k, sub in pt["layers"].items()}
    return cfg_j, cfg_t, lj, lt


def test_rmsnorm_rope_swiglu_match_jax():
    cfg_j, cfg_t, lj, lt = _layer_params()
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 12, cfg_j.d_model)).astype(np.float32)
    scale = rng.standard_normal(cfg_j.d_model).astype(np.float32)
    got = common.rmsnorm(tt(x), tt(scale), 1e-5)
    assert np.max(np.abs(f32(jcommon.rmsnorm(x, scale, 1e-5))
                         - got.numpy())) < TOL

    xh = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    for pos in (np.arange(12, dtype=np.int32),
                rng.integers(0, 100, (2, 12)).astype(np.int32)):
        for theta in (10_000.0, 1_000_000.0):
            want = jcommon.rope(xh, pos, theta)
            got = common.rope(tt(xh), tt(pos), theta)
            assert np.max(np.abs(f32(want) - got.numpy())) < TOL

    want = jax.jit(lambda p: jcommon.swiglu(cfg_j, p, x))(lj["mlp"])
    got = common.swiglu(cfg_t, lt["mlp"], tt(x))
    assert np.max(np.abs(f32(want) - got.numpy())) < TOL


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-0.5b"])
def test_attn_block_without_a_cache_matches_jax(arch):
    cfg_j, cfg_t, lj, lt = _layer_params(arch)
    rng = np.random.default_rng(5)
    for s, window in ((12, 0), (128, 0), (12, 4)):
        x = rng.standard_normal((2, s, cfg_j.d_model)).astype(np.float32)
        pos = np.arange(s, dtype=np.int32)
        want, _ = jax.jit(lambda p, x_, w=window: jcommon.attn_block(
            cfg_j, p, x_, pos, window=w))(lj["attn"], x)
        got, c = common.attn_block(cfg_t, lt["attn"], tt(x), tt(pos),
                                   window=window)
        assert c is None
        assert np.max(np.abs(f32(want) - got.numpy())) < TOL, (s, window)


@pytest.mark.parametrize("window,t,idx", [
    (0, 16, 0), (0, 16, 9),                 # plain cache
    (0, 8, 11),                             # past cache_len: slot clamped
    (6, 6, 3), (6, 6, 14),                  # rolling slot, before/after wrap
])
def test_attn_block_with_a_cache_matches_jax(window, t, idx):
    cfg_j, cfg_t, lj, lt = _layer_params()
    rng = np.random.default_rng(6 + idx)
    b, kv, hd = 2, cfg_j.kv_heads, cfg_j.head_dim
    x = rng.standard_normal((b, 1, cfg_j.d_model)).astype(np.float32)
    kc = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    vc = rng.standard_normal((b, t, kv, hd)).astype(np.float32)
    pos = np.full((b, 1), idx, np.int32)
    want, (wk, wv, widx) = jax.jit(lambda p, c: jcommon.attn_block(
        cfg_j, p, x, pos, c, window=window))(
            lj["attn"], (kc, vc, jnp.int32(idx)))
    got, (gk, gv, gidx) = common.attn_block(
        cfg_t, lt["attn"], tt(x), tt(pos),
        (tt(kc), tt(vc), torch.tensor(idx, dtype=torch.int32)),
        window=window)
    assert np.max(np.abs(f32(want) - got.numpy())) < TOL
    assert np.max(np.abs(f32(wk) - gk.numpy())) < TOL
    assert np.max(np.abs(f32(wv) - gv.numpy())) < TOL
    assert int(widx) == int(gidx) == idx + 1 and gidx.dtype == torch.int32


def _qkv(rng, b, s, h, kv, d):
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    k = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, kv, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    return q, k, v, pos


def test_blocked_attention_matches_jax_full():
    """Mirrors test_blocked_xla_attention_matches_full, against the JAX
    blocked path at the same chunking."""
    rng = np.random.default_rng(1)
    q, k, v, pos = _qkv(rng, 2, 256, 8, 2, 32)
    for causal, window in [(True, 0), (True, 64), (False, 0)]:
        want = jcommon._blocked_attention(q, k, v, pos, pos, causal, window,
                                          qc=64, kc=32)
        got = common._blocked_attention(tt(q), tt(k), tt(v), tt(pos),
                                        tt(pos), causal, window, qc=64,
                                        kc=32)
        assert np.max(np.abs(f32(want) - got.numpy())) < TOL


def test_blocked_attention_matches_jax_banded():
    """Mirrors test_banded_window_attention_matches."""
    rng = np.random.default_rng(2)
    for (s, window, qc, kc) in [(512, 96, 64, 32), (1024, 200, 128, 64)]:
        q, k, v, pos = _qkv(rng, 2, s, 4, 2, 16)
        want = jcommon._blocked_attention(q, k, v, pos, pos, True, window,
                                          qc=qc, kc=kc, banded=True)
        got = common._blocked_attention(tt(q), tt(k), tt(v), tt(pos),
                                        tt(pos), True, window, qc=qc, kc=kc,
                                        banded=True)
        assert np.max(np.abs(f32(want) - got.numpy())) < TOL
        full = common._blocked_attention(tt(q), tt(k), tt(v), tt(pos),
                                         tt(pos), True, window, qc=qc,
                                         kc=kc, banded=False)
        assert np.max(np.abs(full.numpy() - got.numpy())) < TOL


def test_attention_routes_as_the_jax_package(monkeypatch):
    """The kernel route under the Pallas kernel's shape conditions, the
    blocked path above BLOCK_THRESHOLD, the einsum path otherwise; every
    route equals JAX's non-Pallas attention."""
    cfg_j = dataclasses.replace(jregistry.reduced("tinyllama-1.1b"),
                                compute_dtype="float32")
    cfg_t = dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                                compute_dtype="float32")
    rng = np.random.default_rng(7)
    calls = []
    real = ops.attention

    def spy(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(common.kops, "attention", spy)
    for s, window, kernel in ((128, 0, True), (256, 0, True),
                              (96, 0, False), (128, 16, False)):
        q, k, v, pos = _qkv(rng, 1, s, 4, 2, 16)
        calls.clear()
        want = jax.jit(lambda q_, w=window: jcommon.attention(
            cfg_j, q_, k, v, pos, pos, window=w))(q)
        got = common.attention(cfg_t, tt(q), tt(k), tt(v), tt(pos), tt(pos),
                               window=window)
        assert bool(calls) == kernel, (s, window)
        assert np.max(np.abs(f32(want) - got.numpy())) < TOL
        if kernel:
            calls.clear()
            with common.einsum_route():
                again = common.attention(cfg_t, tt(q), tt(k), tt(v),
                                         tt(pos), tt(pos))
            assert not calls
            assert np.max(np.abs(again.numpy() - got.numpy())) < TOL
