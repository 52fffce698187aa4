"""The arithmetic of K2's bf16 tensor-core kernel, emulated on the CPU.

``csrc/flash_attention.cu`` computes bf16 attention with ``wgmma`` on
128-row query tiles and 128-row key/value tiles.  That arithmetic differs
from ``attention_ref``'s: the logits are bf16 products summed in float32,
the softmax runs online over the key tiles (diagonal tile first, then
downwards), and P is rounded to bf16 before the P.V product.  This file
repeats those steps in plain torch (:func:`emulate`: the same tile sizes
and order, float32 ``m``, ``l`` and accumulators, p as
``2 ** ((s - m) * log2(e) / sqrt(D))``, -1e30 masking of the diagonal
tile only, one rescale of the accumulator per key tile) and holds the
result against the JAX package's ``attention_ref``:

* at the four ``tests/test_kernels.py`` shapes in bf16, a grouped-query
  case and an S != T non-causal case, within ``test_kernels.py``'s bf16
  tolerance 5e-2;
* through one reduced tinyllama forward in bf16 compute (head_dim 64, one
  emulated call a layer) against ``repro``'s, within the 3e-2 logit
  tolerance of ``test_torch_lm_model.py``.

So rounding P to bf16 keeps the stated tolerances before any card runs
the kernel.  The kernel itself is held against ``attention_ref`` on the
card in ``test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.kernels.ref import attention_ref as jax_attention_ref
from repro.models import api as japi

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels.ref import attention_ref
from repro_torch.models import api, common

torch.set_num_threads(1)

#: the kernel's query and key/value tile rows
TILE = 128
#: masked logits, as the kernel and attention_ref write them
NEG = -1e30


def emulate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool = True, dh: int | None = None) -> torch.Tensor:
    """K2's bf16 kernel, step by step, for q (B, H, S, D) and k, v
    (B, KV, T, D) in bf16, the logits scaled by ``1 / sqrt(dh)`` (default
    D); returns (B, H, S, D) in bf16."""
    b, h, s, d = q.shape
    t = k.shape[2]
    assert q.dtype == torch.bfloat16 and d in fa.HEAD_DIMS
    assert s % TILE == 0 and t % TILE == 0 and (s == t or not causal)
    rep = h // k.shape[1]
    k = k.repeat_interleave(rep, dim=1).float()
    v = v.repeat_interleave(rep, dim=1).float()
    qf = q.float()
    scale_log2 = math.log2(math.e) / math.sqrt(dh or d)
    out = torch.empty_like(q)
    for qt in range(s // TILE):
        rows = slice(qt * TILE, (qt + 1) * TILE)
        m = torch.full((b, h, TILE, 1), NEG)
        l = torch.zeros((b, h, TILE, 1))
        acc = torch.zeros((b, h, TILE, d))
        n_tiles = qt + 1 if causal else t // TILE
        for kt in reversed(range(n_tiles)):         # diagonal tile first
            cols = slice(kt * TILE, (kt + 1) * TILE)
            x = qf[:, :, rows] @ k[:, :, cols].transpose(-1, -2)
            if causal and kt == qt:
                x = torch.where(torch.ones(TILE, TILE, dtype=torch.bool)
                                .tril(), x, NEG)
            m_new = torch.maximum(m, x.amax(-1, keepdim=True))
            p = torch.exp2(x * scale_log2 - m_new * scale_log2)
            alpha = torch.exp2((m - m_new) * scale_log2)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(torch.bfloat16).float() @ v[:, :, cols]
            m = m_new
        out[:, :, rows] = (acc / l.clamp(min=1e-30)).to(torch.bfloat16)
    return out


def bf16_tensor(a: jnp.ndarray) -> torch.Tensor:
    """A JAX bf16 array as a torch bf16 tensor, bit for bit."""
    return torch.from_numpy(np.array(a).view(np.int16)).view(
        torch.bfloat16)


@pytest.mark.parametrize("b,h,kv,s,t,d,causal", [
    (1, 2, 2, 256, 256, 64, True),           # the four test_kernels.py
    (2, 1, 1, 128, 128, 128, True),          # shapes, all in bf16
    (1, 4, 4, 384, 384, 64, False),
    (2, 2, 2, 512, 512, 32, True),
    (2, 8, 2, 256, 256, 64, True),           # GQA: 4 heads per KV head
    (2, 4, 2, 128, 384, 64, False),          # S != T
])
def test_tile_arithmetic_matches_jax_attention_ref(b, h, kv, s, t, d,
                                                   causal):
    rng = np.random.default_rng(0)
    q = jnp.asarray(rng.standard_normal((b, h, s, d)), jnp.bfloat16)
    k = jnp.asarray(rng.standard_normal((b, kv, t, d)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((b, kv, t, d)), jnp.bfloat16)
    rep = h // kv
    want = jax_attention_ref(q, jnp.repeat(k, rep, axis=1),
                             jnp.repeat(v, rep, axis=1), causal=causal)
    got = emulate(bf16_tensor(q), bf16_tensor(k), bf16_tensor(v), causal)
    err = np.max(np.abs(np.asarray(want, np.float32) - got.float().numpy()))
    assert err < 5e-2, err


def test_reduced_tinyllama_forward_through_the_tiles_matches_jax(
        monkeypatch):
    """Reduced tinyllama widened to head_dim 64 (a head dim the kernel
    takes), bf16 compute, S = 128: the port's kernel route with every
    call emulated as the card's kernel computes it, against ``repro``'s
    forward."""
    widths = dict(compute_dtype="bfloat16", d_model=128, n_heads=2,
                  n_kv_heads=1)
    cfg_j = dataclasses.replace(jregistry.reduced("tinyllama-1.1b"),
                                **widths)
    cfg_t = dataclasses.replace(registry.reduced("tinyllama-1.1b"),
                                **widths)
    assert cfg_t.head_dim == 64
    pj = jax.jit(lambda key: japi.init_params(cfg_j, key))(
        jax.random.key(0))
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu",
                                   cfg_t)
    batch = japi.make_inputs(cfg_j, "prefill", 2, TILE,
                             np.random.default_rng(1))
    want, _ = jax.jit(lambda p, b: japi.forward_logits(cfg_j, p, b))(
        pj, batch)
    calls = []

    def kernel(q, k, v, causal=True):
        calls.append(q.shape)
        return emulate(q, k, v, causal)

    monkeypatch.setattr(common.kops, "attention", kernel)
    got, _ = api.forward_logits(cfg_t, pt,
                                {"tokens": np.asarray(batch["tokens"])},
                                device="cpu")
    assert len(calls) == cfg_t.n_layers
    err = np.max(np.abs(np.asarray(want, np.float32) - got.float().numpy()))
    assert err < 3e-2, err


@pytest.mark.parametrize("d", [14, 16, 48, 96])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_dims_without_an_instance_run_padded(d, dtype):
    """A head dim no kernel is built for runs at the next one up: q, k
    and v padded with zero columns (``fa.pad_head_dim``), the logits
    scaled by the true D, the output's zero columns cut
    (``fa.at_kernel_head_dim``, the wrapper's own path).  The kernel is
    stood in for by ``attention_ref`` with the scale passed (float32)
    and by the bf16 kernel's emulation (bfloat16), against the JAX
    package's ``attention_ref`` at the true D (1e-5, 5e-2)."""
    b, h, kv, s = 2, 4, 2, 256
    rng = np.random.default_rng(d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v = (jnp.asarray(rng.standard_normal(sh), jdt) for sh in
               ((b, h, s, d), (b, kv, s, d), (b, kv, s, d)))
    rep = h // kv
    want = jax_attention_ref(q, jnp.repeat(k, rep, axis=1),
                             jnp.repeat(v, rep, axis=1), causal=True)
    if dtype == "float32":
        tq, tk, tv = (torch.from_numpy(np.asarray(x)) for x in (q, k, v))
        kernel = lambda q_, k_, v_, c, dh: attention_ref(  # noqa: E731
            q_, k_, v_, c, scale=1.0 / (dh ** 0.5))
        tol = 1e-5
    else:
        tq, tk, tv = (bf16_tensor(x) for x in (q, k, v))
        kernel = emulate
        tol = 5e-2
    padded = fa.pad_head_dim(tq, tk, tv)
    assert padded[0].shape[-1] == fa.kernel_head_dim(d) > d
    assert all(not p[..., d:].any() for p in padded)
    got = fa.at_kernel_head_dim(kernel, tq, tk, tv, True)
    assert got.shape == tq.shape and got.is_contiguous()
    err = np.max(np.abs(np.asarray(want, np.float32) - got.float().numpy()))
    assert err < tol, err
    # the head dims the kernels are built for run as they are
    assert fa.pad_head_dim(*padded)[0] is padded[0]


def _sent_to_k2(cfg) -> list:
    """The (q, k, v) shapes and ``causal`` of every call that
    ``common.attention`` routes to K2 in a B 1 x S 128 prefill of
    ``cfg`` (fake tensors: no storage at published widths)."""
    from repro_torch.launch.dryrun import fake_tensors
    calls = []

    def record(q, k, v, causal=True):
        calls.append((tuple(q.shape), tuple(k.shape), tuple(v.shape),
                      causal))
        return attention_ref(q, k, v, causal=causal)

    with fake_tensors(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(common.kops, "attention", record)
        params = api.init_params(cfg, 0, "cpu")
        batch = {k: torch.zeros(t.shape, dtype=t.dtype) for k, t in
                 api.input_specs(cfg, "prefill", 1, TILE).items()}
        api.forward_logits(cfg, params, batch, device="cpu")
    return calls


@pytest.mark.parametrize("size", ["reduced", "published"])
def test_every_shape_the_route_sends_passes_the_kernel_checks(size):
    """For every registry config, reduced and published: each call the
    kernel route makes at S = T = 128 passes ``flash_attention_cuda``'s
    shape checks (``fa.check_shapes``; the route sends S and T that are
    multiples of 128, and the checks ask no more of them).  The reduced
    configs' D 16 and 14 are among them; D above 128 still raises."""
    dims = set()
    for arch in registry.ARCH_IDS:
        cfg = registry.reduced(arch) if size == "reduced" \
            else registry.get(arch)
        # every kind of layer, not every layer: one vlm group of layers,
        # two layers of the others (the hybrid's first is global)
        depth = max(cfg.cross_attn_interval, 2)
        cfg = dataclasses.replace(cfg, n_layers=min(cfg.n_layers, depth),
                                  global_layers=tuple(
                                      i for i in cfg.global_layers
                                      if i < depth))
        if cfg.family == "hybrid":
            assert 0 < len(cfg.global_layers) < cfg.n_layers, arch
        calls = _sent_to_k2(cfg)
        # every family but the SSM has a layer on the kernel route
        assert bool(calls) == (cfg.family != "ssm"), arch
        for qs, ks, vs, causal in calls:
            fa.check_shapes(qs, ks, vs, causal)
            dims.add(qs[-1])
    assert dims == ({14, 16} if size == "reduced" else {64, 128})
    with pytest.raises(ValueError, match="above 128"):
        fa.check_shapes((1, 2, 128, 160), (1, 2, 128, 160),
                        (1, 2, 128, 160), True)
