"""Port parity: the dense LM (parameter trees, forward, decode) against
the JAX package, on the CPU, at reduced width.

The same parameters (``repro.models.api.init_params``, carried across with
``convert.params_from_numpy``) and the same numpy-seeded tokens go
through both.  Tolerances, on logits of magnitude ~1:

* float32 compute: 1e-4 (the same float32 arithmetic summed in another
  order, through a few layers);
* bfloat16 compute: 3e-2, about eight bfloat16 rounding steps at the
  logits' scale (bf16 keeps 8 bits; the two frameworks round matmul
  outputs at the same places but may sum in another order, and a flipped
  last bit of an activation propagates).

JAX's own forward is run with ``use_pallas_attention=False`` (its Pallas
flash kernel does not run on this jax); at S = 128 the port takes the
kernel route, whose CPU version is ``attention_ref``.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax

from repro.configs import registry as jregistry
from repro.models import api as japi

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import api, common
from repro_torch.train import step

import torch_lm_parity as par

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 3e-2


@functools.lru_cache(maxsize=None)
def setup(arch: str, compute_dtype: str):
    cfg_j = dataclasses.replace(jregistry.reduced(arch),
                                compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(registry.reduced(arch),
                                compute_dtype=compute_dtype)
    pj = jax.jit(lambda key: japi.init_params(cfg_j, key))(
        jax.random.key(0))
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu",
                                   cfg_t)
    return cfg_j, cfg_t, pj, pt


def f32(x):
    return np.asarray(x, np.float32)


def leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, path + (k,))
        else:
            yield path + (k,), v


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "qwen2-0.5b"])
def test_param_trees_match_and_round_trip(arch):
    cfg_j, cfg_t, pj, pt = setup(arch, "float32")
    want = {p: (tuple(a.shape), str(a.dtype))
            for p, a in leaves(japi.abstract_params(cfg_j))}
    mine = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in leaves(api.init_params(cfg_t, 0, "cpu"))}
    meta = {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in leaves(api.abstract_params(cfg_t))}
    assert mine == want == meta
    # conversion round-trips bit for bit
    back = convert.params_to_numpy(pt)
    for p, a in leaves(jax.tree.map(np.asarray, pj)):
        got = functools.reduce(lambda t, k: t[k], p, back)
        assert got.dtype == a.dtype and np.array_equal(got, a), p
    # extra, missing and mis-shaped leaves are errors
    np_tree = jax.tree.map(np.asarray, pj)
    with pytest.raises(ValueError, match="unexpected"):
        convert.params_from_numpy({**np_tree, "x": np.zeros(1)}, "cpu",
                                  cfg_t)
    with pytest.raises(ValueError, match="missing"):
        convert.params_from_numpy({k: v for k, v in np_tree.items()
                                   if k != "ln_f"}, "cpu", cfg_t)
    with pytest.raises(ValueError, match="expected"):
        convert.params_from_numpy({**np_tree, "ln_f": np.zeros(3)}, "cpu",
                                  cfg_t)


def test_init_params_is_seeded_and_follows_the_conventions():
    cfg = registry.reduced("qwen2-0.5b")
    a = api.init_params(cfg, 5, "cpu")
    b = api.init_params(cfg, 5, "cpu")
    c = api.init_params(cfg, 6, "cpu")
    for (p, x), (_, y), (_, z) in zip(leaves(a), leaves(b), leaves(c)):
        assert torch.equal(x, y), p
        if p[-1] in ("ln", "ln_f"):
            assert torch.equal(x, torch.ones_like(x))
        elif p[-1] in ("bq", "bk", "bv"):
            assert torch.equal(x, torch.zeros_like(x))
        else:
            assert not torch.equal(x, z), p
            assert abs(float(x.std()) - 0.02) < 0.004, p


@pytest.mark.parametrize("arch,dtype,s", [
    ("tinyllama-1.1b", "float32", 128),     # kernel route (CPU: plain)
    ("tinyllama-1.1b", "float32", 12),      # einsum route
    ("qwen2-0.5b", "float32", 128),
    ("tinyllama-1.1b", "bfloat16", 128),
])
def test_forward_logits_match_jax(arch, dtype, s):
    cfg_j, cfg_t, pj, pt = setup(arch, dtype)
    batch = japi.make_inputs(cfg_j, "prefill", 2, s,
                             np.random.default_rng(1))
    want, _ = jax.jit(lambda p, b: japi.forward_logits(cfg_j, p, b))(
        pj, batch)
    tokens = np.asarray(batch["tokens"])
    got, cache = api.forward_logits(cfg_t, pt, {"tokens": tokens},
                                    device="cpu")
    assert cache is None and got.dtype == getattr(torch, dtype)
    assert got.shape == (2, s, cfg_t.vocab)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    assert np.max(np.abs(f32(want) - got.float().numpy())) < tol
    # the prefill step is the last row of the same forward
    last = step.make_prefill_step(cfg_t, device="cpu")(
        pt, {"tokens": tokens})
    assert torch.equal(last, got[:, -1])
    # the einsum route computes the same function
    with common.einsum_route():
        again, _ = api.forward_logits(cfg_t, pt, {"tokens": tokens},
                                      device="cpu")
    assert np.max(np.abs(again.float().numpy()
                         - got.float().numpy())) < tol


def test_make_inputs_draws_as_jax():
    cfg = registry.reduced("tinyllama-1.1b")
    want = japi.make_inputs(cfg, "train", 3, 7, np.random.default_rng(9))
    got = api.make_inputs(cfg, "train", 3, 7, np.random.default_rng(9),
                          device="cpu")
    for k in ("tokens", "labels"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy())


def _decode_both(arch, n_steps, cache_len, b=2):
    cfg_j, cfg_t, pj, pt = setup(arch, "float32")
    tokens = np.random.default_rng(2).integers(
        0, cfg_j.vocab, (b, n_steps)).astype(np.int32)
    jc = japi.init_cache(cfg_j, b, cache_len)
    tc = api.init_cache(cfg_t, b, cache_len, device="cpu")
    jdec = jax.jit(lambda p, c, t: japi.decode_step(cfg_j, p, c, t))
    serve = step.make_serve_step(cfg_t, device="cpu")
    for t in range(n_steps):
        jl, jc = jdec(pj, jc, tokens[:, t:t + 1])
        tl, tc = serve(pt, tc, tokens[:, t:t + 1])
        assert np.max(np.abs(f32(jl) - tl.float().numpy())) < F32_TOL, t
    return cfg_t, pt, tokens, jc, tc


def _same_cache(jc, tc):
    got = convert.cache_to_numpy(tc)
    for name in ("k", "v"):
        assert got[name].dtype == np.asarray(jc[name]).dtype
        assert np.max(np.abs(f32(jc[name]) - f32(got[name]))) < F32_TOL
    assert got["idx"].dtype == np.int32
    assert int(got["idx"]) == int(jc["idx"])


def test_decode_steps_match_jax_and_track_the_forward():
    cfg_t, pt, tokens, jc, tc = _decode_both("tinyllama-1.1b", 12, 64)
    _same_cache(jc, tc)
    assert int(tc["idx"]) == 12
    # caches cross both ways: JAX's arrives with the port's layout, the
    # port's goes out and back bit for bit (bfloat16 leaves too)
    came = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu",
                                    cfg_t)
    for k in came:
        assert came[k].shape == tc[k].shape and came[k].dtype == tc[k].dtype
    bf = dataclasses.replace(cfg_t, compute_dtype="bfloat16")
    cache = api.init_cache(bf, 2, 8, device="cpu")
    cache["k"] = torch.randn(cache["k"].shape).to(torch.bfloat16)
    out = convert.cache_to_numpy(cache)
    assert out["k"].dtype == np.asarray(japi.init_cache(
        jregistry.reduced("tinyllama-1.1b"), 2, 8)["k"]).dtype
    back = convert.cache_from_numpy(out, "cpu", bf)
    for k in back:
        assert torch.equal(back[k], cache[k])
    # greedy decode through the cache tracks the cache-free forward
    full, _ = api.forward_logits(cfg_t, pt, {"tokens": tokens},
                                 device="cpu")
    dec = []
    c = api.init_cache(cfg_t, 2, 64, device="cpu")
    for t in range(tokens.shape[1]):
        lg, c = api.decode_step(cfg_t, pt, c, tokens[:, t:t + 1],
                                device="cpu")
        dec.append(lg)
    assert np.max(np.abs(torch.stack(dec, 1).numpy()
                         - full.numpy())) < F32_TOL


def test_decode_past_cache_len_clamps_the_write_as_jax():
    """12 steps into an 8-row cache: JAX's dynamic_update_slice clamps the
    write to row t - s = 7 (a torch slice at row 8+ would be empty); the
    port must write where JAX writes."""
    _, _, _, jc, tc = _decode_both("qwen2-0.5b", 12, 8)
    _same_cache(jc, tc)
    assert int(tc["idx"]) == 12


FAMILIES = {"dense": "tinyllama-1.1b", "moe": "qwen2-moe-a2.7b",
            "ssm": "mamba2-130m", "hybrid": "hymba-1.5b",
            "vlm": "llama-3.2-vision-11b", "audio": "whisper-small"}


def _shapes(tree):
    """{path: (shape, dtype name)} of a tree of mappings and tuples."""
    return {p: (tuple(t.shape), str(t.dtype).replace("torch.", ""))
            for p, t in par.leaves(tree)}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_every_family_has_jax_trees_and_round_trips(family):
    """Every family the registry names: the port's abstract parameters
    and decode cache have ``repro``'s keys, shapes and dtypes, and
    ``params_from_numpy`` carries ``repro``'s parameters across and back
    bit for bit."""
    arch = FAMILIES[family]
    cfg_j, cfg_t = jregistry.reduced(arch), registry.reduced(arch)
    assert cfg_t.family == family
    assert _shapes(api.abstract_params(cfg_t)) == _shapes(
        japi.abstract_params(cfg_j))
    assert _shapes(api.init_cache(cfg_t, 3, 40, "meta")) == _shapes(
        japi.init_cache(cfg_j, 3, 40)) == _shapes(
        api.init_cache(cfg_t, 3, 40, "cpu"))
    pj = jax.tree.map(np.asarray, japi.init_params(cfg_j,
                                                   jax.random.key(2)))
    pt = convert.params_from_numpy(pj, "cpu", cfg_t)
    back = convert.params_to_numpy(pt)
    for p, a in leaves(pj):
        got = functools.reduce(lambda t, k: t[k], p, back)
        assert got.dtype == a.dtype and np.array_equal(got, a), p


@pytest.mark.parametrize("family", list(FAMILIES))
def test_caches_round_trip_for_every_family(family):
    """A bfloat16 cache after one decode step (an SSM state is float32
    then, as in ``repro``) leaves the port and comes back bit for bit;
    batch and cache length are read from the family's own leaves; a leaf
    of the wrong shape is an error."""
    cfg = dataclasses.replace(registry.reduced(FAMILIES[family]),
                              compute_dtype="bfloat16")
    params = api.init_params(cfg, 3, "cpu")
    cache = api.init_cache(cfg, 3, 40, "cpu")
    for k in ("img", "enc"):
        if k in cache:
            cache[k] = torch.randn(cache[k].shape).to(torch.bfloat16)
    _, cache = api.decode_step(cfg, params, cache,
                               np.full((3, 1), 5, np.int32), device="cpu")
    out = convert.cache_to_numpy(cache)
    back = convert.cache_from_numpy(out, "cpu", cfg)
    want, got = _shapes(cache), _shapes(back)
    assert got == want
    if family in ("ssm", "hybrid"):
        assert {d for p, (_, d) in want.items()
                if p[-1] in ("h", 3)} == {"float32"}
    for (p, a), (q, b) in zip(par.leaves(cache), par.leaves(back)):
        assert p == q and torch.equal(a, b), p
    # the leaf dtypes are repro's: its bf16 leaves arrive as ml_dtypes
    jc = japi.init_cache(dataclasses.replace(
        jregistry.reduced(FAMILIES[family]), compute_dtype="bfloat16"), 3, 40)
    came = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu", cfg)
    assert _shapes(came) == _shapes(api.init_cache(cfg, 3, 40, "meta"))
    bad = dict(out)
    key = "layers" if family == "hybrid" else next(
        k for k in out if k != "idx")
    bad[key] = np.zeros(1, np.float32) if family != "hybrid" else \
        out[key][:-1]
    with pytest.raises(ValueError):
        convert.cache_from_numpy(bad, "cpu", cfg)

