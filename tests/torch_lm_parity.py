"""Shared harness of the per-family LM parity tests
(``tests/test_torch_lm_{moe,ssm,hybrid,vlm_audio}.py``): the JAX
package and the port on the CPU, at reduced width, with the same
parameters (``repro``'s ``init_params`` carried across by
``convert.params_from_numpy``) and the same numpy-seeded inputs.

Tolerances, on logits of magnitude ~1 (those of
``tests/test_torch_lm_model.py``): float32 compute 1e-4, bfloat16
compute 3e-2.  JAX runs with ``use_pallas_attention=False`` (its Pallas
flash kernel does not run on this jax); where the port takes the kernel
route its CPU version is ``attention_ref``.

In bfloat16 the port is held against JAX's forward run op by op
(``jax.disable_jit``), which rounds to bfloat16 where the code says so,
as the port does.  The jitted program's fusions round elsewhere: at
reduced qwen2-moe-a2.7b (B 2 x S 128, seed 0) JAX's jitted and eager
bf16 logits differ by 0.0337, from a few tokens routed to other experts
at near-ties, while the port and the eager forward differ by 0.0020.
Each family compiles two JAX programs here (the float32 forward and the
decode step), about a second each at these widths, plus the JAX
``Server``'s.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models import zoo as jzoo
from repro.serve.server import Request as JRequest, Server as JServer

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import api, common, zoo
from repro_torch.serve.server import Request, Server

F32_TOL = 1e-4
BF16_TOL = 3e-2


def f32(x):
    return np.asarray(x, np.float32)


def tol(dtype: str) -> float:
    return F32_TOL if dtype == "float32" else BF16_TOL


@functools.lru_cache(maxsize=None)
def setup(arch: str, compute_dtype: str):
    """(JAX config, port config, JAX params, port params) at reduced width,
    seed 0."""
    cfg_j = dataclasses.replace(jregistry.reduced(arch),
                                compute_dtype=compute_dtype)
    cfg_t = dataclasses.replace(registry.reduced(arch),
                                compute_dtype=compute_dtype)
    pj = jax.jit(lambda key: japi.init_params(cfg_j, key))(
        jax.random.key(0))
    pt = convert.params_from_numpy(jax.tree.map(np.asarray, pj), "cpu",
                                   cfg_t)
    return cfg_j, cfg_t, pj, pt


def inputs(cfg_j, cfg_t, b: int, s: int, seed: int = 1):
    """The same prefill batch from both packages' ``make_inputs``; they
    must draw the same values."""
    want = japi.make_inputs(cfg_j, "prefill", b, s,
                            np.random.default_rng(seed))
    got = api.make_inputs(cfg_t, "prefill", b, s,
                          np.random.default_rng(seed), device="cpu")
    assert set(got) == set(want)
    for k, t in got.items():
        assert np.array_equal(f32(want[k]), t.float().numpy()), k
        assert str(t.dtype).replace("torch.", "") == str(want[k].dtype), k
    return want, got


def check_forward(arch: str, dtype: str, b: int = 2, s: int = 128):
    """``forward_logits`` of both packages within the dtype's tolerance;
    the port's einsum route computes the same function as its kernel
    route."""
    cfg_j, cfg_t, pj, pt = setup(arch, dtype)
    bj, bt = inputs(cfg_j, cfg_t, b, s)
    if dtype == "float32":
        want, _ = jax.jit(lambda p, x: japi.forward_logits(cfg_j, p, x))(
            pj, bj)
    else:
        with jax.disable_jit():
            want, _ = japi.forward_logits(cfg_j, pj, bj)
    got, cache = api.forward_logits(cfg_t, pt, bt, device="cpu")
    assert cache is None and got.dtype == getattr(torch, dtype)
    assert got.shape == (b, s, cfg_t.vocab)
    err = np.max(np.abs(f32(want) - got.float().numpy()))
    assert err < tol(dtype), err
    with common.einsum_route():
        again, _ = api.forward_logits(cfg_t, pt, bt, device="cpu")
    assert np.max(np.abs(again.float().numpy()
                         - got.float().numpy())) < tol(dtype)
    return cfg_t, pt, bt, got


def leaves(tree, path=()):
    """(path, leaf) pairs of a tree of mappings and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from leaves(v, path + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves(v, path + (i,))
    else:
        yield path, tree


def same_cache(jc, tc, tolerance: float = F32_TOL):
    """Every leaf of the port's cache equal in shape and dtype to JAX's,
    and within ``tolerance`` in value; ``idx`` exactly."""
    want = dict(leaves(jax.tree.map(np.asarray, jc)))
    got = dict(leaves(convert.cache_to_numpy(tc)))
    assert set(got) == set(want)
    for p, a in want.items():
        assert got[p].shape == a.shape and got[p].dtype == a.dtype, \
            (p, got[p].dtype, got[p].shape, a.dtype, a.shape)
        assert np.max(np.abs(f32(a) - f32(got[p])), initial=0.0) \
            < tolerance, p
    assert int(got[("idx",)]) == int(want[("idx",)])


def decode_both(arch: str, n_steps: int, cache_len: int, b: int = 2,
                dtype: str = "float32"):
    """``n_steps`` decode steps of both packages from zeroed caches (the
    vlm ``img`` and audio ``enc`` written in from a seeded batch, as
    ``tests/test_archs.py`` does), logits compared at every step; returns
    (port config, port params, tokens, JAX cache, port cache)."""
    cfg_j, cfg_t, pj, pt = setup(arch, dtype)
    bj, bt = inputs(cfg_j, cfg_t, b, n_steps, seed=2)
    tokens = np.asarray(bj["tokens"])
    jc = japi.init_cache(cfg_j, b, cache_len)
    tc = api.init_cache(cfg_t, b, cache_len, device="cpu")
    if cfg_t.family == "vlm":
        jc["img"], tc["img"] = bj["img"], bt["img"]
    if cfg_t.family == "audio":
        jc["enc"] = jzoo._encode_audio(cfg_j, pj, bj["frames"])
        tc["enc"] = zoo._encode_audio(cfg_t, pt, bt["frames"])
        assert np.max(np.abs(f32(jc["enc"]) - tc["enc"].float().numpy())) \
            < tol(dtype)
    jdec = jax.jit(lambda p, c, t: japi.decode_step(cfg_j, p, c, t))
    for t in range(n_steps):
        if dtype == "float32":
            jl, jc = jdec(pj, jc, tokens[:, t:t + 1])
        else:   # op by op, as check_forward holds bfloat16
            with jax.disable_jit():
                jl, jc = japi.decode_step(cfg_j, pj, jc, tokens[:, t:t + 1])
        tl, tc = api.decode_step(cfg_t, pt, tc, tokens[:, t:t + 1],
                                 device="cpu")
        assert np.max(np.abs(f32(jl) - tl.float().numpy())) < tol(dtype), t
    return cfg_t, pt, bt, jc, tc


def check_decode(arch: str, n_steps: int = 12, cache_len: int = 64,
                 dtype: str = "float32"):
    """``n_steps`` decode steps against JAX: every cache leaf equal in
    shape and dtype (a bfloat16 cache's SSM state leaves a step in
    float32) and within tolerance; the JAX cache crosses into the port
    and back; greedy decode tracks the port's own cache-free forward."""
    cfg_t, pt, bt, jc, tc = decode_both(arch, n_steps, cache_len,
                                        dtype=dtype)
    same_cache(jc, tc, tol(dtype))
    assert int(tc["idx"]) == n_steps
    came = convert.cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu",
                                    cfg_t)
    for (p, a), (q, c) in zip(leaves(came), leaves(tc)):
        assert p == q and a.shape == c.shape and a.dtype == c.dtype, p
    back = convert.cache_from_numpy(convert.cache_to_numpy(tc), "cpu", cfg_t)
    for (p, a), (_, c) in zip(leaves(back), leaves(tc)):
        assert torch.equal(a, c), p
    full, _ = api.forward_logits(cfg_t, pt, bt, device="cpu")
    c = api.init_cache(cfg_t, bt["tokens"].shape[0], cache_len,
                       device="cpu")
    for k in ("img", "enc"):
        if k in tc:
            c[k] = tc[k]
    dec = []
    for t in range(n_steps):
        lg, c = api.decode_step(cfg_t, pt, c, bt["tokens"][:, t:t + 1],
                                device="cpu")
        dec.append(lg)
    assert np.max(np.abs(torch.stack(dec, 1).float().numpy()
                         - full.float().numpy())) < tol(dtype)
    return jc, tc


def _requests(cls, vocab, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return [cls(rid=rid, prompt=rng.integers(0, vocab, int(rng.integers(
        2, 9))).astype(np.int32), max_new=6) for rid in range(n)]


def _drain(server, reqs):
    for r in reqs:
        server.submit(r)
    return {r.rid: list(r.out) for r in server.run_until_drained()}


def check_server(arch: str):
    """The port's ``Server`` gives the JAX ``Server``'s greedy tokens (2
    slots, ``cache_len`` 64, 5 requests of 6 new tokens, float32; the
    vlm ``img`` and audio ``enc`` left at zero in both)."""
    cfg_j, cfg_t, pj, pt = setup(arch, "float32")
    jsrv = JServer(cfg_j, pj, slots=2, cache_len=64)
    want = _drain(jsrv, _requests(JRequest, cfg_j.vocab))
    srv = Server(cfg_t, pt, slots=2, cache_len=64, device="cpu")
    got = _drain(srv, _requests(Request, cfg_t.vocab))
    assert len(got) == 5 and all(len(o) == 6 for o in got.values())
    assert got == want
    assert int(srv.cache["idx"]) == int(jsrv.cache["idx"])
    same_cache(jsrv.cache, srv.cache)
