"""Port parity: the moe family (``models/moe.py`` and the moe branches of
``models/zoo.py``) against the JAX package, on the CPU.

Units (``top_k_routing``, ``_dispatch_groups``, ``moe_ffn``) are called
eagerly on both sides with the same numpy-seeded inputs; the reduced
qwen2-moe-a2.7b goes through the harness of ``torch_lm_parity``.  MoE
expert weights here are drawn at 0.3 (as ``tests/test_moe_ssm.py`` draws
them), so a wrongly routed or wrongly dropped copy moves the output by
O(0.1), far past the tolerances.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as jmoe
from repro.models.config import ModelConfig as JConfig

from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

import torch_lm_parity as par

torch.set_num_threads(1)

ARCH = "qwen2-moe-a2.7b"


def cfgs(e=8, k=2, cap=1.25, shared=0):
    kw = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
              d_ff=0, vocab=32, moe_experts=e, moe_top_k=k, moe_d_ff=8,
              moe_shared=shared, capacity_factor=cap)
    return JConfig(**kw), ModelConfig(**kw)


def params(cfg, seed=0, tie=()):
    """Expert weights at 0.3; ``tie`` pairs (a, b) copy router column a
    into column b, so experts a and b get equal logits for every token."""
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.moe_experts, cfg.moe_d_ff
    mk = lambda *s: (rng.standard_normal(s) * 0.3).astype(np.float32)  # noqa
    p = {"router": mk(d, e), "w1": mk(e, d, f), "w3": mk(e, d, f),
         "w2": mk(e, f, d)}
    if cfg.moe_shared:
        fs = cfg.moe_shared * f
        p.update(w1s=mk(d, fs), w3s=mk(d, fs), w2s=mk(fs, d))
    for a, b in tie:
        p["router"][:, b] = p["router"][:, a]
    return ({k: jnp.asarray(v) for k, v in p.items()},
            {k: torch.from_numpy(v) for k, v in p.items()})


def test_top_k_routing_breaks_bf16_ties_as_jax():
    """bf16 logits from a handful of values: most rows hold ties across
    the k-th place; JAX keeps the lower expert, and so must the port."""
    rng = np.random.default_rng(0)
    vals = rng.integers(0, 4, (64, 60)).astype(np.float32) * 0.5
    lj = jnp.asarray(vals, jnp.bfloat16)
    lt = torch.from_numpy(vals).to(torch.bfloat16)
    wj, ij = jmoe.top_k_routing(lj, 4)
    wt, it = moe.top_k_routing(lt, 4)
    # most rows hold a tie at the k-th place
    kth = np.sort(vals, -1)[:, -4]
    assert np.sum(np.sum(vals == kth[:, None], -1) > 1) > 32
    assert np.array_equal(np.asarray(ij), it.numpy())
    assert wt.dtype == torch.float32
    assert np.array_equal(np.asarray(wj), wt.numpy())
    # batched (G, Tg, E), as the dispatch calls it
    wj, ij = jmoe.top_k_routing(lj.reshape(4, 16, 60), 4)
    wt, it = moe.top_k_routing(lt.reshape(4, 16, 60), 4)
    assert np.array_equal(np.asarray(ij), it.numpy())


def test_dispatch_groups_match():
    for t in (1, 2, 3, 7, 24, 32, 96, 128, 8192, 1_048_576):
        assert moe._dispatch_groups(t) == jmoe._dispatch_groups(t)


def _dropped(cfg, ids, g):
    """Copies dropped by capacity, from the routing ids (T, k): per group
    of T // g tokens, an expert's copies past its ``cap`` first ones in
    token order (the stable sort's order)."""
    t, k = ids.shape
    tg = t // g
    cap = max(int(cfg.capacity_factor * tg * k / cfg.moe_experts + 1), 4)
    n = 0
    for gi in range(g):
        _, counts = np.unique(ids[gi * tg:(gi + 1) * tg].ravel(),
                              return_counts=True)
        n += int(np.sum(np.maximum(counts - cap, 0)))
    return n


@pytest.mark.parametrize("dtype,shared", [("float32", 0), ("float32", 2),
                                          ("bfloat16", 0)])
def test_moe_ffn_matches_jax_with_dropped_copies(dtype, shared):
    """B 2 x S 96 = 192 tokens in 32 groups of 6 with k 4 of 8 experts:
    cap 4, so experts take up to 6 copies and some are dropped."""
    cj, ct = cfgs(e=8, k=4, cap=1.25, shared=shared)
    pj, pt = params(cj, seed=1)
    x = np.random.default_rng(2).standard_normal((2, 96, 16)).astype(
        np.float32)
    xj = jnp.asarray(x, dtype)
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jmoe.moe_ffn(cj, pj, xj), np.float32)
    got = moe.moe_ffn(ct, pt, xt)
    assert got.dtype == xt.dtype and got.shape == xt.shape
    logits = np.asarray(jnp.einsum("td,de->te", xj.reshape(-1, 16),
                                   pj["router"].astype(xj.dtype)))
    _, ids = jmoe.top_k_routing(jnp.asarray(logits), 4)
    assert _dropped(cj, np.asarray(ids), moe._dispatch_groups(192)) > 10
    err = np.max(np.abs(want - got.float().numpy()))
    assert err < (1e-5 if dtype == "float32" else par.BF16_TOL), err


def test_moe_ffn_matches_jax_on_forced_ties():
    """Router columns 0 and 1, and 3 and 5, equal: their logits tie for
    every token (in bf16 as in float32), and where a tie straddles the
    k-th place the lower expert must win."""
    cj, ct = cfgs(e=8, k=2, cap=16.0)
    pj, pt = params(cj, seed=3, tie=((0, 1), (3, 5)))
    x = np.random.default_rng(4).standard_normal((2, 32, 16)).astype(
        np.float32)
    for dtype in ("float32", "bfloat16"):
        xj = jnp.asarray(x, dtype)
        xt = torch.from_numpy(x).to(getattr(torch, dtype))
        logits = jnp.einsum("td,de->te", xj.reshape(-1, 16),
                            pj["router"].astype(xj.dtype))
        _, ids = jmoe.top_k_routing(logits, 2)
        ids = np.asarray(ids)
        # where exactly one of a tied pair is taken the tie straddled the
        # k-th place, and JAX took the lower expert
        straddle = [(a in r, b in r) for r in ids.tolist()
                    for a, b in ((0, 1), (3, 5)) if (a in r) != (b in r)]
        assert len(straddle) > 4 and all(lo for lo, _ in straddle)
        want = np.asarray(jmoe.moe_ffn(cj, pj, xj), np.float32)
        got = moe.moe_ffn(ct, pt, xt).float().numpy()
        err = np.max(np.abs(want - got))
        assert err < (1e-5 if dtype == "float32" else par.BF16_TOL), err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(dtype):
    """Reduced qwen2-moe-a2.7b (qkv biases, 2 shared experts), B 2 x S 128:
    the forward drops copies (32 groups of 8 tokens, cap 4) as JAX does."""
    par.check_forward(ARCH, dtype)


def test_decode_steps_match_jax():
    par.check_decode(ARCH)


def test_server_gives_the_jax_servers_greedy_tokens():
    par.check_server(ARCH)

