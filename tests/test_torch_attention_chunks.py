"""The port's blocked attention (``common._blocked_attention``, the path
of every training step and long prefill past ``BLOCK_THRESHOLD``)
against the JAX package's, called directly at small chunk sizes.

* Keys that do not divide the key chunk: the port pads them to a
  multiple of the chunk and masks the padding, where the JAX package
  halves its chunk until it divides (a prime key count leaves one-key
  chunks).  At T = 37 with ``kc`` 8 the port visits ceil(37 / 8) = 5 key
  chunks per query chunk; the JAX package 37.  Only the order of the
  float32 sums differs: the same 1e-5 as ``test_torch_lm_layers.py``.
* Each query chunk, and each key chunk inside it, is checkpointed under
  autograd (the JAX package's two ``jax.checkpoint``s): the backward
  recomputes the chunks, and its gradients equal ``jax.grad`` of the
  JAX package's blocked attention (float32, 1e-5 of the largest
  gradient).
* A reduced tinyllama loss and gradient past the threshold, lowered on
  both sides, with each layer's remat around the chunks' own recompute:
  every leaf against ``jax.value_and_grad`` of the JAX package's
  ``loss_fn``, at ``test_torch_train.py``'s tolerances (loss 1e-5
  relative, each gradient 1e-4 of its leaf's largest).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.configs import registry as jregistry
from repro.models import api as japi
from repro.models import common as jcommon

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.models import api, common
from repro_torch.train import optim, step

torch.set_num_threads(1)

TOL = 1e-5
B, H, KV, D = 2, 4, 2, 16
LOSS_TOL, GRAD_TOL = 1e-5, 1e-4


def inputs(s: int, t: int, seed: int = 0):
    """q (B, S, H, D), k, v (B, T, KV, D) float32 and positions: the
    queries are the last ``s`` of the ``t`` keys."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, s, H, D)).astype(np.float32)
    k = rng.standard_normal((B, t, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, t, KV, D)).astype(np.float32)
    kpos = np.broadcast_to(np.arange(t, dtype=np.int32), (B, t)).copy()
    return q, k, v, kpos[:, t - s:].copy(), kpos


#: (S, T, causal, window, qc, kc, banded); T = 37 is prime
CASES = [
    (32, 37, True, 0, 8, 8, False),        # causal, queries at the end
    (32, 37, False, 0, 8, 8, False),       # cross-attention style
    (32, 37, True, 12, 8, 8, False),       # a window, masked in full
    (37, 37, True, 12, 8, 8, True),        # banded (qc halves to 1)
    (64, 64, True, 0, 16, 16, False),      # no padding: as before
]


def visits(monkeypatch):
    """A list that grows by one at each key chunk the port computes."""
    calls = []
    real = common._key_chunk
    monkeypatch.setattr(common, "_key_chunk",
                        lambda *a: calls.append(1) or real(*a))
    return calls


@pytest.mark.parametrize("s,t,causal,window,qc,kc,banded", CASES)
def test_padded_key_chunks_match_jax(monkeypatch, s, t, causal, window,
                                     qc, kc, banded):
    q, k, v, qpos, kpos = inputs(s, t)
    want = jcommon._blocked_attention(q, k, v, qpos, kpos, causal, window,
                                      qc=qc, kc=kc, banded=banded)
    calls = visits(monkeypatch)
    got = common._blocked_attention(*map(torch.from_numpy,
                                         (q, k, v, qpos, kpos)),
                                    causal, window, qc=qc, kc=kc,
                                    banded=banded)
    assert np.max(np.abs(got.numpy() - np.asarray(want))) < TOL
    # the loop: ceil(T / kc) key chunks a query chunk (the band's count
    # when banded), not T
    qc_ = qc if s % qc == 0 else 1          # 37 halves down to 1
    nk = -(-t // kc)
    per_q = min(nk, (window + qc_ - 2) // kc + 2) if banded else nk
    assert len(calls) == s // qc_ * per_q
    if banded:
        # the band visits fewer chunks and gives what the full loop does
        full = common._blocked_attention(*map(torch.from_numpy,
                                              (q, k, v, qpos, kpos)),
                                         causal, window, qc=qc, kc=kc)
        assert per_q < nk
        assert np.max(np.abs(full.numpy() - got.numpy())) < TOL


@pytest.mark.parametrize("s,t,causal,window,qc,kc,banded",
                         [CASES[0], CASES[3], CASES[4]])
def test_gradients_through_checkpointed_chunks_match_jax(
        monkeypatch, s, t, causal, window, qc, kc, banded):
    q, k, v, qpos, kpos = inputs(s, t, seed=1)
    cot = np.random.default_rng(2).standard_normal(
        (B, s, H, D)).astype(np.float32)

    def jloss(q_, k_, v_):
        o = jcommon._blocked_attention(q_, k_, v_, qpos, kpos, causal,
                                       window, qc=qc, kc=kc, banded=banded)
        return jnp.sum(o * cot)

    want = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True)
                  for x in (q, k, v))
    calls = visits(monkeypatch)
    out = common._blocked_attention(qt, kt, vt, torch.from_numpy(qpos),
                                    torch.from_numpy(kpos), causal, window,
                                    qc=qc, kc=kc, banded=banded)
    forward = len(calls)
    (out * torch.from_numpy(cot)).sum().backward()
    # the backward recomputes each query chunk (its key chunks once) and
    # then each key chunk again for its own gradient: both checkpointed
    assert len(calls) == 3 * forward
    for got, w in zip((qt.grad, kt.grad, vt.grad), want):
        w = np.asarray(w)
        assert np.max(np.abs(got.numpy() - w)) <= TOL * np.max(np.abs(w))


def test_no_checkpoint_without_a_gradient(monkeypatch):
    """A prefill (no autograd) computes each key chunk once."""
    q, k, v, qpos, kpos = inputs(32, 37)
    calls = visits(monkeypatch)
    with torch.no_grad():
        common._blocked_attention(*map(torch.from_numpy,
                                       (q, k, v, qpos, kpos)),
                                  True, 0, qc=8, kc=8)
    assert len(calls) == 4 * 5


def test_remat_step_past_the_threshold_matches_jax(monkeypatch):
    """Reduced tinyllama, float32, remat on, B 2 S 12: BLOCK_THRESHOLD
    lowered below 12 x 12 and the chunks made 4 queries by 8 keys on
    both sides, so every layer takes the blocked path (the port pads its
    12 keys to 16; the JAX package halves its key chunk to 4).  The
    layer's checkpoint recomputes the chunks' own checkpoints, where
    the route or the recompute could go astray."""
    chunks = (4, 8, False)                  # qc, kc, banded
    for mod in (common, jcommon):
        monkeypatch.setattr(mod, "BLOCK_THRESHOLD", 100)
        monkeypatch.setattr(mod._blocked_attention, "__defaults__", chunks)
    arch = "tinyllama-1.1b"
    cj = dataclasses.replace(jregistry.reduced(arch), compute_dtype="float32")
    ct = dataclasses.replace(registry.reduced(arch), compute_dtype="float32")
    assert ct.remat
    pt = api.init_params(ct, 0, "cpu")
    pj = jax.tree.map(jnp.asarray, convert.params_to_numpy(pt))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, ct.vocab, (2, 12)).astype(np.int32),
             "labels": rng.integers(0, ct.vocab, (2, 12)).astype(np.int32)}
    batch["labels"][0, :5] = -1
    jcalls = []
    real = jcommon._blocked_attention
    monkeypatch.setattr(jcommon, "_blocked_attention",
                        lambda *a, **k: jcalls.append(1) or real(*a, **k))
    want_loss, want = jax.jit(jax.value_and_grad(
        lambda p: japi.loss_fn(cj, p, {k: jnp.asarray(v)
                                       for k, v in batch.items()})))(pj)
    assert jcalls               # JAX took its blocked path (a scan: once)
    calls = visits(monkeypatch)
    loss, grads = step.value_and_grad(ct, pt, batch, device="cpu")
    # 3 query chunks x 2 key chunks a layer, in the forward and again in
    # the backward's recomputes
    assert len(calls) > ct.n_layers * 3 * 2
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * abs(
        float(want_loss))
    n = 0
    for path, g in optim.tree_items(grads):
        w = np.asarray(functools.reduce(lambda t, k: t[k], path, want))
        assert g.shape == w.shape, path
        assert np.max(np.abs(g.numpy() - w)) <= GRAD_TOL * np.max(
            np.abs(w)), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want))
