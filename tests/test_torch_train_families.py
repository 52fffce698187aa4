"""Port parity: LM training of the non-dense families against the JAX
package, on the CPU, at reduced width with float32 compute.

* The hybrid family's tree has a leaf its forward never reads
  (``layers.mamba.ln``: hymba normalises both branches with
  ``attn.ln``).  ``jax.value_and_grad`` gives it a zero gradient;
  ``step.value_and_grad`` gives the same zero, of the leaf's shape,
  dtype and placement, on one device and on a (2, 2) mesh of four gloo
  ranks (``tests/torch_sharded_ranks.py``).
* The hybrid, vlm and audio families' loss and gradients against
  ``jax.value_and_grad(repro.models.api.loss_fn)``, which PR 19's
  sharded tests held only through the forward.
* Every non-dense family through the ``Trainer`` with the launcher's
  data (``img``/``frames`` batches for vlm/audio), resumed from a
  checkpoint bit for bit.
* The loss on logits split over the vocabulary, unevenly (67 on a
  4-wide model axis) and with a quarter of the labels masked: each rank
  reduces its own block (``api._vocab_parallel_nll``), against
  ``jax.value_and_grad``.
* The decode of ``make_serve_step(mesh=)`` on (2, 2), for every
  family, against ``repro``'s ``decode_step`` and the port's
  one-device decode: the weights split as their specs place them, the
  cache as ``cache_pspecs`` places it.

Tolerances, those of ``tests/test_torch_train.py``: loss 1e-5
relative; each gradient within 1e-4 of its leaf's largest |gradient|
(a leaf whose JAX gradient is zero must be exactly zero); decode logits
1e-4 absolute (``tests/test_torch_lm_model.py``).
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

import torch_sharded_ranks as ranks
from repro_torch import convert
from repro_torch import dist as rdist
from repro_torch.launch import train as train_cli
from repro_torch.models import api
from repro_torch.train import optim, step
from repro_torch.train.loop import Trainer

torch.set_num_threads(1)

B, S = 2, 16
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
LOGIT_TOL = 1e-4
FAMILIES = ("hybrid", "vlm", "audio")
#: the mesh cases: gradients of the hybrid family; decode of every
#: family (K/V caches split over the batch; an SSM's conv and state
#: over the model axis too, the hybrid's both)
GRAD_CASES = [((2, 2), "hybrid"), ((1, 4), "ssm-v67"),
              ((1, 4), "dense-v67")]
#: the share of labels set to -1 (masked), by family; else three
DROP = {"dense-v67": 0.25}
SERVE_CASES = [((2, 2), fam) for fam in ("dense", "ssm", "moe-ep", "hybrid",
                                         "vlm", "audio")]
DECODE_STEPS, CACHE_LEN = 3, 16


def batch_for(cfg, seed: int = 0, drop: float = 0.0):
    """A train batch; the first three labels masked, or with ``drop``
    about that share of them."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if drop:
        b["labels"][rng.random((B, S)) < drop] = -1
    else:
        b["labels"][0, :3] = -1
    for fam, key, n in (("vlm", "img", cfg.n_img_tokens),
                        ("audio", "frames", cfg.n_audio_frames)):
        if cfg.family == fam:
            b[key] = rng.standard_normal((B, n, cfg.d_model)).astype(
                np.float32)
    return b


@functools.lru_cache(maxsize=None)
def setup(family: str):
    """(JAX config, port config, JAX params, port params): the port's
    seeded init (what the mesh ranks draw too), carried to JAX."""
    ct = ranks.config(family)
    arch, kw = ranks.FAMILIES[family]
    cj = dataclasses.replace(jregistry.reduced(arch),
                             compute_dtype="float32", **kw)
    pt = api.init_params(ct, 0, "cpu")
    if family == "vlm":
        # the gates start at zero, which would zero every gradient of the
        # gated cross-attention blocks: open them
        pt["xlayers"]["xattn"]["gate"].fill_(0.5)
        pt["xlayers"]["gate_mlp"].fill_(0.5)
    pj = jax.tree.map(jnp.asarray, convert.params_to_numpy(pt))
    return cj, ct, pj, pt


@functools.lru_cache(maxsize=None)
def jax_grads(family: str):
    """(loss, gradient tree as numpy) of ``jax.value_and_grad`` of
    ``repro``'s ``loss_fn``, jitted, from the shared parameters."""
    cj, _, pj, _ = setup(family)
    b = batch_for(cj, drop=DROP.get(family, 0.0))
    fn = jax.jit(jax.value_and_grad(lambda p, x: japi.loss_fn(cj, p, x)))
    loss, g = fn(pj, {k: jnp.asarray(v) for k, v in b.items()})
    return float(loss), jax.tree.map(np.asarray, g)


def at(tree, path):
    return functools.reduce(lambda t, k: t[k], path, tree)


def check_grads(loss, grads, want_loss, want):
    """``grads`` ((path, numpy) pairs) against JAX's tree: every leaf of
    it, none else; returns the paths whose JAX gradient is zero."""
    assert abs(loss - want_loss) <= LOSS_TOL * abs(want_loss)
    zero, n = [], 0
    for path, g in grads:
        w = at(want, path)
        assert g.shape == w.shape and g.dtype == np.float32, path
        scale = np.max(np.abs(w))
        if scale == 0:
            assert not np.any(g), path          # exactly zero, as JAX's
            zero.append(path)
        else:
            assert np.max(np.abs(g - w)) <= GRAD_TOL * scale, path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(want))
    return zero


@pytest.mark.parametrize("family", FAMILIES)
def test_loss_and_gradients_match_jax(family):
    _, ct, _, pt = setup(family)
    want_loss, want = jax_grads(family)
    loss, grads = step.value_and_grad(ct, pt, batch_for(ct), device="cpu")
    zero = check_grads(float(loss), [(p, g.numpy()) for p, g in
                                     optim.tree_items(grads)],
                       want_loss, want)
    # the one leaf no forward reads is hymba's SSM-branch norm
    assert zero == ([("layers", "mamba", "ln")] if family == "hybrid"
                    else [])
    g = grads["layers"]["mamba"]["ln"] if family == "hybrid" else None
    if g is not None:
        p = pt["layers"]["mamba"]["ln"]
        assert g.shape == p.shape and g.dtype == p.dtype \
            and g.device == p.device and not g.requires_grad


def test_zero_gradient_survives_remat_and_bf16_casts():
    """With ``cast_params_bf16`` (the float32 leaves cast once) and
    without remat, the unread leaf's gradient is a float32 zero on the
    float32 leaf, and the rest agree with the default path."""
    _, ct, _, pt = setup("hybrid")
    b = batch_for(ct)
    _, want = step.value_and_grad(ct, pt, b, device="cpu")
    for kw in ({"remat": False}, {"cast_params_bf16": True}):
        c = dataclasses.replace(ct, **kw)
        _, got = step.value_and_grad(c, pt, b, device="cpu")
        g = got["layers"]["mamba"]["ln"]
        assert g.dtype == torch.float32 and not torch.any(g), kw
        if "remat" in kw:
            for (path, a), (_, w) in zip(optim.tree_items(got),
                                         optim.tree_items(want)):
                assert torch.allclose(a, w, rtol=0, atol=1e-6), path


@pytest.fixture(scope="module")
def on_mesh(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_families")
    batches = {fam: [batch_for(ranks.config(fam), drop=DROP.get(fam, 0.0))]
               for fam in {f for _, f in GRAD_CASES}}
    tokens = np.random.default_rng(5).integers(
        0, 256, (4, DECODE_STEPS)).astype(np.int32)
    out = rdist.spawn(ranks.run_grads, 4,
                      (GRAD_CASES, batches, SERVE_CASES, tokens, CACHE_LEN),
                      device="cpu", init_method=f"file://{root}/store",
                      timeout_s=600)[0]
    return out, tokens


def test_hybrid_gradients_on_a_mesh_match_jax(on_mesh):
    got = on_mesh[0]["grads"][((2, 2), "hybrid")]
    want_loss, want = jax_grads("hybrid")
    grads = [(tuple(k.split("/")), v) for k, v in got["grads"].items()]
    zero = check_grads(got["loss"], grads, want_loss, want)
    assert zero == [("layers", "mamba", "ln")]
    # the zero is a DTensor placed as its parameter (the others come as
    # autograd leaves them, partial sums among them, and apply_updates
    # places them)
    g_pl, p_pl = got["placed"]["layers/mamba/ln"]
    assert g_pl == p_pl


def test_vocab_split_unevenly_on_a_mesh_matches_jax(on_mesh):
    """A vocabulary of 67 on a 4-wide model axis: the head's
    partial logits are reduce-scattered onto the vocabulary (split 17,
    17, 17, 16); the loss and every gradient equal JAX's."""
    got = on_mesh[0]["grads"][((1, 4), "ssm-v67")]
    want_loss, want = jax_grads("ssm-v67")
    grads = [(tuple(k.split("/")), v) for k, v in got["grads"].items()]
    assert check_grads(got["loss"], grads, want_loss, want) == []


def test_loss_on_an_uneven_vocabulary_split_matches_jax(on_mesh):
    """A dense model with a vocabulary of 67 on a 4-wide model axis (17,
    17, 17, 16) and about a quarter of the labels masked: the loss
    reduces over each rank's block of the vocabulary and all-reduces
    (B, S) figures; the loss and every gradient equal JAX's."""
    b = batch_for(ranks.config("dense-v67"), drop=DROP["dense-v67"])
    assert 0.15 < np.mean(b["labels"] < 0) < 0.35
    got = on_mesh[0]["grads"][((1, 4), "dense-v67")]
    want_loss, want = jax_grads("dense-v67")
    grads = [(tuple(k.split("/")), v) for k, v in got["grads"].items()]
    assert check_grads(got["loss"], grads, want_loss, want) == []


def jax_decode(family: str, tokens):
    """(logits (B, steps, vocab), the final cache's leaves in the port's
    order) of ``repro``'s ``decode_step``, jitted, from the seeded
    parameters the mesh ranks draw (carried to JAX) and a zeroed
    cache."""
    cj, ct, _, _ = setup(family)
    pj = jax.tree.map(jnp.asarray, convert.params_to_numpy(
        api.init_params(ct, 0, "cpu")))
    cache = japi.init_cache(cj, tokens.shape[0], CACHE_LEN)
    fn = jax.jit(lambda p, c, t: japi.decode_step(cj, p, c, t))
    logits = []
    for t in range(tokens.shape[1]):
        lg, cache = fn(pj, cache, jnp.asarray(tokens[:, t:t + 1]))
        logits.append(np.asarray(lg))
    leaves = []
    optim.tree_map(lambda c: leaves.append(c.numpy()), convert.cache_from_numpy(
        jax.tree.map(np.asarray, cache), "cpu", ct))
    return np.stack(logits, 1), leaves


def close_to(got: dict, logits, leaves) -> None:
    assert np.max(np.abs(got["logits"] - logits)) < LOGIT_TOL
    assert len(leaves) == len(got["cache"])
    for a, (b_, _) in zip(leaves, got["cache"]):
        assert a.shape == b_.shape and np.max(np.abs(a - b_),
                                              initial=0) < LOGIT_TOL


@pytest.mark.parametrize("shape,family", SERVE_CASES)
def test_data_parallel_decode_on_a_mesh(on_mesh, shape, family):
    """The mesh decode against ``repro``'s ``decode_step`` of the same
    parameters and tokens, and against the port's one-device decode."""
    out, tokens = on_mesh
    got = out["serve"][(shape, family)]
    close_to(got, *jax_decode(family, tokens))
    cfg = ranks.config(family)
    params = api.init_params(cfg, 0, "cpu")
    cache = api.init_cache(cfg, tokens.shape[0], CACHE_LEN, "cpu")
    fn = step.make_serve_step(cfg, "cpu")
    want = []
    for t in range(tokens.shape[1]):
        lg, cache = fn(params, cache, tokens[:, t:t + 1])
        want.append(lg.numpy())
    mine = []
    optim.tree_map(lambda c: mine.append(c.numpy()), cache)
    close_to(got, np.stack(want, 1), mine)
    # the cache comes back placed as it went in: the SSM's conv and
    # state split over the model axis as cache_pspecs says
    if family == "ssm":
        assert any("Shard(dim=3)" in p for _, p in got["cache"])
    if family == "hybrid":
        assert any("Shard(dim=2)" in p for _, p in got["cache"])


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-130m",
                                  "hymba-1.5b", "llama-3.2-vision-11b",
                                  "whisper-small"])
def test_trainer_resumes_every_family_bit_for_bit(arch, tmp_path):
    """The launcher's Trainer for a non-dense family (its data source
    adds ``img``/``frames`` for vlm/audio): 4 steps in one run equal 2
    steps, a checkpoint and 2 resumed steps, bit for bit."""
    flags = ["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
             "--seq", "16", "--device", "cpu", "--ckpt-every", "2"]
    whole = train_cli.build_trainer(train_cli.build_parser().parse_args(
        flags + ["--ckpt-dir", str(tmp_path / "whole")]))
    whole.run()
    cut = lambda steps, resume: Trainer(  # noqa: E731
        whole.mcfg, whole.ocfg, whole.dcfg, dataclasses.replace(
            whole.lcfg, steps=steps, ckpt_dir=str(tmp_path / "cut"),
            resume=resume), device="cpu")
    cut(2, False).run()
    resumed = cut(4, True)
    resumed.run()
    assert resumed.metrics_log[0]["step"] == 2
    assert all(np.isfinite(m["loss"]) for m in whole.metrics_log)
    for tree_a, tree_b in ((whole.params, resumed.params),
                           (whole.opt_state._asdict(),
                            resumed.opt_state._asdict())):
        for (path, a), (_, b) in zip(optim.tree_items(tree_a),
                                     optim.tree_items(tree_b)):
            assert torch.equal(a, b), path
