"""Port parity: the LM on a device mesh (DTensor over four gloo ranks on
the CPU) against the one-device port and the JAX package.

One group of four ranks (``repro_torch.dist.spawn``) runs every sharded
case (``torch_sharded_ranks.run``): for the dense, moe (expert-parallel
and ``ftp``) and ssm families on the meshes (2, 2) and (1, 4) over
("data", "model"), the forward's logits, the loss, three
``make_train_step`` steps and ``make_prefill_step``; a dense case whose
12 q heads split over a 4-wide model axis while its 3 KV heads do not
(and the local q heads straddle GQA groups, so q is gathered; the reduced
tinyllama on (1, 4), 4 q heads and 2 KV heads, is the case where each
rank reads the KV head of its q heads); the forward and loss of the
hybrid, vlm and audio families; the block order of an entry over two
mesh axes; a ``Trainer`` resumed from a step-6 checkpoint on (2, 2)
and on (1, 4); and DTensor's collectives staged through host copies.  Reduced widths, float32 compute.

Tolerances, those of ``tests/test_torch_lm_model.py`` and
``tests/test_torch_train.py``:

* logits (forward and prefill): 1e-4 absolute;
* loss: 1e-5 relative;
* loss and grad norm of each of three train steps: 1e-4 relative;
* parameters after three steps: every element within 6 x lr and all
  but 0.1% of them within 1e-6 (AdamW's first updates are about
  lr x sign(g): an element whose gradient is at rounding level may take
  the other sign);
* a Trainer resumed on its own mesh: bit for bit; resumed on another
  mesh, or on one device: the three-step parameter bound.
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
from repro.train import optim as joptim
from repro.train import step as jstep

import torch_sharded_ranks as ranks
from repro_torch import convert
from repro_torch import dist as rdist
from repro_torch.models import api
from repro_torch.train import optim, step

torch.set_num_threads(1)

B, S = 4, 128
LOGIT_TOL = 1e-4
LOSS_TOL = 1e-5
STEP_TOL = 1e-4
CASES = [(shape, fam) for shape in ((2, 2), (1, 4))
         for fam in ("dense", "moe-ep", "moe-ftp", "ssm")] + \
    [((1, 4), "dense-gq")]
FWD_CASES = [((2, 2), "hybrid"), ((1, 4), "vlm"), ((2, 2), "audio")]


def jax_config(family):
    arch, kw = ranks.FAMILIES[family]
    kw = {k: v for k, v in kw.items()}
    return dataclasses.replace(jregistry.reduced(arch),
                               compute_dtype="float32", **kw)


@functools.lru_cache(maxsize=None)
def batches():
    rng = np.random.default_rng(7)
    out = {}
    for fam in ranks.FAMILIES:
        cfg = ranks.config(fam)
        bs = []
        for _ in range(3):
            b = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(
                np.int32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(
                    np.int32)}
            b["labels"][0, :5] = -1
            for fam_, key, n in (("vlm", "img", cfg.n_img_tokens),
                                 ("audio", "frames", cfg.n_audio_frames)):
                if cfg.family == fam_:
                    b[key] = rng.standard_normal(
                        (B, n, cfg.d_model)).astype(np.float32)
            bs.append(b)
        out[fam] = bs
    return out


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded_lm")
    return rdist.spawn(ranks.run, 4, (CASES, FWD_CASES, batches(),
                                      str(root)),
                       device="cpu", init_method=f"file://{root}/store",
                       timeout_s=900)[0]


@functools.lru_cache(maxsize=None)
def one_device(family):
    """The one-device port: (logits, loss, per-step (loss, gnorm), final
    parameters)."""
    cfg = ranks.config(family)
    params = api.init_params(cfg, 0, "cpu")
    b = batches()[family]
    logits, _ = api.forward_logits(cfg, params, {"tokens": b[0]["tokens"]},
                                   device="cpu")
    loss = float(api.loss_fn(cfg, params, b[0], device="cpu"))
    fn = step.make_train_step(cfg, ranks.opt_config(), "cpu")
    p, o, steps = params, optim.init_opt(ranks.opt_config(), params), []
    for bi in b:
        p, o, m = fn(p, o, bi)
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    return (logits.numpy(), loss, steps,
            {"/".join(k): v.numpy() for k, v in optim.tree_items(p)})


@functools.lru_cache(maxsize=None)
def forward_refs(family):
    """(one-device port logits, loss, JAX logits) of the first batch."""
    cfg = ranks.config(family)
    params = api.init_params(cfg, 0, "cpu")
    b = batches()[family][0]
    inputs = {k: v for k, v in b.items() if k != "labels"}
    logits, _ = api.forward_logits(cfg, params, inputs, device="cpu")
    loss = float(api.loss_fn(cfg, params, b, device="cpu"))
    pj = jax.tree.map(jnp.asarray, convert.params_to_numpy(params))
    jl, _ = jax.jit(lambda p, i: japi.forward_logits(jax_config(family), p,
                                                     i))(
        pj, {k: jnp.asarray(v) for k, v in inputs.items()})
    return logits.numpy(), loss, np.asarray(jl)


@functools.lru_cache(maxsize=None)
def jax_run(family):
    """The JAX package from the same parameters: (logits, per-step (loss,
    gnorm), final parameters), its train step jitted."""
    cj = jax_config(family)
    pt = api.init_params(ranks.config(family), 0, "cpu")
    pj = jax.tree.map(jnp.asarray, convert.params_to_numpy(pt))
    b = batches()[family]
    logits, _ = jax.jit(lambda p, t: japi.forward_logits(
        cj, p, {"tokens": t}))(pj, jnp.asarray(b[0]["tokens"]))
    oc = joptim.OptConfig(lr=ranks.LR, warmup=2, total_steps=10)
    fn = jax.jit(jstep.make_train_step(cj, oc))
    p, o, steps = pj, joptim.init_opt(oc, pj), []
    for bi in b:
        p, o, m = fn(p, o, {k: jnp.asarray(v) for k, v in bi.items()})
        steps.append((float(m["loss"]), float(m["grad_norm"])))
    flat = jax.tree_util.tree_flatten_with_path(p)[0]
    return (np.asarray(logits), steps,
            {"/".join(k.key for k in path): np.asarray(v)
             for path, v in flat})


def close_params(got, want):
    assert got.keys() == want.keys()
    n_far = n = 0
    for k in want:
        d = np.abs(got[k] - want[k])
        assert d.max() <= 6 * ranks.LR, (k, float(d.max()))
        n_far += int((d > 1e-6).sum())
        n += d.size
    assert n_far <= 1e-3 * n, (n_far, n)


def rel(a, b):
    return abs(a - b) / abs(b)


@pytest.mark.parametrize("shape,family", CASES)
def test_forward_and_loss(sharded, shape, family):
    got = sharded["lm"][(shape, family)]
    logits, loss, _, _ = one_device(family)
    jlogits = jax_run(family)[0]
    assert got["logits"].shape == logits.shape
    np.testing.assert_allclose(got["logits"], logits, atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["logits"], jlogits, atol=LOGIT_TOL,
                               rtol=0)
    assert rel(got["loss"], loss) < LOSS_TOL
    assert rel(got["loss"], jax_run(family)[1][0][0]) < LOSS_TOL
    # the vocabulary stays split over the model axis
    assert got["placements"] == "(Shard(dim=0), Shard(dim=2))"


@pytest.mark.parametrize("shape,family", CASES)
def test_three_train_steps(sharded, shape, family):
    got = sharded["lm"][(shape, family)]
    _, _, steps, params = one_device(family)
    _, jsteps, jparams = jax_run(family)
    for (l, g), (jl, jg), gl, gg in zip(steps, jsteps, got["losses"],
                                        got["gnorms"]):
        assert rel(gl, l) < STEP_TOL and rel(gg, g) < STEP_TOL
        assert rel(gl, jl) < STEP_TOL and rel(gg, jg) < STEP_TOL
    assert got["step"] == 3
    close_params(got["params"], params)
    close_params(got["params"], jparams)


@pytest.mark.parametrize("shape,family", CASES)
def test_prefill_step(sharded, shape, family):
    got = sharded["lm"][(shape, family)]["prefill"]
    logits = one_device(family)[0]
    np.testing.assert_allclose(got, logits[:, -1], atol=LOGIT_TOL, rtol=0)
    np.testing.assert_allclose(got, jax_run(family)[0][:, -1],
                               atol=LOGIT_TOL, rtol=0)


@pytest.mark.parametrize("shape,family", FWD_CASES)
def test_forward_and_loss_of_the_other_families(sharded, shape, family):
    got = sharded["fwd"][(shape, family)]
    logits, loss, jlogits = forward_refs(family)
    np.testing.assert_allclose(got["logits"], logits, atol=LOGIT_TOL,
                               rtol=0)
    np.testing.assert_allclose(got["logits"], jlogits, atol=LOGIT_TOL,
                               rtol=0)
    assert rel(got["loss"], loss) < LOSS_TOL


def test_two_axis_entries_split_in_jax_order(sharded):
    """``("pod", "data")`` on one dim: each rank's block is JAX's (pod
    major), DTensor's own split of those placements is the same, and the
    blocks gather back to the whole."""
    assert sharded["order"] == (True, True, True)


def test_collectives_staged_through_host_copies(sharded):
    """``dist.stage_through_host``, which a CUDA mesh over gloo ranks
    needs, routes DTensor's all-gather, reduce-scatter and all-reduce
    right (exercised on CPU tensors)."""
    assert sharded["staged"] == (True, True, True)


def test_trainer_resumes_bit_for_bit_on_its_own_mesh(sharded):
    t = sharded["trainer"]
    assert len(t["losses"]) == ranks.TRAINER_STEPS
    assert t["resumed_losses"] == t["losses"][6:]
    for k, v in t["whole"].items():
        assert np.array_equal(t["resumed"][k], v), k


def test_trainer_resumes_on_another_mesh(sharded):
    t = sharded["trainer"]
    close_params(t["remeshed"], t["whole"])


def test_trainer_resumes_on_one_device(sharded, tmp_path):
    """The (2, 2) run's step-6 checkpoint resumed by a one-device
    Trainer."""
    import glob
    import shutil
    src = [d for d in glob.glob(str(tmp_path.parent) + "/**/split/"
                                "step_00000006", recursive=True)]
    assert src, "no step-6 checkpoint"
    shutil.copytree(src[0], tmp_path / "one" / "step_00000006")
    tr = ranks._trainer(None, str(tmp_path / "one"), ranks.TRAINER_STEPS,
                        True)
    close_params({"/".join(k): v.numpy()
                  for k, v in optim.tree_items(tr.params)},
                 sharded["trainer"]["whole"])
