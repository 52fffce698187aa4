"""Port parity: LM training (loss, gradients, AdamW, the train step, the
cost model) against the JAX package, on the CPU, at reduced tinyllama-1.1b
width with float32 compute.

The same parameters (the port's seeded init, carried to JAX as numpy),
optimizer state and numpy-seeded batch go through both.  Tolerances:

* loss: 1e-5 relative (the same float32 arithmetic summed in another
  order, through two layers; measured ~1e-7);
* gradients: 1e-4 of each leaf's largest |gradient| (measured ~1e-6);
* loss and grad norm of each of three train steps: 1e-4 relative;
* ``apply_updates`` alone, on the same numpy gradients: 1e-6 absolute
  (elementwise float32 with the same operations in the same order; the
  JAX package's fused kernel may round a product differently);
* parameters after three steps: every element within 6 x lr (two lr a
  step) and all but 0.1% of them within 1e-6.  AdamW's first updates are
  about lr x sign(g), so an element whose gradient is at rounding level
  can take the other sign in the other package and land up to two lr
  away; all others agree to float32 rounding.

JAX compiles three programs here, each shared by the tests that need it:
the loss and its gradient, the train step, and ``apply_updates``.
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
from repro.models import costs as jcosts
from repro.train import optim as joptim
from repro.train import step as jstep

from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import flash_attention
from repro_torch.models import api, common, costs, zoo
from repro_torch.train import optim, step

torch.set_num_threads(1)

ARCH = "tinyllama-1.1b"
B, S = 2, 128            # S a multiple of 128: the flash route's shape
LR = 1e-3
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
STEP_TOL = 1e-4
UPDATE_TOL = 1e-6


def configs():
    cj = dataclasses.replace(jregistry.reduced(ARCH), compute_dtype="float32")
    ct = dataclasses.replace(registry.reduced(ARCH), compute_dtype="float32")
    return cj, ct


def opt_configs():
    kw = dict(lr=LR, warmup=2, total_steps=10)
    return joptim.OptConfig(**kw), optim.OptConfig(**kw)


@functools.lru_cache(maxsize=None)
def setup():
    cj, ct = configs()
    pt = api.init_params(ct, 0, "cpu")
    pj = jax.tree.map(jnp.asarray, convert.params_to_numpy(pt))
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, ct.vocab, (B, S)).astype(np.int32),
             "labels": rng.integers(0, ct.vocab, (B, S)).astype(np.int32)}
    batch["labels"][0, :7] = -1          # masked positions
    return cj, ct, pj, pt, batch


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads():
    cj, _, pj, _, batch = setup()
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: japi.loss_fn(cj, p, b)))
    loss, grads = fn(pj, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), jax.tree.map(np.asarray, grads)


def at(tree, path):
    return functools.reduce(lambda t, k: t[k], path, tree)


def test_loss_and_gradients_match_jax():
    _, ct, _, pt, batch = setup()
    want_loss, want_grads = jax_loss_and_grads()
    loss = api.loss_fn(ct, pt, batch, device="cpu")
    assert loss.dtype == torch.float32 and loss.shape == ()
    assert abs(float(loss) - want_loss) <= LOSS_TOL * abs(want_loss)
    got_loss, grads = step.value_and_grad(ct, pt, batch, device="cpu")
    assert float(got_loss) == float(loss)
    n = 0
    for path, g in optim.tree_items(grads):
        want = at(want_grads, path)
        assert g.shape == want.shape and g.dtype == torch.float32, path
        err = np.max(np.abs(g.numpy() - want))
        assert err <= GRAD_TOL * np.max(np.abs(want)), (path, err)
        n += 1
    assert n == 12
    # the parameters are left as they were: no gradient kept on them
    assert all(p.grad is None and not p.requires_grad
               for _, p in optim.tree_items(pt))


def test_loss_masks_negative_labels_and_averages_over_the_rest():
    _, ct, _, pt, batch = setup()
    logits, _ = api.forward_logits(ct, pt, batch, device="cpu")
    lab = torch.as_tensor(batch["labels"]).long()
    nll = torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, ct.vocab), lab.reshape(-1),
        ignore_index=-1, reduction="mean")
    got = api.loss_fn(ct, pt, batch, device="cpu")
    assert abs(float(got) - float(nll)) < 1e-5
    none = {**batch, "labels": np.full_like(batch["labels"], -1)}
    assert float(api.loss_fn(ct, pt, none, device="cpu")) == 0.0


def test_three_train_steps_match_jax():
    cj, ct, pj, pt, batch = setup()
    oj, ot = opt_configs()
    jfn = jax.jit(jstep.make_train_step(cj, oj))
    tfn = step.make_train_step(ct, ot, device="cpu")
    sj, st = joptim.init_opt(oj, pj), optim.init_opt(ot, pt)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    p_t = pt
    for i in range(3):
        pj, sj, mj = jfn(pj, sj, jb)
        p_t, st, mt = tfn(p_t, st, batch)
        for k in ("loss", "grad_norm"):
            want, got = float(mj[k]), float(mt[k])
            assert abs(got - want) <= STEP_TOL * abs(want), (i, k, got, want)
        assert int(mt["step"]) == int(mj["step"]) == i + 1
        assert mt["step"].dtype == torch.int32
    total = off = 0
    for path, p in optim.tree_items(p_t):
        d = np.abs(p.numpy() - np.asarray(at(pj, path)))
        assert d.max() <= 6 * LR, (path, d.max())
        off += int((d > 1e-6).sum())
        total += d.size
    assert off <= 1e-3 * total, (off, total)
    # the inputs of the port's step are untouched
    fresh = api.init_params(ct, 0, "cpu")
    for path, p in optim.tree_items(pt):
        assert torch.equal(p, at(fresh, path)), path


def test_apply_updates_matches_jax_on_the_same_gradients():
    _, ct, pj, pt, _ = setup()
    oj, ot = opt_configs()
    _, want_grads = jax_loss_and_grads()
    # a state some steps in: moments and step as the JAX package's
    rng = np.random.default_rng(4)
    mu = jax.tree.map(lambda g: (rng.standard_normal(g.shape) * 1e-3)
                      .astype(np.float32), want_grads)
    nu = jax.tree.map(lambda g: (rng.random(g.shape) * 1e-6)
                      .astype(np.float32), want_grads)
    sj = joptim.OptState(mu=jax.tree.map(jnp.asarray, mu),
                         nu=jax.tree.map(jnp.asarray, nu),
                         step=jnp.asarray(4, jnp.int32))
    st = convert.opt_state_from_numpy(
        {"mu": mu, "nu": nu, "step": np.asarray(4, np.int32)}, "cpu", ct, ot)
    gt = convert.params_from_numpy(want_grads, "cpu", ct)
    jp, js, jn = jax.jit(lambda p, g, s: joptim.apply_updates(oj, p, g, s))(
        pj, jax.tree.map(jnp.asarray, want_grads), sj)
    tp, ts, tn = optim.apply_updates(ot, pt, gt, st)
    assert abs(float(tn) - float(jn)) <= 1e-6 * float(jn)
    js_np = convert.opt_state_to_numpy(ts)
    assert int(js_np["step"]) == int(js.step) == 5
    for path, p in optim.tree_items(tp):
        for got, want in ((p.numpy(), at(jp, path)),
                          (at(js_np["mu"], path), at(js.mu, path)),
                          (at(js_np["nu"], path), at(js.nu, path))):
            assert np.max(np.abs(got - np.asarray(want))) <= UPDATE_TOL, path


def test_schedule_matches_jax():
    oj, ot = opt_configs()
    for s in range(0, 13):
        want = float(joptim.schedule(oj, jnp.asarray(s, jnp.int32)))
        got = optim.schedule(ot, torch.tensor(s, dtype=torch.int32))
        assert got.dtype == torch.float32
        assert abs(float(got) - want) <= 1e-7 * LR, s


def test_remat_and_cast_params_bf16_give_the_same_loss(monkeypatch):
    _, ct, _, pt, batch = setup()
    calls = []
    real = zoo.checkpoint
    monkeypatch.setattr(zoo, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    base = dataclasses.replace(ct, compute_dtype="bfloat16")
    out = {}
    for remat in (False, True):
        for cast in (False, True):
            cfg = dataclasses.replace(base, remat=remat,
                                      cast_params_bf16=cast)
            del calls[:]
            out[remat, cast] = step.value_and_grad(cfg, pt, batch,
                                                   device="cpu")
            assert len(calls) == (cfg.n_layers if remat else 0)
    loss0, g0 = out[False, False]
    for key, (loss, grads) in out.items():
        # at init the norm scales are ones, which bf16 holds exactly, so
        # every combination computes the same forward
        assert float(loss) == float(loss0), key
        for path, g in optim.tree_items(grads):
            ref = at(g0, path)
            assert g.dtype == torch.float32, (key, path)
            if not key[1]:        # remat alone: the same arithmetic
                assert torch.equal(g, ref), (key, path)
            else:                 # bf16 leaves: sums in bf16
                err = float((g - ref).abs().max())
                assert err <= 1e-2 * float(ref.abs().max()), (key, path)


def test_train_step_never_takes_the_flash_kernel_route(monkeypatch):
    _, ct, _, pt, batch = setup()

    def no_kernel(*a, **k):
        raise AssertionError("the flash-kernel route was taken")

    monkeypatch.setattr(common.kops, "attention", no_kernel)
    # at S = 128 a forward takes the kernel route ...
    with pytest.raises(AssertionError, match="kernel route"):
        api.forward_logits(ct, pt, {"tokens": batch["tokens"]},
                           device="cpu")
    # ... the train step does not
    _, ot = opt_configs()
    _, _, m = step.make_train_step(ct, ot, device="cpu")(
        pt, optim.init_opt(ot, pt), batch)
    assert np.isfinite(float(m["loss"]))


def test_remat_recomputes_in_the_route_of_the_forward(monkeypatch):
    """On CUDA the autograd engine runs the backward, and so the remat
    recompute, on a thread of its own, where the route would be the
    default: the recompute must take the forward's route wherever it
    runs.  Here the backward runs outside the route's context."""
    _, ct, _, pt, batch = setup()
    calls = []
    monkeypatch.setattr(common.kops, "attention",
                        lambda *a, **k: calls.append(1) or
                        (_ for _ in ()).throw(AssertionError("kernel")))
    params = optim.tree_map(lambda p: p.detach().requires_grad_(True), pt)
    with common.einsum_route():
        loss = api.loss_fn(ct, params, batch, device="cpu")
    grads = torch.autograd.grad(loss, [params["embed"]])
    assert not calls and torch.isfinite(grads[0]).all()


def test_flash_kernel_refuses_inputs_that_need_a_gradient():
    q = torch.zeros(1, 2, 128, 64, requires_grad=True)
    k = torch.zeros(1, 2, 128, 64)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention.flash_attention_cuda(q, k, k)
    # without grad mode the gradient check lets it through to the device
    # check
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        flash_attention.flash_attention_cuda(q, k, k)


@pytest.mark.parametrize("arch", registry.ARCH_IDS)
def test_cost_model_equals_jax(arch):
    cj, ct = jregistry.get(arch), registry.get(arch)
    assert repr(cj) == repr(ct)
    for kind in ("train", "prefill", "decode"):
        for b, s in ((1, 128), (8, 256), (4, 2048)):
            assert costs.cell_flops(ct, kind, b, s) == \
                jcosts.cell_flops(cj, kind, b, s), (kind, b, s)
            assert costs.attn_hbm_bytes(ct, kind, b, s) == \
                jcosts.attn_hbm_bytes(cj, kind, b, s), (kind, b, s)
    for b, s, t in ((2, 64, None), (1, 1, 512)):
        assert costs.fwd_flops(ct, b, s, t) == jcosts.fwd_flops(cj, b, s, t)
