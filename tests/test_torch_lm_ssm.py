"""Port parity: the ssm family (``models/ssm.py`` and the ssm branches of
``models/zoo.py``) against the JAX package, on the CPU.

Units are called eagerly on both sides with the same numpy-seeded
inputs: ``segsum``, ``ssd_chunked`` (against JAX, and against the port's
own ``ssd_decode`` run step by step), ``ssd_decode`` from a bfloat16 and
a float32 state, ``causal_conv`` with and without state.  The reduced
mamba2-130m goes through the harness of ``torch_lm_parity``; its decode
runs in bfloat16 too, where the state ``h`` leaves the first step in
float32 while ``conv`` stays bfloat16, in both packages.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import ssm as jssm

from repro_torch.models import ssm

import torch_lm_parity as par

torch.set_num_threads(1)

ARCH = "mamba2-130m"


def both(a, dtype="float32"):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    a = np.asarray(a, np.float32)
    return jnp.asarray(a, dtype), torch.from_numpy(a).to(getattr(torch,
                                                                 dtype))


def ssd_inputs(b=2, s=256, h=3, p=8, n=16, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)),
            np.abs(rng.standard_normal((b, s, h))) * 0.1 + 0.01,
            rng.standard_normal(h) * 0.5,
            rng.standard_normal((b, s, n)) * 0.3,
            rng.standard_normal((b, s, n)) * 0.3,
            rng.standard_normal((b, h, p, n)) * 0.3)


def test_segsum_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 3, 16))
    xj, xt = both(x)
    want = np.asarray(jssm.segsum(xj))
    got = ssm.segsum(xt).numpy()
    assert np.array_equal(np.isinf(want), np.isinf(got))
    fin = np.isfinite(want)
    assert np.max(np.abs(want[fin] - got[fin])) < 1e-5


@pytest.mark.parametrize("s,dtype,h0", [(256, "float32", False),
                                        (256, "float32", True),
                                        (64, "float32", True),
                                        (256, "bfloat16", True)])
def test_ssd_chunked_matches_jax(s, dtype, h0):
    """Two chunks of 128 (and one of 64), from a zero or a given state;
    y in x's dtype, the final state float32."""
    x, dt, a_log, b, c, h = ssd_inputs(s=s)
    args = [both(v, dtype) for v in (x, dt)] + [both(a_log)] + \
        [both(v, dtype) for v in (b, c)]
    hj, ht = both(h) if h0 else (None, None)
    yj, fj = jssm.ssd_chunked(*(a[0] for a in args), hj)
    yt, ft = ssm.ssd_chunked(*(a[1] for a in args), ht)
    assert yt.dtype == getattr(torch, dtype) and ft.dtype == torch.float32
    tol = 1e-4 if dtype == "float32" else par.BF16_TOL
    assert np.max(np.abs(par.f32(yj) - yt.float().numpy())) < tol
    assert np.max(np.abs(np.asarray(fj) - ft.numpy())) < tol


def test_ssd_chunked_equals_decode_step_by_step():
    """The chunked form and the recurrence compute one function: the port's
    ``ssd_chunked`` against its ``ssd_decode`` run token by token from
    the same initial state."""
    x, dt, a_log, b, c, h = (torch.from_numpy(np.asarray(v, np.float32))
                             for v in ssd_inputs(s=256))
    y, h_fin = ssm.ssd_chunked(x, dt, a_log, b, c, h)
    ys, state = [], h
    for t in range(x.shape[1]):
        yt, state = ssm.ssd_decode(x[:, t:t + 1], dt[:, t:t + 1], a_log,
                                   b[:, t:t + 1], c[:, t:t + 1], state)
        ys.append(yt)
    assert float((torch.cat(ys, 1) - y).abs().max()) < 1e-4
    assert float((state - h_fin).abs().max()) < 1e-4


@pytest.mark.parametrize("hdt", ["bfloat16", "float32"])
def test_ssd_decode_matches_jax(hdt):
    """One step from a bfloat16 state (a fresh cache's) and from a float32
    one (every later step's): the new state is float32 either way."""
    x, dt, a_log, b, c, h = ssd_inputs(s=1, seed=3)
    args = [both(v, "bfloat16") for v in (x, dt)] + [both(a_log)] + \
        [both(v, "bfloat16") for v in (b, c)] + [both(h, hdt)]
    yj, hj = jssm.ssd_decode(*(a[0] for a in args))
    yt, ht = ssm.ssd_decode(*(a[1] for a in args))
    assert str(hj.dtype) == "float32" and ht.dtype == torch.float32
    assert yt.dtype == torch.bfloat16
    assert np.max(np.abs(par.f32(yj) - yt.float().numpy())) < par.BF16_TOL
    assert np.max(np.abs(np.asarray(hj) - ht.numpy())) < 1e-5


@pytest.mark.parametrize("dtype,state", [("bfloat16", False),
                                         ("bfloat16", True),
                                         ("float32", True)])
def test_causal_conv_matches_jax(dtype, state):
    """Depthwise causal conv over float32 weights: the taps of a bfloat16
    input are summed in float32 (the promoted dtype), in order; the new
    state is the last K-1 rows in the input's dtype."""
    rng = np.random.default_rng(5)
    xj, xt = both(rng.standard_normal((2, 9, 12)), dtype)
    wj, wt = both(rng.standard_normal((4, 12)) * 0.1)
    bj, bt = both(rng.standard_normal(12) * 0.1)
    sj, st = both(rng.standard_normal((2, 3, 12)), "bfloat16") if state \
        else (None, None)
    yj, nj = jssm.causal_conv(xj, wj, bj, sj)
    yt, nt = ssm.causal_conv(xt, wt, bt, st)
    assert yt.dtype == nt.dtype == getattr(torch, dtype)
    assert str(nj.dtype) == dtype
    # the same sums; silu may differ in its last float32 bit
    assert np.max(np.abs(par.f32(yj) - yt.float().numpy())) < 1e-6
    assert np.array_equal(par.f32(nj), nt.float().numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(dtype):
    """Reduced mamba2-130m, B 2 x S 256: two SSD chunks a layer."""
    par.check_forward(ARCH, dtype, s=256)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(dtype):
    jc, tc = par.check_decode(ARCH, dtype=dtype)
    assert tc["h"].dtype == torch.float32
    assert tc["conv"].dtype == getattr(torch, dtype)


def test_server_gives_the_jax_servers_greedy_tokens():
    par.check_server(ARCH)
