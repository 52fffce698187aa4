"""Port parity: the vlm (llama-3.2-vision: a gated cross-attention block
and gated FFN before the last self layer of each group of five) and
audio (whisper: a bidirectional encoder over stub frame embeddings, a
decoder with learned positions, no RoPE, cross-attending to the
encoder's output) families against the JAX package, on the CPU, at
reduced width, through the harness of ``torch_lm_parity``.

Their decode caches carry the image embeddings (``img``) and the
encoder's output (``enc``): the decode tests write them in from a seeded
batch, as ``tests/test_archs.py`` does; the servers leave them at zero,
as the JAX package's ``Server`` does.
"""
import numpy as np
import pytest
import torch

import jax

from repro.models import common as jcommon

from repro_torch.models import common

import torch_lm_parity as par

torch.set_num_threads(1)

ARCHS = ["llama-3.2-vision-11b", "whisper-small"]


@pytest.mark.parametrize("gated", [True, False])
def test_cross_attn_block_matches_jax(gated):
    """The block alone, float32, onto 24 embeddings (vision: ``ln_kv``
    and the tanh gate, set non-zero here; audio: ``ln_kv``, no gate)."""
    arch = ARCHS[0] if gated else ARCHS[1]
    cfg_j, cfg_t, pj, pt = par.setup(arch, "float32")
    pre = (lambda t: t["xlayers"]["xattn"]) if gated else \
        (lambda t: t["layers"]["xattn"])
    pxj = jax.tree.map(lambda a: a[0], pre(pj))
    pxt = {k: v[0] for k, v in pre(pt).items()}
    if gated:
        pxj = dict(pxj, gate=pxj["gate"] + 0.7)
        pxt = dict(pxt, gate=pxt["gate"] + 0.7)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 10, cfg_t.d_model)).astype(np.float32)
    kv = rng.standard_normal((2, 24, cfg_t.d_model)).astype(np.float32)
    want = jcommon.cross_attn_block(cfg_j, pxj, x, kv, gated=gated)
    got = common.cross_attn_block(cfg_t, pxt, torch.from_numpy(x),
                                  torch.from_numpy(kv), gated=gated)
    assert np.max(np.abs(par.f32(want) - got.numpy())) < 1e-5


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(arch, dtype):
    """B 2 x S 128: the self layers take the kernel route (on the CPU its
    plain version), the cross-attention the einsum route (16 image
    tokens, 32 frames)."""
    par.check_forward(arch, dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match_jax(arch):
    jc, tc = par.check_decode(arch)
    # the image or the encoded clip was written in and carried through
    assert tc["img" if arch == ARCHS[0] else "enc"].abs().sum() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_server_gives_the_jax_servers_greedy_tokens(arch):
    par.check_server(arch)
