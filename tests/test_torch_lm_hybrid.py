"""Port parity: the hybrid family (hymba: attention and SSM heads in
parallel, sliding-window layers beside global ones; ``models/zoo.py``'s
hybrid branches) against the JAX package, on the CPU, at reduced width
(4 layers, window 32, global layers 0 and 3), through the harness of
``torch_lm_parity``.

Its cache is a tuple of per-layer (k, v, conv, h) tuples: window layers
keep ``min(window, cache_len)`` rows written at a rolling slot, global
layers ``cache_len`` rows.  40 steps into a 64-row cache wrap the window
layers' 32 rows; in bfloat16 each layer's ``h`` leaves the first step
in float32.
"""
import pytest
import torch

import torch_lm_parity as par

torch.set_num_threads(1)

ARCH = "hymba-1.5b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_jax(dtype):
    """B 2 x S 128: the global layers take the kernel route (on the CPU
    its plain version), the window layers the einsum route."""
    par.check_forward(ARCH, dtype)


@pytest.mark.parametrize("n_steps,dtype", [(12, "float32"),
                                           (40, "float32"),
                                           (12, "bfloat16")])
def test_decode_steps_match_jax(n_steps, dtype):
    cfg = par.setup(ARCH, dtype)[1]
    jc, tc = par.check_decode(ARCH, n_steps=n_steps, dtype=dtype)
    for l, (k, v, conv, h) in enumerate(tc["layers"]):
        rows = 64 if l in cfg.global_layers else cfg.window
        assert k.shape[1] == v.shape[1] == rows
        assert h.dtype == torch.float32
        assert conv.dtype == getattr(torch, dtype)


def test_server_gives_the_jax_servers_greedy_tokens():
    par.check_server(ARCH)
