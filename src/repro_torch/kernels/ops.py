"""Kernel dispatch on the tensors' device.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors go to the plain PyTorch version.  Nothing falls back from
one to the other.
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention_cuda
from .router_phase import router_arbitrate_cuda


def arbitrate(age, valid, we, dc, dr, vp):
    """Phase-2 router arbitration.  See
    :func:`repro_torch.kernels.ref.arbitrate_ref`."""
    if age.is_cuda:
        return router_arbitrate_cuda(age, valid, we, dc, dr, vp)
    return ref.arbitrate_ref(age, valid, we, dc, dr, vp)


def attention(q, k, v, causal: bool = True):
    """Multi-head (grouped-query) attention, q (B, H, S, D) and k, v
    (B, KV, T, D).  See :func:`repro_torch.kernels.ref.attention_ref`."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)
