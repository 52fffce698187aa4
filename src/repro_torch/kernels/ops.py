"""Kernel dispatch on the tensors' device.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors go to the plain PyTorch version.  Nothing falls back from
one to the other.
"""
from __future__ import annotations

from . import ref
from .flash_attention import flash_attention_cuda
from .router_phase import phase2_router_cuda, router_arbitrate_cuda


def arbitrate(age, valid, we, dc, dr, vp):
    """Phase-2 router arbitration.  See
    :func:`repro_torch.kernels.ref.arbitrate_ref`."""
    if age.is_cuda:
        return router_arbitrate_cuda(age, valid, we, dc, dr, vp)
    return ref.arbitrate_ref(age, valid, we, dc, dr, vp)


def phase2_router(inp, rob, pc, q_desc, q_head, q_size, q_fid, node_id,
                  node_r, node_c, valid_port, knob_ej_age, stats, cols: int):
    """Phase 2 of a cycle for every router, fused.  See
    :func:`repro_torch.kernels.ref.phase2_router_ref`."""
    args = (inp, rob, pc, q_desc, q_head, q_size, q_fid, node_id, node_r,
            node_c, valid_port, knob_ej_age, stats)
    if inp.is_cuda:
        return phase2_router_cuda(*args, cols=cols)
    return ref.phase2_router_ref(*args, cols=cols)


def attention(q, k, v, causal: bool = True):
    """Multi-head (grouped-query) attention, q (B, H, S, D) and k, v
    (B, KV, T, D).  See :func:`repro_torch.kernels.ref.attention_ref`."""
    if q.is_cuda:
        return flash_attention_cuda(q, k, v, causal=causal)
    return ref.attention_ref(q, k, v, causal=causal)
