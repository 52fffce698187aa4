"""Kernel dispatch on the tensors' device.

CUDA tensors go to the hand-written kernel, which launches or raises;
CPU tensors go to the plain PyTorch version.  Nothing falls back from
one to the other.
"""
from __future__ import annotations

from . import ref
from .router_phase import router_arbitrate_cuda


def arbitrate(age, valid, we, dc, dr, vp):
    """Phase-2 router arbitration.  See
    :func:`repro_torch.kernels.ref.arbitrate_ref`."""
    if age.is_cuda:
        return router_arbitrate_cuda(age, valid, we, dc, dr, vp)
    return ref.arbitrate_ref(age, valid, we, dc, dr, vp)
