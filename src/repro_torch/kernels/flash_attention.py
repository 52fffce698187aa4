"""Flash attention (forward) on Hopper: wrapper of the CUDA kernel.

The kernel (``csrc/flash_attention.cu``) replaces the JAX package's
Pallas kernel ``repro/kernels/flash_attention.py::_attn_kernel``: one CTA
per 128-row query tile, K/V streamed through shared memory up to the
causal diagonal, online softmax in float32 on the CUDA cores.  Its plain
PyTorch version is :func:`repro_torch.kernels.ref.attention_ref`.

The library is built with ``nvcc`` at the first call
(:mod:`repro_torch.kernels.build`), never at import, so this module
imports on a machine without CUDA.  :data:`LAUNCHES` counts the kernel's
launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .build import LaunchCount, build

#: launches of the flash-attention kernel in this process
LAUNCHES = LaunchCount()

#: head dims the kernel is built for
HEAD_DIMS = (32, 64, 128)
#: S and T must be multiples of this (the kernel's query tile)
BLOCK = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build("flash_attention").lib
    fn = lib.flash_attention
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a bare int would be passed
        # as a 32-bit int and cut the pointer
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel on the current stream.

    Takes q (B, H, S, D) and k, v (B, KV, T, D), contiguous, of one dtype
    (float32 or bfloat16), on the current CUDA device, with ``H % KV ==
    0``, D in :data:`HEAD_DIMS` and S, T multiples of :data:`BLOCK`;
    ``causal`` needs S == T (the Pallas kernel masks from the top left,
    ``attention_ref`` from the bottom right, and they agree only there).
    Returns out (B, H, S, D) in q's dtype, as
    :func:`repro_torch.kernels.ref.attention_ref`.  Raises on any other
    input and when the launch fails.
    """
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} has dtype {t.dtype}, q {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"dtype {q.dtype} is not float32 or bfloat16")
    if q.dim() != 4 or k.dim() != 4 or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"expected q (B, H, S, D) and k, v (B, KV, T, D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, h, s, d = q.shape
    kb, kvh, t, kd = k.shape
    if kb != b or kd != d or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (same B and D, H % KV == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one of {HEAD_DIMS}")
    if q.numel() == 0 or s % BLOCK or t % BLOCK:
        raise ValueError(f"S = {s} and T = {t} must be positive multiples "
                         f"of {BLOCK}")
    if causal and s != t:
        raise ValueError(f"causal attention needs S == T, got S = {s}, "
                         f"T = {t}")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            # the kernel reads rows in 16-byte (float32) or 8-byte granules
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.device.index != torch.cuda.current_device():
        # the C entry point launches on the thread's current device
        raise ValueError(f"inputs are on {q.device}, not on the current "
                         f"CUDA device cuda:{torch.cuda.current_device()}")
    o = torch.empty_like(q)
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kvh,
        s, t, d, _DTYPES[q.dtype], int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES.n += 1
    return o
