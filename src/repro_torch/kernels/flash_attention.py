"""Flash attention (forward) on Hopper: wrapper of the CUDA kernels.

Both kernels (``csrc/flash_attention.cu``, one C entry point) replace the
JAX package's Pallas kernel
``repro/kernels/flash_attention.py::_attn_kernel``; the wrapper picks one
by dtype:

* bfloat16 goes to ``flash_attention_wgmma_kernel``, on the tensor cores:
  one CTA per 128-row query tile (two consumer warpgroups of 64 rows and
  one producer warp), Q and 128-row K/V tiles copied by TMA through a
  3-stage ring under mbarriers, S = Q.K^T and O += P.V as ``wgmma`` with
  float32 accumulators, P rounded to bf16 in registers, the online
  softmax in float32 between them, overlapped with the previous tile's
  P.V;
* float32 goes to ``flash_attention_3xtf32_kernel``, on the tensor cores
  too: ``wgmma`` reads float32 as TF32 (about three decimal digits), so
  each operand is split into hi = tf32(x) and lo = tf32(x - hi) and each
  product is taken in three passes, lo.hi + hi.lo + hi.hi, which holds
  the 1e-5 tolerance.  ``flash_attention_split_kv_kernel`` first writes K
  hi and lo and V^T hi and lo into scratch that :func:`_launch` allocates
  (four times k's bytes); Q is split in shared memory and P in registers.

What bounds both is operations: 6.875e10 FLOP at the tinyllama-1.1b
prefill shape (4, 32 heads, 4 KV heads, 2048, 64), 0.0695 ms at the
H100's 989 TFLOP/s of bf16 tensor-core work; float32's three passes,
0.4167 ms at 495 TFLOP/s of TF32.  Their plain PyTorch version is
:func:`repro_torch.kernels.ref.attention_ref`.

The library is built with ``nvcc`` at the first call
(:mod:`repro_torch.kernels.build`), never at import, so this module
imports on a machine without CUDA.  :data:`LAUNCHES` counts the kernels'
launches, so a run can show that it went through them.
"""
from __future__ import annotations

import ctypes

import torch

from .build import LaunchCount, build

#: launches of the flash-attention kernels in this process
LAUNCHES = LaunchCount()
#: the part of :data:`LAUNCHES` that went to the float32 kernel
F32_LAUNCHES = LaunchCount()

#: head dims the kernels are built for; another head dim up to the
#: largest runs at the next one up, its q, k and v padded with zero
#: columns (:func:`pad_head_dim`)
HEAD_DIMS = (32, 64, 128)
#: S and T must be multiples of this (the kernels' query and key tile)
BLOCK = 128
#: the bf16 kernel addresses rows of q (B*H*S) and k, v (B*KV*T) as int32
MAX_ROWS = 2 ** 31 - 1

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _lib() -> ctypes.CDLL:
    lib = build("flash_attention").lib
    fn = lib.flash_attention
    if fn.argtypes is None:
        # pointers and the stream as c_void_p: a bare int would be passed
        # as a 32-bit int and cut the pointer
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def kernel_head_dim(d: int) -> int:
    """The head dim of the kernel instance that computes head dim ``d``:
    the smallest of :data:`HEAD_DIMS` at least ``d``.  Raises above the
    largest."""
    for k in HEAD_DIMS:
        if 1 <= d <= k:
            return k
    if d > HEAD_DIMS[-1]:
        raise ValueError(f"head dim {d} is above {HEAD_DIMS[-1]}, the "
                         f"largest the kernels are built for")
    raise ValueError(f"head dim {d} is not positive")


def pad_head_dim(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q, k and v with zero columns appended up to
    :func:`kernel_head_dim` (the same tensors when D is an instance's).
    A zero column of q and k adds nothing to a score, and a zero column
    of v gives a zero column of the output, which the caller cuts; the
    softmax scale must stay that of the true D."""
    d = q.shape[-1]
    extra = kernel_head_dim(d) - d
    if extra == 0:
        return q, k, v
    pad = lambda t: torch.nn.functional.pad(t, (0, extra))  # noqa: E731
    return pad(q), pad(k), pad(v)


def at_kernel_head_dim(fn, q: torch.Tensor, k: torch.Tensor,
                       v: torch.Tensor, causal: bool) -> torch.Tensor:
    """``fn(q, k, v, causal, d)`` on q, k and v padded by
    :func:`pad_head_dim`, ``d`` being their true head dim (the kernels
    scale the logits by ``1 / sqrt(d)``), and its output (B, H, S, D')
    cut back to (B, H, S, d)."""
    d = q.shape[-1]
    o = fn(*pad_head_dim(q, k, v), causal, d)
    return o if o.shape[-1] == d else o[..., :d].contiguous()


def check_shapes(q_shape, k_shape, v_shape, causal: bool) -> None:
    """Raise ``ValueError`` unless the kernels take q of ``q_shape`` (B,
    H, S, D) and k, v of ``k_shape``, ``v_shape`` (B, KV, T, D): the
    same B and D, ``H % KV == 0``, D from 1 to the largest of
    :data:`HEAD_DIMS`, S and T positive multiples of :data:`BLOCK`,
    S == T when ``causal``, and rows that int32 addresses.  Shapes
    only: the CPU reaches it."""
    q_shape, k_shape = tuple(q_shape), tuple(k_shape)
    if len(q_shape) != 4 or len(k_shape) != 4 \
            or tuple(v_shape) != k_shape:
        raise ValueError(f"expected q (B, H, S, D) and k, v (B, KV, T, D); "
                         f"got {q_shape}, {k_shape}, {tuple(v_shape)}")
    b, h, s, d = q_shape
    kb, kvh, t, kd = k_shape
    if kb != b or kd != d or kvh == 0 or h % kvh:
        raise ValueError(f"k/v {k_shape} do not fit q {q_shape} (same B "
                         f"and D, H % KV == 0)")
    kernel_head_dim(d)
    if b * h == 0 or s <= 0 or t <= 0 or s % BLOCK or t % BLOCK:
        raise ValueError(f"S = {s} and T = {t} must be positive multiples "
                         f"of {BLOCK}, and B, H positive")
    if causal and s != t:
        raise ValueError(f"causal attention needs S == T, got S = {s}, "
                         f"T = {t}")
    if max(b * h * s, b * kvh * t) > MAX_ROWS:
        raise ValueError(f"{b * h * s} rows of q or {b * kvh * t} of k, v "
                         f"exceed {MAX_ROWS}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """Launch the kernel for q's dtype on the current stream.

    Takes q (B, H, S, D) and k, v (B, KV, T, D), contiguous, of one dtype
    (float32 or bfloat16), on the current CUDA device, of the shapes
    :func:`check_shapes` takes; ``causal`` needs S == T (the Pallas
    kernel masks from the top left, ``attention_ref`` from the bottom
    right, and they agree only there).  A D that no kernel is built for
    runs at the next one up (:func:`at_kernel_head_dim`).  Returns out
    (B, H, S, D) in q's dtype, as
    :func:`repro_torch.kernels.ref.attention_ref`.  Raises on any other
    input and when the launch fails.  The kernel has no backward, so it
    also raises when grad mode is on and q, k or v requires a gradient,
    rather than return an output that no gradient reaches (the train step
    takes the einsum route, :func:`repro_torch.models.common.einsum_route`).
    """
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention_cuda has no backward: q, k or v requires a "
            "gradient; take the einsum route (models.common.einsum_route) "
            "where a gradient is taken")
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
    check_shapes(q.shape, k.shape, v.shape, causal)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            # TMA needs a 16-byte aligned base; the float32 pre-pass
            # reads k and v in 16-byte granules
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if q.device.index != torch.cuda.current_device():
        # the C entry point launches on the thread's current device
        raise ValueError(f"inputs are on {q.device}, not on the current "
                         f"CUDA device cuda:{torch.cuda.current_device()}")
    return at_kernel_head_dim(_launch, q, k, v, causal)


def _launch(q, k, v, causal: bool, dh: int) -> torch.Tensor:
    """One launch at q's head dim (an instance's), the logits scaled by
    ``1 / sqrt(dh)``.  float32 also takes scratch for the split K and V
    (K hi, K lo, V^T hi, V^T lo: four times k's size)."""
    b, h, s, d = q.shape
    o = torch.empty_like(q)
    scratch = (torch.empty((4, *k.shape), dtype=torch.float32,
                           device=q.device)
               if q.dtype == torch.float32 else None)
    err = _lib().flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        None if scratch is None else scratch.data_ptr(), b, h,
        k.shape[1], s, k.shape[2], d, dh, _DTYPES[q.dtype], int(causal),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    LAUNCHES.n += 1
    if q.dtype == torch.float32:
        F32_LAUNCHES.n += 1
    return o
