"""Phase-2 router arbitration on Hopper: wrapper of the CUDA kernel.

The kernel (``csrc/router_arbitrate.cu``) replaces the JAX package's
Pallas kernel ``repro/kernels/router_phase.py::_router_kernel``: one
thread per router, candidates in registers, five unrolled greedy rounds.
Its plain PyTorch version is :func:`repro_torch.kernels.ref.arbitrate_ref`.

The library is built with ``nvcc`` at the first call
(:mod:`repro_torch.kernels.build`), never at import, so this module
imports on a machine without CUDA.  :data:`LAUNCHES` counts the kernel's
launches, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .build import LaunchCount, build


#: launches of the router-arbitration kernel in this process
LAUNCHES = LaunchCount()


def _lib() -> ctypes.CDLL:
    lib = build("router_arbitrate").lib
    fn = lib.router_arbitrate
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: a bare int would be
        # passed as a 32-bit int and cut the pointer
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def router_arbitrate_cuda(age: torch.Tensor, valid: torch.Tensor,
                          we: torch.Tensor, dc: torch.Tensor,
                          dr: torch.Tensor, vp: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel on the current stream.

    Takes ``age``, ``dc``, ``dr`` as (N, 5) int32, ``valid`` and ``we`` as
    (N, 5) bool and ``vp`` as (N, 4) bool, all contiguous on one CUDA
    device; returns ``assigned`` (N, 5) int32 and ``deflect`` (N, 5) bool,
    as :func:`repro_torch.kernels.ref.arbitrate_ref`.  Raises on any other
    input and when the launch fails.
    """
    if age.device.type != "cuda":
        raise ValueError(f"router_arbitrate_cuda needs CUDA tensors, got "
                         f"{age.device}")
    n = age.shape[0]
    dev = age.device
    for name, t, dt, shp in (
            ("age", age, torch.int32, (n, 5)),
            ("valid", valid, torch.bool, (n, 5)),
            ("we", we, torch.bool, (n, 5)),
            ("dc", dc, torch.int32, (n, 5)),
            ("dr", dr, torch.int32, (n, 5)),
            ("vp", vp, torch.bool, (n, 4))):
        _check(name, t, dt, shp, dev)
    if dev.index != torch.cuda.current_device():
        # the C entry point launches on the thread's current device
        raise ValueError(f"inputs are on {dev}, not on the current CUDA "
                         f"device cuda:{torch.cuda.current_device()}")
    assigned = torch.empty((n, 5), dtype=torch.int32, device=dev)
    deflect = torch.empty((n, 5), dtype=torch.bool, device=dev)
    err = _lib().router_arbitrate(
        age.data_ptr(), valid.data_ptr(), we.data_ptr(), dc.data_ptr(),
        dr.data_ptr(), vp.data_ptr(), assigned.data_ptr(),
        deflect.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"router_arbitrate launch failed: CUDA error {err}")
    LAUNCHES.n += 1
    return assigned, deflect
