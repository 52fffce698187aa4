"""Phase-2 router kernels on Hopper: wrappers of the CUDA kernels.

Both kernels (``csrc/router_arbitrate.cu``) replace the JAX package's
Pallas kernel ``repro/kernels/router_phase.py::_router_kernel``, one
thread per router with candidates in registers and five unrolled greedy
rounds:

* :func:`phase2_router_cuda` — the fused Phase-2 router kernel: all of
  ``noc.phase2`` (eject, inject, arbitrate, route, pop, count) in one
  launch.  The simulator runs it once a cycle on the card.  Its plain
  version is :func:`repro_torch.kernels.ref.phase2_router_ref`.
* :func:`router_arbitrate_cuda` — the arbitration alone, as the Pallas
  kernel computes it.  Its plain version is
  :func:`repro_torch.kernels.ref.arbitrate_ref`.

The library is built with ``nvcc`` at the first call
(:mod:`repro_torch.kernels.build`), never at import, so this module
imports on a machine without CUDA.  :data:`LAUNCHES` and
:data:`ARB_LAUNCHES` count each kernel's launches, so a run can show that
it went through the kernel.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from . import ref
from .build import LaunchCount, build


#: launches of the fused Phase-2 router kernel in this process
LAUNCHES = LaunchCount()
#: launches of the standalone arbitration kernel in this process
ARB_LAUNCHES = LaunchCount()

_P2_POINTERS = ("inp", "rob", "pc", "q_desc", "q_head", "q_size", "q_fid",
                "node_id", "node_r", "node_c", "valid_port", "knob_ej_age",
                "stats", "out", "ej_port", "has_ej", "q_head_out",
                "q_size_out", "q_fid_out", "stats_out", "n_deflected",
                "n_injected", "scratch")
_P2_INTS = ("n", "rob_slots", "pc_depth", "send_queue", "cols", "num_stats",
            "stat_injected", "stat_deflections")


class _Phase2Args(ctypes.Structure):
    """``Phase2Args`` of ``csrc/router_arbitrate.cu``, field for field."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _P2_POINTERS]
                + [(k, ctypes.c_int) for k in _P2_INTS])


def _lib() -> ctypes.CDLL:
    lib = build("router_arbitrate").lib
    fn = lib.router_arbitrate
    if fn.argtypes is None:
        # every pointer and the stream as c_void_p: a bare int would be
        # passed as a 32-bit int and cut the pointer
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        p2 = lib.phase2_router
        p2.argtypes = [ctypes.POINTER(_Phase2Args), ctypes.c_void_p]
        p2.restype = ctypes.c_int
    return lib


#: the fused kernel's cross-block sums and block ticket, three zeroed
#: words per (device, stream); the kernel's last block reads and re-zeroes
#: them, so launches on one stream can share them
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


def _scratch(dev: torch.device, stream: int) -> torch.Tensor:
    key = (dev.index, stream)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(3, dtype=torch.int32, device=dev)
    return _SCRATCH[key]


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
    _check_current(dev)
    assigned = torch.empty((n, 5), dtype=torch.int32, device=dev)
    deflect = torch.empty((n, 5), dtype=torch.bool, device=dev)
    err = _lib().router_arbitrate(
        age.data_ptr(), valid.data_ptr(), we.data_ptr(), dc.data_ptr(),
        dr.data_ptr(), vp.data_ptr(), assigned.data_ptr(),
        deflect.data_ptr(), n, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"router_arbitrate launch failed: CUDA error {err}")
    ARB_LAUNCHES.n += 1
    return assigned, deflect


def _check_current(dev: torch.device) -> None:
    if dev.index != torch.cuda.current_device():
        # the C entry points launch on the thread's current device
        raise ValueError(f"inputs are on {dev}, not on the current CUDA "
                         f"device cuda:{torch.cuda.current_device()}")


def check_phase2_inputs(inp, rob, pc, q_desc, q_head, q_size, q_fid, node_id,
                        node_r, node_c, valid_port, knob_ej_age, stats,
                        cols: int) -> None:
    """Raise unless the inputs are what the fused kernel takes: int32
    (``valid_port`` bool) of :func:`repro_torch.kernels.ref.phase2_router_ref`'s
    shapes, contiguous, all on ``inp``'s device, at least one router, ROB
    slot, pending slot and send-queue slot, and ``cols >= 1``."""
    n, k, d = inp.shape[0], rob.shape[1], pc.shape[1]
    qp = q_desc.shape[1] - 1
    if min(n, k, d, qp, cols) < 1:
        raise ValueError(f"routers {n}, rob_slots {k}, pc_depth {d}, "
                         f"send_queue {qp} and cols {cols} must all be >= 1")
    i32 = torch.int32
    for name, t, dt, shp in (
            ("inp", inp, i32, (n, 4, ref.NUM_F)),
            ("rob", rob, i32, (n, k, ref.NUM_R)),
            ("pc", pc, i32, (n, d, ref.NUM_P)),
            ("q_desc", q_desc, i32, (n, qp + 1, ref.NUM_Q)),
            ("q_head", q_head, i32, (n,)),
            ("q_size", q_size, i32, (n,)),
            ("q_fid", q_fid, i32, (n,)),
            ("node_id", node_id, i32, (n,)),
            ("node_r", node_r, i32, (n,)),
            ("node_c", node_c, i32, (n,)),
            ("valid_port", valid_port, torch.bool, (n, 4)),
            ("knob_ej_age", knob_ej_age, i32, ()),
            ("stats", stats, i32, (ref.NUM_STATS,))):
        _check(name, t, dt, shp, inp.device)


def phase2_router_cuda(inp: torch.Tensor, rob: torch.Tensor, pc: torch.Tensor,
                       q_desc: torch.Tensor, q_head: torch.Tensor,
                       q_size: torch.Tensor, q_fid: torch.Tensor,
                       node_id: torch.Tensor, node_r: torch.Tensor,
                       node_c: torch.Tensor, valid_port: torch.Tensor,
                       knob_ej_age: torch.Tensor, stats: torch.Tensor,
                       cols: int) -> ref.Phase2Out:
    """Launch the fused Phase-2 router kernel on the current stream.

    Takes and returns what :func:`repro_torch.kernels.ref.phase2_router_ref`
    does, on one CUDA device (see :func:`check_phase2_inputs`); the outputs
    are new tensors.  ``knob_ej_age`` is read on the card, so nothing
    syncs with the host.  Raises on any other input and when the launch
    fails.
    """
    if inp.device.type != "cuda":
        raise ValueError(f"phase2_router_cuda needs CUDA tensors, got "
                         f"{inp.device}")
    check_phase2_inputs(inp, rob, pc, q_desc, q_head, q_size, q_fid, node_id,
                        node_r, node_c, valid_port, knob_ej_age, stats, cols)
    dev = inp.device
    _check_current(dev)
    n = inp.shape[0]
    stream = torch.cuda.current_stream(dev).cuda_stream
    empty = lambda *shape, dtype=torch.int32: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=dev)
    res = ref.Phase2Out(
        out=empty(n, 4, ref.NUM_F), ej_port=empty(n, dtype=torch.int64),
        has_ej=empty(n, dtype=torch.bool), q_head=empty(n), q_size=empty(n),
        q_fid=empty(n), stats=empty(ref.NUM_STATS), n_deflected=empty(),
        n_injected=empty())
    # the struct's pointers: the inputs in argument order, then the
    # outputs in Phase2Out's order, then the scratch words
    ptrs = [t.data_ptr() for t in (
        inp, rob, pc, q_desc, q_head, q_size, q_fid, node_id, node_r, node_c,
        valid_port, knob_ej_age, stats, *res, _scratch(dev, stream))]
    args = _Phase2Args(*ptrs, n, rob.shape[1], pc.shape[1],
                       q_desc.shape[1] - 1, cols, ref.NUM_STATS,
                       ref.STAT_INJECTED, ref.STAT_DEFLECTIONS)
    err = _lib().phase2_router(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"phase2_router launch failed: CUDA error {err}")
    LAUNCHES.n += 1
    return res
