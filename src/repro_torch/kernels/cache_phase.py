"""The cache phases on Hopper: the wrapper of the CUDA kernel.

``phase1_cache_kernel`` (``csrc/cache_phase.cu``) computes all of
``core/cache.py``'s :func:`~repro_torch.core.cache.phase1a` and then
:func:`~repro_torch.core.cache.phase1b` for every node in one launch, one
thread per node, writing its results in place into the cycle's working
state.  The driver's in-place cycle on the card (``core/sim.py``,
``_cycle`` with ``in_place``, the cycle each scenario's CUDA graph
captures) launches it where every other path calls the two torch phases,
which are its plain version.

The library is built with ``nvcc`` at the first call
(:mod:`repro_torch.kernels.build`), never at import, so this module
imports on a machine without CUDA.  :data:`LAUNCHES` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..core.config import SimConfig
from ..core.state import (CACHE_LEAVES, NUM_P, NUM_Q, NUM_STATS, SimState,
                          dir_shape)
from .build import LaunchCount, build

#: launches of the cache-phase kernel in this process
LAUNCHES = LaunchCount()

#: the int32 leaves the kernel reads and writes in place, in the argument
#: struct's order, then the ones it only reads
_INOUT = ("st", "ctr", "tr_ptr", "pend_addr", "install_mode", "pkt_ctr",
          "lru_clock", "dir_loc", "fwd_tag", "fwd_dst", "fwd_ptr", "q_desc",
          "q_size", "pc", "stats")
_READ = ("q_head", "knob_mig", "knob_mig_thr", "knob_central")
_STORED = CACHE_LEAVES + ("trace",)
_P1_POINTERS = _INOUT + _READ + _STORED
_P1_INTS = ("n", "l1_sets", "l1_ways", "l2_sets", "l2_ways", "l1_shift",
            "l2_shift", "pc_depth", "fwd_entries", "send_queue", "pkt_wrap",
            "dir_home", "dir_cols", "trace_len", "l1_miss_cycles",
            "l2_hit_cycles", "mem_cycles", "req_timeout") + tuple(
                f"es_{k}" for k in _STORED)


class _Phase1Args(ctypes.Structure):
    """``Phase1Args`` of ``csrc/cache_phase.cu``, field for field."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _P1_POINTERS]
                + [(k, ctypes.c_int) for k in _P1_INTS])


def _lib() -> ctypes.CDLL:
    lib = build("cache_phase").lib
    fn = lib.phase1_cache
    if fn.argtypes is None:
        # the struct's pointer and the stream as c_void_p: a bare int
        # would be passed as a 32-bit int and cut the pointer
        fn.argtypes = [ctypes.POINTER(_Phase1Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _shapes(cfg: SimConfig, n: int) -> Dict[str, tuple]:
    ca = cfg.cache
    one = (n,)
    return dict(
        st=one, ctr=one, tr_ptr=one, pend_addr=one, install_mode=one,
        pkt_ctr=one, lru_clock=one, dir_loc=dir_shape(cfg),
        fwd_tag=(n, cfg.fwd_entries), fwd_dst=(n, cfg.fwd_entries),
        fwd_ptr=one, q_desc=(n, cfg.send_queue + 1, NUM_Q), q_size=one,
        pc=(n, cfg.pc_depth, NUM_P), stats=(NUM_STATS,), q_head=one,
        knob_mig=(), knob_mig_thr=(), knob_central=(),
        **{k: (n, ca.l1_sets, ca.l1_ways) for k in CACHE_LEAVES[:3]},
        **{k: (n, ca.l2_sets, ca.l2_ways) for k in CACHE_LEAVES[3:]})


def check_phase1_inputs(w: SimState, cfg: SimConfig) -> None:
    """Raise unless ``w`` is what the kernel takes: a solo state of the
    unsharded mesh of ``cfg`` (``num_nodes`` nodes, the directory of
    ``cfg.dir_layout``), its other leaves widened to int32 and its L1 and
    L2 arrays and ``trace`` in a storage dtype of 1, 2 or 4 bytes, every
    leaf contiguous and on ``st``'s device, at least one forwarding
    entry and one trace word a node."""
    dev = w.st.device
    n = cfg.num_nodes
    if w.st.shape != (n,):
        raise ValueError(f"st has shape {tuple(w.st.shape)}: the kernel "
                         f"steps one scenario of all {n} nodes of the mesh")
    if cfg.fwd_entries < 1 or w.trace.dim() != 2 or w.trace.shape[-1] < 1:
        raise ValueError("the kernel needs at least one forwarding entry "
                         "and one trace word a node")
    want = dict(_shapes(cfg, n), trace=(n, w.trace.shape[-1]))
    narrow = (torch.int8, torch.int16, torch.int32)
    for k in _P1_POINTERS:
        t = getattr(w, k)
        if t.device != dev:
            raise ValueError(f"{k} is on {t.device}, expected {dev}")
        if (t.dtype not in narrow) if k in _STORED else t.dtype != torch.int32:
            raise TypeError(f"{k} has dtype {t.dtype}, which the kernel "
                            "does not take")
        if tuple(t.shape) != want[k]:
            raise ValueError(f"{k} has shape {tuple(t.shape)}, expected "
                             f"{want[k]}")
        if not t.is_contiguous():
            raise ValueError(f"{k} must be contiguous")


def _check_current(dev: torch.device) -> None:
    if dev.index != torch.cuda.current_device():
        # the C entry point launches on the thread's current device
        raise ValueError(f"inputs are on {dev}, not on the current CUDA "
                         f"device cuda:{torch.cuda.current_device()}")


def _pack(w: SimState, cfg: SimConfig) -> _Phase1Args:
    """The kernel's arguments over ``w``'s tensors (unchecked)."""
    ca = cfg.cache
    return _Phase1Args(
        *(getattr(w, k).data_ptr() for k in _P1_POINTERS),
        cfg.num_nodes, ca.l1_sets, ca.l1_ways, ca.l2_sets, ca.l2_ways,
        ca.l1_shift, ca.l2_shift, cfg.pc_depth, cfg.fwd_entries,
        cfg.send_queue, cfg.pkt_wrap, int(cfg.dir_layout != "flat"),
        w.dir_loc.shape[-1], w.trace.shape[-1], cfg.l1_miss_cycles,
        cfg.l2_hit_cycles, cfg.mem_cycles, cfg.req_timeout,
        *(getattr(w, k).element_size() for k in _STORED))


def phase1_cache_cuda(w: SimState, cfg: SimConfig) -> SimState:
    """Phases 1a and 1b of one cycle for every node, in one launch on the
    current stream: ``phase1b(phase1a(w, cfg, ctx), cfg, ctx)`` computed
    in place, ``w`` returned.

    ``w`` is a solo state of the unsharded mesh whose leaves are int32
    but for the L1 and L2 arrays and ``trace``, which keep their storage
    dtypes (``state.widen_state(s, state.CACHE_LEAVES)``); see
    :func:`check_phase1_inputs`.  The kernel writes the phase's results
    into ``w``'s own tensors, the cache arrays narrowed as
    ``state.narrow_state`` narrows them, and adds the phase's statistics
    to ``w.stats``.  The knobs are read on the card, so nothing syncs
    with the host.  Counts the launch in :data:`LAUNCHES`.  Raises on any
    other input and when the launch fails.
    """
    dev = w.st.device
    if dev.type != "cuda":
        raise ValueError(f"phase1_cache_cuda needs CUDA tensors, got {dev}")
    check_phase1_inputs(w, cfg)
    _check_current(dev)
    args = _pack(w, cfg)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().phase1_cache(ctypes.byref(args), stream)
    if err != 0:
        raise RuntimeError(f"phase1_cache launch failed: CUDA error {err}")
    LAUNCHES.n += 1
    return w
