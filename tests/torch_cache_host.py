"""The cache-phase kernel (``kernels/csrc/cache_phase.cu``) built for the
host, shared by the CPU tests that run it: ``tests/test_torch_cache_phase.py``
against the torch phases on single states, and
``tests/test_torch_drive_in_place.py`` in the driver's in-place cycle.

The kernel's per-node code, the source up to the kernel itself, is
compiled with the system's C++ compiler over a small header that stands
in for CUDA's, with :data:`HOST_DRIVER` in place of the kernel and its
launch: each node in turn, as the kernel's threads would run it.
:func:`standing_in` puts it in the place of
``cache_phase.phase1_cache_cuda``, so the in-place cycle (``sim._cycle``
with ``in_place``) runs on the CPU.  Imports neither JAX nor ``repro``."""
import contextlib
import ctypes
import shutil
import subprocess
from pathlib import Path

from repro_torch.core.config import SimConfig
from repro_torch.core.state import SimState
from repro_torch.kernels import build, cache_phase

SOURCE = (build.CSRC / "cache_phase.cu").read_text()

#: what the host build includes in place of ``cuda_runtime.h``
HOST_SHIM = r"""
#pragma once
#include <stdint.h>
#include <algorithm>
using std::min;
using std::max;
#define __device__
#define __forceinline__ inline
#define __constant__
"""

#: run in place of the kernel and its launch: every node in turn, its
#: statistic increments added as the kernel's CTAs add them
HOST_DRIVER = r"""
void host_all(const Phase1Args& a) {
  for (int i = 0; i < a.n; ++i) {
    unsigned int cnt[NUM_STATS] = {0};
    const Node d{a, i, cnt};
    phase1a(d, *a.knob_mig, *a.knob_mig_thr, *a.knob_central);
    phase1b(d, *a.knob_central);
    for (int k = 0; k < NUM_STATS; ++k)
      reinterpret_cast<unsigned int*>(a.stats)[k] += cnt[k];
  }
}
}  // namespace
extern "C" void phase1_cache_host(const Phase1Args* a) { host_all(*a); }
"""


def build_host(d: Path) -> ctypes.CDLL:
    """The host build, compiled in the directory ``d``; its entry point
    ``phase1_cache_host`` takes a ``cache_phase._Phase1Args``."""
    (d / "cuda_runtime.h").write_text(HOST_SHIM)
    body = SOURCE[:SOURCE.index("__global__")]
    (d / "host.cpp").write_text(body + HOST_DRIVER)
    cxx = shutil.which("g++") or shutil.which("c++")
    assert cxx, "the host build needs a C++ compiler"
    proc = subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                           "-I", str(d), "-o", str(d / "host.so"),
                           str(d / "host.cpp")],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(d / "host.so"))
    lib.phase1_cache_host.argtypes = [ctypes.POINTER(cache_phase._Phase1Args)]
    lib.phase1_cache_host.restype = None
    return lib


@contextlib.contextmanager
def standing_in(lib: ctypes.CDLL):
    """``cache_phase.phase1_cache_cuda`` replaced inside the block
    (``sim._cycle`` calls it by attribute) by a stand-in over the host
    build ``lib``: it checks ``w`` as the wrapper does, runs the kernel's
    code over its tensors in place, counts the call in
    ``cache_phase.LAUNCHES`` and returns ``w``."""
    def phase1_cache_host(w: SimState, cfg: SimConfig) -> SimState:
        cache_phase.check_phase1_inputs(w, cfg)
        lib.phase1_cache_host(ctypes.byref(cache_phase._pack(w, cfg)))
        cache_phase.LAUNCHES.n += 1
        return w
    saved = cache_phase.phase1_cache_cuda
    cache_phase.phase1_cache_cuda = phase1_cache_host
    try:
        yield
    finally:
        cache_phase.phase1_cache_cuda = saved
