// Phase-2 router arbitration for every router of the mesh at once: the
// paper's dominant GPU kernel (FltsPrtAsgnOrDef), written for Hopper
// (sm_90a).
//
// Replaces: repro/kernels/router_phase.py::_router_kernel (the Pallas TPU
// kernel, entry router_arbitrate_pallas).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::arbitrate_ref, and the two agree bit for bit.
//
// What bounds it: bytes.  Each router reads 5 candidates (age, dc, dr as
// int32; valid and wanted-eject as one byte each) and 4 port bits, and
// writes 5 assigned ports (int32) and 5 deflect bytes: 99 B a router.  At
// 208x208 (43,264 routers) that is about 4.3 MB a cycle, about 1.3 us at
// the H100's 3.35 TB/s, which is below the cost of one launch, so at that
// size the kernel is bound by its launch.  The integer work per router is
// a few hundred operations and never the limit.
//
// Design: one thread per router, the paper's own layout.  A router's
// candidates, their PMDR port scores and the greedy's state stay in
// registers; the five greedy rounds and every loop over slots and ports
// are unrolled, and every "pick the slot/port" is a compare-and-select,
// so nothing is indexed dynamically and nothing spills.  It recomputes
// what the TPU kernel computes and does not copy its (8, 128) sublane
// tiling.  This design does nothing yet about the launch bound: fusing
// the arbitration with the eject, inject and scatter of noc.phase2 is
// later work.
//
// The C entry point takes plain pointers and the stream and returns
// cudaGetLastError(), so the Python wrapper can bind it with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int S = 5;  // candidate slots: 4 input ports + injection
constexpr int P = 4;  // output ports N, E, S, W

// first index attaining the minimum of four values (ties -> lowest port)
__device__ __forceinline__ int argmin4(int e0, int e1, int e2, int e3) {
  int m = min(min(e0, e1), min(e2, e3));
  int p = 3;
  p = (e2 == m) ? 2 : p;
  p = (e1 == m) ? 1 : p;
  p = (e0 == m) ? 0 : p;
  return p;
}

__global__ void __launch_bounds__(256)
router_arbitrate_kernel(const int32_t* __restrict__ age,
                        const uint8_t* __restrict__ valid,
                        const uint8_t* __restrict__ we,
                        const int32_t* __restrict__ dc,
                        const int32_t* __restrict__ dr,
                        const uint8_t* __restrict__ vp,
                        int32_t* __restrict__ assigned,
                        uint8_t* __restrict__ deflect,
                        int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  bool vpp[P];
#pragma unroll
  for (int p = 0; p < P; ++p) vpp[p] = vp[i * P + p] != 0;

  int key[S], sc[S][P], fp[S];
  bool wej[S], done[S], dfl[S];
  int asg[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool v = valid[i * S + s] != 0;
    // priority key: age desc, slot asc (injection = last slot, loses ties)
    key[s] = v ? age[i * S + s] * 8 + (7 - s) : -1;
    const int c = dc[i * S + s];
    const int r = dr[i * S + s];
    // PMDR scores: productive X port 0, productive Y port 1, any other
    // existing port 10 + p, a missing port 1000
    sc[s][0] = vpp[0] ? (r < 0 ? 1 : 10) : 1000;
    sc[s][1] = vpp[1] ? (c > 0 ? 0 : 11) : 1000;
    sc[s][2] = vpp[2] ? (r > 0 ? 1 : 12) : 1000;
    sc[s][3] = vpp[3] ? (c < 0 ? 0 : 13) : 1000;
    fp[s] = argmin4(sc[s][0], sc[s][1], sc[s][2], sc[s][3]);
    wej[s] = we[i * S + s] != 0;
    done[s] = !v;
    asg[s] = -1;
    dfl[s] = false;
  }

  bool taken[P] = {false, false, false, false};
#pragma unroll
  for (int round = 0; round < S; ++round) {
    // highest key among the candidates not yet placed (first on ties)
    int best = 0, bkey = -1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int kk = done[s] ? -1 : key[s];
      if (kk > bkey) { bkey = kk; best = s; }
    }
    if (bkey < 0) continue;  // nothing left to place in this router

    int bs[P] = {0, 0, 0, 0};
    int bfp = 0;
    bool bwej = false;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s == best) {
#pragma unroll
        for (int p = 0; p < P; ++p) bs[p] = sc[s][p];
        bfp = fp[s];
        bwej = wej[s];
      }
    }
    // lowest-score free port; a taken port costs 10000 more
    const int port = argmin4(bs[0] + (taken[0] ? 10000 : 0),
                             bs[1] + (taken[1] ? 10000 : 0),
                             bs[2] + (taken[2] ? 10000 : 0),
                             bs[3] + (taken[3] ? 10000 : 0));
    const bool d = bwej || (port != bfp);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      if (s == best) {
        asg[s] = port;
        dfl[s] = d;
        done[s] = true;
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) taken[p] = taken[p] || (p == port);
  }

#pragma unroll
  for (int s = 0; s < S; ++s) {
    assigned[i * S + s] = asg[s];
    deflect[i * S + s] = dfl[s] ? 1 : 0;
  }
}

}  // namespace

extern "C" int router_arbitrate(const void* age, const void* valid,
                                const void* we, const void* dc,
                                const void* dr, const void* vp,
                                void* assigned, void* deflect, int n,
                                void* stream) {
  if (n > 0) {
    const int threads = 256;
    const int blocks = (n + threads - 1) / threads;
    router_arbitrate_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int32_t*>(age), static_cast<const uint8_t*>(valid),
        static_cast<const uint8_t*>(we), static_cast<const int32_t*>(dc),
        static_cast<const int32_t*>(dr), static_cast<const uint8_t*>(vp),
        static_cast<int32_t*>(assigned), static_cast<uint8_t*>(deflect), n);
  }
  return static_cast<int>(cudaGetLastError());
}
