// Phase-2 router kernels for every router of the mesh at once, written for
// Hopper (sm_90a): the paper's dominant GPU kernel (FltsPrtAsgnOrDef) and
// the phase around it.
//
// Replaces: repro/kernels/router_phase.py::_router_kernel (the Pallas TPU
// kernel, entry router_arbitrate_pallas), twice over:
//
// * phase2_router_kernel, the simulator's kernel: all of noc.phase2 in one
//   launch a cycle.  Besides _router_kernel's arbitration it absorbs the
//   eager code that surrounds it in repro/core/noc.py::phase2 (S10's
//   rob_accepts, the pending-queue gate and the ejection pick, the
//   injection flit from the send queue's head, the candidates and their
//   destination rows and columns, the move of each candidate to its output
//   port, the send-queue pop and the two statistics), which took a few
//   hundred small kernels a cycle.  Its plain PyTorch version is
//   repro_torch/kernels/ref.py::phase2_router_ref.
// * router_arbitrate_kernel, the arbitration alone, as the TPU kernel
//   computes it.  Its plain version is ref.py::arbitrate_ref.
// Each agrees with its plain version bit for bit.  Both run the greedy
// through one device function, arbitrate_router.
//
// What bounds them: bytes.  The fused kernel reads a router's input flits
// (160 B), ROB (28 B a slot, 224 B at 8 slots), pending queue (20 B a
// slot), the send queue's head row (24 B) and a few words, about 516 B,
// and writes its output flits (160 B), the ejection pick and the queue
// words, about 181 B: about 700 B a router, 30 MB a cycle at 208x208
// (43,264 routers), about 9 us at the H100's 3.35 TB/s.  The integer work
// is about a thousand operations a router and never the limit.  The
// arbitration alone moves 99 B a router, 1.3 us at 208x208, below the cost
// of one launch, which is why the simulator runs the fused kernel instead.
//
// Design: one thread per router, the paper's own layout.  A router's
// candidates, their PMDR port scores and the greedy's state stay in
// registers; the five greedy rounds and every loop over slots and ports
// are unrolled, and every "pick the slot/port" is a compare-and-select,
// so nothing is indexed dynamically.  The fused kernel gives each CTA a
// tile of 128 routers.  A router's flits, ROB and pending queue are 40,
// 7 K and 5 D consecutive words, so a warp that loaded them straight from
// device memory would touch 32 addresses 160-224 B apart on every load,
// about 32 L1 wavefronts each.  Instead the CTA first copies the tile's
// three contiguous slabs into shared memory with coalesced 16-byte loads
// (scalar loads at an unaligned start or end, as at pending depth 1, 20 B
// a router), each router at an odd word stride so that the 32 routers of
// a warp read 32 different banks; the thread then computes its router
// from shared memory and writes its output flits back into its own flit
// slab, which the CTA stores to device memory as coalesced 16-byte words.
// The two statistics are summed in the CTA, added to two global words
// with atomics, and the last CTA to finish (a ticket counter) writes the
// new statistics vector and zeroes the words and the ticket for the next
// launch: integer sums give the same total in any order, and the phase
// stays one launch.
//
// The C entry points take plain pointers (or a struct of them) and the
// stream and return cudaGetLastError(), so the Python wrapper can bind
// them with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

// The fused kernel's arguments, as the wrapper's ctypes structure lays
// them out (outside the anonymous namespace: the exported entry point
// takes a pointer to it).
struct Phase2Args {
  const int32_t* inp;       // (n, 4, NUM_F)
  const int32_t* rob;       // (n, rob_slots, NUM_R)
  const int32_t* pc;        // (n, pc_depth, NUM_P)
  const int32_t* q_desc;    // (n, send_queue + 1, NUM_Q)
  const int32_t* q_head;    // (n,)
  const int32_t* q_size;
  const int32_t* q_fid;
  const int32_t* node_id;
  const int32_t* node_r;
  const int32_t* node_c;
  const uint8_t* vp;        // (n, 4) bool
  const int32_t* knob_ej_age;  // () on the device: never read on the host
  const int32_t* stats;     // (num_stats,)
  int32_t* out;             // (n, 4, NUM_F)
  int64_t* ej_port;         // (n,)
  uint8_t* has_ej;          // (n,) bool
  int32_t* q_head_out;
  int32_t* q_size_out;
  int32_t* q_fid_out;
  int32_t* stats_out;       // (num_stats,)
  int32_t* n_deflected;     // ()
  int32_t* n_injected;      // ()
  unsigned int* scratch;    // 3 words, zero between launches
  int n, rob_slots, pc_depth, send_queue, cols, num_stats, stat_injected,
      stat_deflections;
};

namespace {

constexpr int S = 5;  // candidate slots: 4 input ports + injection
constexpr int P = 4;  // output ports N, E, S, W

// field indices of the state's records (repro_torch/core/state.py)
constexpr int F_VALID = 0, F_AGE = 1, F_SRC = 2, F_DST = 3, F_OSRC = 4,
              F_TYP = 5, F_TAG = 6, F_PKT = 7, F_FID = 8, F_NFL = 9;
constexpr int NUM_F = 10;
constexpr int Q_TYP = 0, Q_DST = 1, Q_OSRC = 2, Q_TAG = 3, Q_PKT = 4,
              Q_NFL = 5;
constexpr int NUM_Q = 6;
constexpr int R_SRC = 0, R_PKT = 1, R_NFL = 5;
constexpr int NUM_R = 7;
constexpr int P_VALID = 0;
constexpr int NUM_P = 5;

// first index attaining the minimum of four values (ties -> lowest port)
__device__ __forceinline__ int argmin4(int e0, int e1, int e2, int e3) {
  int m = min(min(e0, e1), min(e2, e3));
  int p = 3;
  p = (e2 == m) ? 2 : p;
  p = (e1 == m) ? 1 : p;
  p = (e0 == m) ? 0 : p;
  return p;
}

// Age-priority greedy port assignment of one router's five candidates
// (ref.py::arbitrate_ref): asg[s] is the port of candidate s (-1 when it
// is not valid) and dfl[s] whether it missed its first preference or had
// been refused ejection.
__device__ __forceinline__ void arbitrate_router(
    const int (&age)[S], const bool (&valid)[S], const bool (&we)[S],
    const int (&dc)[S], const int (&dr)[S], const bool (&vpp)[P],
    int (&asg)[S], bool (&dfl)[S]) {
  int key[S], sc[S][P], fp[S];
  bool done[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    // priority key: age desc, slot asc (injection = last slot, loses ties)
    key[s] = valid[s] ? age[s] * 8 + (7 - s) : -1;
    const int c = dc[s];
    const int r = dr[s];
    // PMDR scores: productive X port 0, productive Y port 1, any other
    // existing port 10 + p, a missing port 1000
    sc[s][0] = vpp[0] ? (r < 0 ? 1 : 10) : 1000;
    sc[s][1] = vpp[1] ? (c > 0 ? 0 : 11) : 1000;
    sc[s][2] = vpp[2] ? (r > 0 ? 1 : 12) : 1000;
    sc[s][3] = vpp[3] ? (c < 0 ? 0 : 13) : 1000;
    fp[s] = argmin4(sc[s][0], sc[s][1], sc[s][2], sc[s][3]);
    done[s] = !valid[s];
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
        bwej = we[s];
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
  int a[S], c[S], r[S], asg[S];
  bool v[S], w[S], dfl[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    a[s] = age[i * S + s];
    v[s] = valid[i * S + s] != 0;
    w[s] = we[i * S + s] != 0;
    c[s] = dc[i * S + s];
    r[s] = dr[i * S + s];
  }
  arbitrate_router(a, v, w, c, r, vpp, asg, dfl);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    assigned[i * S + s] = asg[s];
    deflect[i * S + s] = dfl[s] ? 1 : 0;
  }
}

// ---------------------------------------------------------------------------
// The fused Phase-2 router kernel
// ---------------------------------------------------------------------------

constexpr int TILE = 128;               // routers (and threads) a CTA
constexpr int INP_W = P * NUM_F;        // words of a router's input flits

// a router's slab in shared memory: its word count, made odd
__host__ __device__ __forceinline__ int odd(int w) { return w | 1; }

// Copy the nw words at g (a tile's slab, sw words a router) into s, router
// r's word f at s[r * odd(sw) + f]: 16-byte loads from the first 16-byte
// boundary on, scalar ones before it and after the last whole vector.
__device__ __forceinline__ void stage_in(const int32_t* __restrict__ g,
                                         int nw, int sw,
                                         int32_t* __restrict__ s) {
  const int sp = odd(sw);
  const int lead = min(nw, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) >> 2));
  for (int w = threadIdx.x; w < lead; w += TILE)
    s[w / sw * sp + w % sw] = g[w];
  const int nvec = (nw - lead) >> 2;
  const int4* gv = reinterpret_cast<const int4*>(g + lead);
#pragma unroll 4
  for (int j = threadIdx.x; j < nvec; j += TILE) {
    const int4 x = __ldg(gv + j);
    const int w = lead + 4 * j;
    int r = w / sw, f = w - r * sw;
    const int v[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[r * sp + f] = v[e];
      if (++f == sw) { f = 0; ++r; }
    }
  }
  for (int w = lead + 4 * nvec + threadIdx.x; w < nw; w += TILE)
    s[w / sw * sp + w % sw] = g[w];
}

// The reverse of stage_in: the nw words of s (sw words a router at stride
// odd(sw)) to g, with 16-byte stores where g is 16-byte aligned.
__device__ __forceinline__ void stage_out(const int32_t* __restrict__ s,
                                          int nw, int sw,
                                          int32_t* __restrict__ g) {
  const int sp = odd(sw);
  const int lead = min(nw, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(g) & 15)) & 15) >> 2));
  for (int w = threadIdx.x; w < lead; w += TILE)
    g[w] = s[w / sw * sp + w % sw];
  const int nvec = (nw - lead) >> 2;
  int4* gv = reinterpret_cast<int4*>(g + lead);
#pragma unroll 4
  for (int j = threadIdx.x; j < nvec; j += TILE) {
    const int w = lead + 4 * j;
    int r = w / sw, f = w - r * sw;
    int v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = s[r * sp + f];
      if (++f == sw) { f = 0; ++r; }
    }
    gv[j] = make_int4(v[0], v[1], v[2], v[3]);
  }
  for (int w = lead + 4 * nvec + threadIdx.x; w < nw; w += TILE)
    g[w] = s[w / sw * sp + w % sw];
}

// floor modulo for b > 0, as torch's % on integers
__device__ __forceinline__ int fmod_floor(int a, int b) {
  const int r = a % b;
  return r < 0 ? r + b : r;
}

__global__ void __launch_bounds__(TILE)
phase2_router_kernel(const Phase2Args a) {
  extern __shared__ int32_t smem[];
  __shared__ unsigned int s_sum[2];
  __shared__ int s_last;

  const int rw = a.rob_slots * NUM_R;   // words of a router's ROB
  const int pw = a.pc_depth * NUM_P;    // words of its pending queue
  int32_t* s_inp = smem;                // flits in, then flits out
  int32_t* s_rob = s_inp + TILE * odd(INP_W);
  int32_t* s_pc = s_rob + TILE * odd(rw);

  const int t = threadIdx.x;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * TILE;
  const int nr = static_cast<int>(min(static_cast<int64_t>(TILE), a.n - i0));
  const int64_t i = i0 + t;
  if (t == 0) s_sum[0] = s_sum[1] = 0;
  stage_in(a.inp + i0 * INP_W, nr * INP_W, INP_W, s_inp);
  stage_in(a.rob + i0 * rw, nr * rw, rw, s_rob);
  stage_in(a.pc + i0 * pw, nr * pw, pw, s_pc);
  __syncthreads();

  unsigned int my_inj = 0, my_defl = 0;
  if (t < nr) {
    int32_t* fl = s_inp + t * odd(INP_W);
    const int32_t* rb = s_rob + t * odd(rw);
    const int32_t* pq = s_pc + t * odd(pw);
    const int nid = a.node_id[i];
    int f[P][NUM_F];                     // the router's input flits
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int k = 0; k < NUM_F; ++k) f[p][k] = fl[p * NUM_F + k];
    bool vpp[P];
    int n_vp = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      vpp[p] = a.vp[i * P + p] != 0;
      n_vp += vpp[p];
    }

    // ---- ejection (S10, S11) ----
    bool has_free = false, rob_free = false;
    bool match[P] = {false, false, false, false};
    for (int k = 0; k < a.rob_slots; ++k) {
      const int rnfl = rb[k * NUM_R + R_NFL];
      const int rsrc = rb[k * NUM_R + R_SRC];
      const int rpkt = rb[k * NUM_R + R_PKT];
      has_free |= !(rnfl > 0);
      rob_free |= rnfl == 0;
#pragma unroll
      for (int p = 0; p < P; ++p)
        match[p] |= rnfl > 0 && rsrc == f[p][F_SRC] && rpkt == f[p][F_PKT];
    }
    int pc_cnt = 0;
    for (int d = 0; d < a.pc_depth; ++d) pc_cnt += pq[d * NUM_P + P_VALID] > 0;
    const bool pc_empty = pc_cnt == 0;
    const bool pc_has_slot = pc_cnt < a.pc_depth;
    const int ej_age = a.pc_depth > 1 ? *a.knob_ej_age : 0;
    int ej = 0, ej_key = -1;             // first index of the maximum key
    bool valid_in[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      valid_in[p] = f[p][F_VALID] > 0;
      const bool acc = f[p][F_NFL] == 1 || match[p] || has_free;
      const bool ej_ok =
          a.pc_depth > 1
              ? pc_empty || (f[p][F_AGE] >= ej_age &&
                             (pc_has_slot || f[p][F_NFL] > 1 || rob_free))
              : pc_empty;
      const bool want = valid_in[p] && f[p][F_DST] == nid && acc && ej_ok;
      const int key = want ? f[p][F_AGE] * 4 + (3 - p) : -1;
      if (key > ej_key || p == 0) { ej_key = key; ej = p; }
    }
    const bool has_ej = ej_key >= 0;

    // ---- injection (S12): the send queue's head flit ----
    bool valid[S];
    int n_rem = 0;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      valid[p] = valid_in[p] && !(has_ej && p == ej);
      n_rem += valid[p];
    }
    const int qh = a.q_head[i], qs = a.q_size[i], qf = a.q_fid[i];
    const int32_t* head =
        a.q_desc + (i * (a.send_queue + 1) + fmod_floor(qh, a.send_queue)) *
                       NUM_Q;
    const bool can_inj = qs > 0 && n_rem < n_vp;
    valid[P] = can_inj;
    int inj[NUM_F];
    inj[F_VALID] = can_inj;
    inj[F_AGE] = 0;
    inj[F_SRC] = nid;
    inj[F_DST] = head[Q_DST];
    inj[F_OSRC] = head[Q_OSRC];
    inj[F_TYP] = head[Q_TYP];
    inj[F_TAG] = head[Q_TAG];
    inj[F_PKT] = head[Q_PKT];
    inj[F_FID] = qf;
    inj[F_NFL] = head[Q_NFL];

    // ---- arbitration; a candidate that is not valid is all zeros ----
    const int nr_ = a.node_r[i], nc_ = a.node_c[i];
    int age[S], dc[S], dr[S], asg[S];
    bool we[S], dfl[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int dst = s < P ? (valid[s] ? f[s][F_DST] : 0) : inj[F_DST];
      age[s] = s < P ? (valid[s] ? f[s][F_AGE] : 0) : 0;
      dr[s] = (dst >= 0 ? dst / a.cols : 0) - nr_;
      dc[s] = (dst >= 0 ? dst % a.cols : 0) - nc_;
      we[s] = valid[s] && dst == nid;
    }
    arbitrate_router(age, valid, we, dc, dr, vpp, asg, dfl);

    // ---- each output port takes the first candidate assigned to it,
    //      its age bumped if it was deflected; an untaken port is zeros.
    //      Written over the router's own flit slab: its flits are in f.
#pragma unroll
    for (int p = 0; p < P; ++p) {
      int src = -1;
#pragma unroll
      for (int s = S - 1; s >= 0; --s)
        if (valid[s] && asg[s] == p) src = s;
#pragma unroll
      for (int k = 0; k < NUM_F; ++k) {
        int x = 0;
#pragma unroll
        for (int s = 0; s < P; ++s)
          if (src == s) x = f[s][k];
        if (src == P) x = inj[k];
        if (k == F_AGE) {
#pragma unroll
          for (int s = 0; s < S; ++s)
            if (src == s && dfl[s]) x += 1;
        }
        if (k == F_VALID) x = src >= 0;
        fl[p * NUM_F + k] = x;
      }
    }

    // ---- pop the send queue on injection ----
    const int qf1 = qf + can_inj;
    const bool pkt_done = can_inj && qf1 >= head[Q_NFL];
    a.q_head_out[i] = pkt_done ? fmod_floor(qh + 1, a.send_queue) : qh;
    a.q_size_out[i] = pkt_done ? qs - 1 : qs;
    a.q_fid_out[i] = pkt_done ? 0 : qf1;
    a.ej_port[i] = ej;
    a.has_ej[i] = has_ej;
    my_inj = can_inj;
#pragma unroll
    for (int s = 0; s < S; ++s) my_defl += dfl[s] && valid[s];
  }
  __syncthreads();
  stage_out(s_inp, nr * INP_W, INP_W, a.out + i0 * INP_W);

  // ---- statistics: CTA sums, then one global sum; the last CTA writes
  //      stats_out and re-zeroes the scratch words ----
  my_inj = __reduce_add_sync(0xffffffffu, my_inj);
  my_defl = __reduce_add_sync(0xffffffffu, my_defl);
  if ((t & 31) == 0) {
    atomicAdd(&s_sum[0], my_inj);
    atomicAdd(&s_sum[1], my_defl);
  }
  __syncthreads();
  if (t == 0) {
    atomicAdd(&a.scratch[0], s_sum[0]);
    atomicAdd(&a.scratch[1], s_sum[1]);
    __threadfence();
    s_last = atomicAdd(&a.scratch[2], 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  if (t == 0) {
    __threadfence();
    s_sum[0] = atomicExch(&a.scratch[0], 0u);
    s_sum[1] = atomicExch(&a.scratch[1], 0u);
    atomicExch(&a.scratch[2], 0u);
    *a.n_injected = static_cast<int32_t>(s_sum[0]);
    *a.n_deflected = static_cast<int32_t>(s_sum[1]);
  }
  __syncthreads();
  for (int j = t; j < a.num_stats; j += TILE) {
    unsigned int x = static_cast<unsigned int>(a.stats[j]);
    if (j == a.stat_injected) x += s_sum[0];
    if (j == a.stat_deflections) x += s_sum[1];
    a.stats_out[j] = static_cast<int32_t>(x);
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

extern "C" int phase2_router(const Phase2Args* args, void* stream) {
  const Phase2Args& a = *args;   // a.n >= 1: the wrapper checks it
  const size_t smem = sizeof(int32_t) * TILE *
                      (odd(INP_W) + odd(a.rob_slots * NUM_R) +
                       odd(a.pc_depth * NUM_P));
  // above 48 KB a CTA's dynamic shared memory needs an opt-in, once per
  // device and size
  static size_t opted[64] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (smem > 48 * 1024 && dev < 64 && smem > opted[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        phase2_router_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    opted[dev] = smem;
  }
  const int blocks = (a.n + TILE - 1) / TILE;
  phase2_router_kernel<<<blocks, TILE, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
