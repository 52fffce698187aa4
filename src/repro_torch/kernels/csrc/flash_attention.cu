// Blocked causal or full attention with an online softmax (flash
// attention, forward), written for Hopper (sm_90a).  Two kernels behind
// one C entry point, chosen by dtype:
//
// * bfloat16: flash_attention_wgmma_kernel, on the tensor cores (wgmma,
//   fed by TMA);
// * float32: flash_attention_f32_kernel, on the CUDA cores.
//
// Both replace repro/kernels/flash_attention.py::_attn_kernel (the Pallas
// TPU kernel, entry flash_attention_pallas).  Their plain PyTorch version
// is repro_torch/kernels/ref.py::attention_ref; they stay within 5e-2
// (bfloat16) and 1e-5 (float32) of it.
//
// What they compute: q (B, H, S, D), k and v (B, KV, T, D), all
// contiguous; out (B, H, S, D) in q's dtype.  Head h reads K/V head
// h / (H / KV) directly, so grouped-query attention needs no repeated copy
// of K and V.  Logits are (q . k) / sqrt(dh) in float32, dh the model's
// head dim; with causal set, key t is visible to query s when t <= s
// (S == T).  D is 32, 64 or 128: the wrapper pads another dh up to the
// next D with zero columns of q, k and v, which add nothing to a score,
// and cuts the output's zero columns.  S and T are multiples of 128.  Masked logits are -1e30, never -inf, so
// no arithmetic yields NaN.  The output is acc / max(l, 1e-30).
//
// What bounds them: operations.  At the tinyllama-1.1b prefill shape
// (B 4, H 32, KV 4, S = T = 2048, D 64, bfloat16, causal) the two products
// are 6.875e10 FLOP, 69.5 us at the H100's 989 TFLOP/s of dense bf16
// tensor-core work, against 75.5 MB of q, k, v and out, 22.5 us at
// 3.35 TB/s.
//
// The bfloat16 kernel.  One CTA per (128-row query tile, head, batch),
// heaviest causal tiles first; 288 threads: two consumer warpgroups of 64
// query rows each, and one producer warp.
// * Copies: the producer's first lane loads the Q tile once and streams
//   the K and V tiles (128 rows each) through a 3-stage ring in shared
//   memory with TMA (cp.async.bulk.tensor), each completing on its own
//   mbarrier; the consumers free a stage with one arrive per warp.  The
//   tensors are 2-D to TMA: q and out as (B*H*S, D), k and v as
//   (B*KV*T, D); a K/V tile starts at row (b*KV + kvh)*T + kt*128.  A tile
//   lands as D/64 panels of 64 columns with the 128-byte swizzle (D 64,
//   128), or as one 32-column panel with the 64-byte swizzle (D 32), the
//   layouts wgmma reads.
// * S = Q.K^T: wgmma m64n128k16, both operands from shared memory, K
//   K-major (no transpose), D/16 k-steps, float32 accumulators.
// * Softmax in registers: p = 2^((s - m) log2(e)/sqrt(dh)), one FMA and
//   one ex2 a logit; the per-element causal mask only on the diagonal
//   tile, which is taken first (key tiles run from the diagonal down to 0,
//   and every row sees its own key there, so the running max is finite
//   from the first update); the row max across the quad of threads that
//   share a row (shuffles xor 1 and 2); running max and denominator per
//   row in float32; the O accumulator rescaled once per key tile.
// * O += P.V: P rounded to bf16 in registers is wgmma's A operand (the
//   accumulator layout of S is the A-fragment layout, k16 by k16); V from
//   shared memory as B, MN-major (transpose flag set); m64nDk16, 8
//   k-steps a tile, D/2 float32 accumulators per thread.
// * Overlap: within a warpgroup, tile i's S product is issued together
//   with tile i - 1's P.V, and tile i's softmax runs while that P.V is on
//   the tensor cores.  At D <= 64 the two warpgroups take turns to issue
//   their products (a ping-pong on two named barriers), so that one's
//   softmax runs while the other's products are on the tensor cores; at D
//   128 they run independently.  The producer keeps up to three tiles in
//   flight.  The epilogue stores bf16 pairs straight from registers.
//
// The float32 kernel: wgmma's float32 inputs are TF32, which keeps about
// three decimal digits and would miss the 1e-5 tolerance, so float32 stays
// on the CUDA cores (67 TFLOP/s at best).  One CTA per (128-row query
// tile, head, batch), heaviest causal tiles first.  Each query row
// belongs to D/32 neighbouring threads of a warp; a thread keeps 32 of the
// row's dims of q (pre-scaled) and of the accumulator in registers, in
// float4 granules r, r + R, ... so that the R threads of a row read
// distinct banks.  K/V stream through shared memory in 64-row tiles up to
// the causal diagonal.  Scores are taken 16 keys at a time: partial dot
// products are summed across the row's threads with shuffles, then the
// running max, denominator and accumulator are updated once per 16 keys;
// the first 16 keys hold key 0, which every causal row sees.
//
// Offsets are 64-bit.  The C entry point takes plain pointers and the
// stream and returns a CUDA error code (cudaGetLastError() after the
// launch), so the Python wrapper can bind it with ctypes.  The TMA tensor
// maps are encoded on the host with cuTensorMapEncodeTiled, a libcuda
// entry point fetched through the runtime (no link to libcuda).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------
// float32: the CUDA-core kernel

constexpr int BQ = 128;  // query rows per CTA
constexpr int BK = 64;   // key/value rows per shared-memory tile
constexpr int G = 16;    // keys per online-softmax update
constexpr int DPT = 32;  // head dims held by one thread

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

template <int D>
__global__ void __launch_bounds__(BQ * D / DPT)
flash_attention_f32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o,
                           int H, int KVH, int S, int Tk, int causal,
                           float scale) {
  constexpr int R = D / DPT;   // threads per query row
  constexpr int NT = BQ * R;   // threads per CTA
  constexpr int GR = D / 4;    // float4 granules per row
  constexpr int GPT = DPT / 4; // granules per thread
  extern __shared__ float4 smem[];
  float4* ks = smem;            // BK x GR
  float4* vs = smem + BK * GR;  // BK x GR

  const int tid = threadIdx.x;
  const int row = tid / R;
  const int r = tid % R;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int qrow = qt * BQ + row;
  const int64_t qoff = ((int64_t)(b * H + h) * S + qrow) * D;
  const int64_t kbase = (int64_t)(b * KVH + kvh) * Tk * D;

  float qv[DPT], acc[DPT];
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    const float4 x = load4(q + qoff + 4 * (r + R * i));
    qv[4 * i + 0] = x.x * scale;
    qv[4 * i + 1] = x.y * scale;
    qv[4 * i + 2] = x.z * scale;
    qv[4 * i + 3] = x.w * scale;
  }
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;
  float m = NEG, l = 0.f;

  const int num_k = Tk / BK;
  // only key tiles at or before this query tile's last row contribute
  const int upper = causal ? min(num_k, ((qt + 1) * BQ + BK - 1) / BK)
                           : num_k;

  for (int kt = 0; kt < upper; ++kt) {
    __syncthreads();  // every thread is done with the previous tile
    for (int g = tid; g < BK * GR; g += NT) {
      const int64_t off = kbase + (int64_t)(kt * BK + g / GR) * D
                          + 4 * (g % GR);
      ks[g] = load4(k + off);
      vs[g] = load4(v + off);
    }
    __syncthreads();

#pragma unroll 1
    for (int j0 = 0; j0 < BK; j0 += G) {
      float s[G];
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const float4* kr = ks + (j0 + jj) * GR;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          const float4 kk = kr[r + R * i];
          part = fmaf(qv[4 * i + 0], kk.x, part);
          part = fmaf(qv[4 * i + 1], kk.y, part);
          part = fmaf(qv[4 * i + 2], kk.z, part);
          part = fmaf(qv[4 * i + 3], kk.w, part);
        }
#pragma unroll
        for (int off = 1; off < R; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[jj] = part;
      }
      if (causal) {
        const int key0 = kt * BK + j0;
#pragma unroll
        for (int jj = 0; jj < G; ++jj)
          if (key0 + jj > qrow) s[jj] = NEG;
      }
      float mx = m;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) mx = fmaxf(mx, s[jj]);
      const float alpha = expf(m - mx);
      float psum = 0.f;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        s[jj] = expf(s[jj] - mx);
        psum += s[jj];
      }
      l = l * alpha + psum;
      m = mx;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= alpha;
#pragma unroll
      for (int jj = 0; jj < G; ++jj) {
        const float4* vr = vs + (j0 + jj) * GR;
        const float p = s[jj];
#pragma unroll
        for (int i = 0; i < GPT; ++i) {
          const float4 vv = vr[r + R * i];
          acc[4 * i + 0] = fmaf(p, vv.x, acc[4 * i + 0]);
          acc[4 * i + 1] = fmaf(p, vv.y, acc[4 * i + 1]);
          acc[4 * i + 2] = fmaf(p, vv.z, acc[4 * i + 2]);
          acc[4 * i + 3] = fmaf(p, vv.w, acc[4 * i + 3]);
        }
      }
    }
  }

  const float den = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < GPT; ++i) {
    store4(o + qoff + 4 * (r + R * i),
           make_float4(acc[4 * i + 0] / den, acc[4 * i + 1] / den,
                       acc[4 * i + 2] / den, acc[4 * i + 3] / den));
  }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int KVH, int S, int Tk, int dh,
                       int causal, cudaStream_t stream) {
  const int smem = 2 * BK * D * (int)sizeof(float);
  // above 48 KB (D = 128) dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_f32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch below is not made
    return err;
  }
  const float scale = (float)(1.0 / sqrt((double)dh));
  const dim3 grid(S / BQ, H, B);
  flash_attention_f32_kernel<D><<<grid, BQ * D / DPT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, KVH, S, Tk,
      causal, scale);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------
// bfloat16: the tensor-core kernel

constexpr int TILE = 128;              // query rows per CTA; K/V tile rows
constexpr int STAGES = 3;              // K/V ring depth
constexpr int CONSUMERS = 256;         // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp

// Shared-memory geometry of a 128-row bf16 tile of width D.
template <int D>
struct Tile {
  static constexpr int PW = D < 64 ? D : 64;      // columns per panel
  static constexpr int SW = PW * 2;               // bytes per panel row
  static constexpr int NP = D / PW;               // panels
  static constexpr int PANEL = TILE * SW;         // bytes per panel
  static constexpr int BYTES = NP * PANEL;        // bytes per tile
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr int SMEM = (1 + 2 * STAGES) * BYTES  // Q, K and V ring
                              + 8 * (1 + 3 * STAGES)    // mbarriers
                              + 1024;                   // alignment slack
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// of seconds means the pipeline is broken: trap, so that the launch fails
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > (1ll << 34)) __trap();
}

// One box (a 128-row panel) of a 2-D tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
        "r"(row) : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (all in 16-byte units), swizzle layout type.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of wgmma's register
// operands (accumulators, A fragments) across the wgmma fence, issue and
// wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[i][e])::"memory");
}

#define WG_R16 "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
               "%14, %15"
#define WG_R32 WG_R16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, " \
               "%26, %27, %28, %29, %30, %31"
#define WG_R64 WG_R32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, " \
               "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
               "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define WG_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define WG_F16(i) WG_F4(i), WG_F4(i + 4), WG_F4(i + 8), WG_F4(i + 12)

// d (64 x 128, float32) (+)= A (64 x 16, smem, K-major) . B (16 x 128,
// smem, K-major); scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x N, float32) += A (64 x 16, bf16 in registers) . B (16 x N, smem,
// MN-major: transpose flag set).
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" WG_R16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : WG_F16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" WG_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : WG_F16(0), WG_F16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  } else {
    static_assert(N == 128, "head dim is 32, 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" WG_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Issue S = Q . K^T for one warpgroup's 64 query rows (q: their first row
// in the Q tile) and a 128-row K tile, and commit it as one group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q,
                                         uint32_t k) {
  using TL = Tile<D>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk * 16 / TL::PW) * TL::PANEL
                         + (kk * 16 % TL::PW) * 2;
    wgmma_qk(s, gmma_desc(q + off, 16, 8 * TL::SW, TL::LAYOUT),
             gmma_desc(k + off, 16, 8 * TL::SW, TL::LAYOUT), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P . V for a 128-row V tile and commit it as one group; the
// registers of acc and p stay untouched until it completes.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         uint32_t (&p)[8][4], uint32_t v) {
  using TL = Tile<D>;
  fence_regs(acc);
  fence_regs(p);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv<D>(acc, p[kk],
                gmma_desc(v + kk * 16 * TL::SW, TL::PANEL, 8 * TL::SW,
                          TL::LAYOUT));
  wgmma_commit();
}

// Online softmax over one key tile.  s holds this thread's logits (in
// units of q . k): s[4j + e] is row r0 (e = 0, 1) or r0 + 8 (e = 2, 3) of
// the query tile, column 8j + c0 + (e & 1) of the key tile.  MASK hides
// the keys past each row (the diagonal tile).  Updates the running max m
// and this thread's share l of the row sum, returns in alpha the factor
// that rescales the accumulator, and leaves p = 2^((s - m) sl2) in s, sl2
// being log2(e) / sqrt(dh).
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int r0, int c0, float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK && 8 * j + c0 + (e & 1) > r0 + (e & 2) * 4) s[4 * j + e] = NEG;
      mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
    }
  float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the quad of threads that share the row
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    alpha[r] = ex2((m[r] - mx[r]) * sl2);
    m[r] = mx[r];
    ms[r] = mx[r] * sl2;
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ex2(fmaf(s[4 * j + e], sl2, -ms[e / 2]));
      sum[e / 2] += s[4 * j + e];
    }
  // the quad's shares of l are added once, in the epilogue
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
}

// Rescale the accumulator rows by alpha, and round P to bf16 as wgmma's
// A fragments (the S accumulator layout, k16 by k16: keys 16kk..16kk+15).
template <int D>
__device__ __forceinline__ void rescale_and_pack(float (&acc)[D / 2],
                                                 uint32_t (&p)[8][4],
                                                 const float (&s)[64],
                                                 const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[kk][e] = pack_bf16(s[8 * kk + 2 * e], s[8 * kk + 2 * e + 1]);
}

// Ping-pong between the two consumer warpgroups (named barriers 1 and 2,
// 256 threads each): a warpgroup issues its products only after the other
// has issued its own for the previous step, so that one's softmax runs
// while the other's products are on the tensor cores.
__device__ __forceinline__ void turn_wait(int id) {
  asm volatile("bar.sync %0, 256;" ::"r"(id) : "memory");
}
__device__ __forceinline__ void turn_pass(int id) {
  asm volatile("bar.arrive %0, 256;" ::"r"(id) : "memory");
}

// The ping-pong pays at D <= 64; at D 128 the overlapped loop needs more
// registers than ptxas gives a 288-thread CTA (168), the wgmmas are
// serialized, and the ping-pong only adds waits.
template <int D>
constexpr bool PINGPONG = D <= 64;

// The consumer warpgroups' part of the kernel.  Warpgroup g owns query
// rows 64g .. 64g + 63 of the tile; this thread holds rows r0 and r0 + 8
// of them, and in each 8-column group of an accumulator the columns c0 and
// c0 + 1.
template <int D>
__device__ __forceinline__ void consumer(
    __nv_bfloat16* __restrict__ o, uint32_t q_s, uint32_t k_s, uint32_t v_s,
    uint32_t bar_q, uint32_t full_k, uint32_t full_v, uint32_t empty,
    int warp, int lane, int qrow0, int n_tiles, int causal,
    float scale_log2) {
  using TL = Tile<D>;
  const int g = warp / 4;
  const int r0 = g * 64 + 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_g = q_s + g * 64 * TL::SW;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[64];
  uint32_t p[8][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];

  // the ping-pong's order: warpgroup 0 issues step j after warpgroup 1
  // issued step j - 1 (barrier 1), warpgroup 1 issues step j after
  // warpgroup 0 issued step j (barrier 2); steps are the first S, each
  // loop iteration, and the last P.V
  const int mine = 1 + g, other = 2 - g;

  // tile 0 (the diagonal, when causal) in stage 0
  mbar_wait(bar_q, 0);
  mbar_wait(full_k, 0);
  if (PINGPONG<D> && g == 1) turn_wait(mine);
  issue_qk<D>(s, q_g, k_s);
  if (PINGPONG<D>) turn_pass(other);
  wgmma_wait<0>();
  fence_regs(s);
  if (causal)
    softmax_tile<true>(s, m, l, alpha, r0, c0, scale_log2);
  else
    softmax_tile<false>(s, m, l, alpha, r0, c0, scale_log2);
  rescale_and_pack<D>(acc, p, s, alpha);

  // tile i's softmax runs while tile i - 1's P . V is on the tensor cores
  for (int i = 1; i < n_tiles; ++i) {
    const int st = i % STAGES, prev = (i - 1) % STAGES;
    mbar_wait(full_k + 8 * st, (i / STAGES) & 1);
    mbar_wait(full_v + 8 * prev, ((i - 1) / STAGES) & 1);
    if (PINGPONG<D>) turn_wait(mine);
    issue_qk<D>(s, q_g, k_s + st * TL::BYTES);
    issue_pv<D>(acc, p, v_s + prev * TL::BYTES);
    if (PINGPONG<D>) turn_pass(other);
    wgmma_wait<1>();  // S of tile i is done
    fence_regs(s);
    softmax_tile<false>(s, m, l, alpha, r0, c0, scale_log2);
    wgmma_wait<0>();  // P . V of tile i - 1 is done: free its stage
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * prev);
    rescale_and_pack<D>(acc, p, s, alpha);
  }
  const int last = (n_tiles - 1) % STAGES;
  mbar_wait(full_v + 8 * last, ((n_tiles - 1) / STAGES) & 1);
  if (PINGPONG<D>) turn_wait(mine);
  issue_pv<D>(acc, p, v_s + last * TL::BYTES);
  if (PINGPONG<D> && g == 0) turn_pass(other);
  wgmma_wait<0>();
  fence_regs(acc);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* out0 = o + (int64_t)(qrow0 + r0) * D + c0;
  __nv_bfloat16* out1 = out0 + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<__nv_bfloat162*>(out0 + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    *reinterpret_cast<__nv_bfloat162*>(out1 + 8 * j) =
        __floats2bfloat162_rn(acc[4 * j + 2] * inv[1],
                              acc[4 * j + 3] * inv[1]);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                             const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap,
                             __nv_bfloat16* __restrict__ o, int H, int KVH,
                             int S, int Tk, int causal, float scale_log2) {
  using TL = Tile<D>;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on a 1024-byte boundary (the 128-byte swizzle
  // repeats every 8 rows of 128 bytes)
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = base + TL::BYTES;                    // + st * BYTES
  const uint32_t v_s = base + (1 + STAGES) * TL::BYTES;     // + st * BYTES
  const uint32_t bars = base + (1 + 2 * STAGES) * TL::BYTES;
  const uint32_t bar_q = bars;
  const uint32_t full_k = bars + 8;                   // + 8 * st
  const uint32_t full_v = bars + 8 * (1 + STAGES);    // + 8 * st
  const uint32_t empty = bars + 8 * (1 + 2 * STAGES); // + 8 * st

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tile first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const int qrow0 = (b * H + h) * S + qt * TILE;     // row of q and out
  const int krow0 = (b * KVH + kvh) * Tk;            // row of k and v
  // key tiles from the diagonal (or the last) down to 0
  const int n_tiles = causal ? qt + 1 : Tk / TILE;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(bar_q, TL::BYTES);
      for (int p = 0; p < TL::NP; ++p)
        tma_load(q_s + p * TL::PANEL, &qmap, bar_q, p * TL::PW, qrow0);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * st, (i / STAGES - 1) & 1);
        const int krow = krow0 + (n_tiles - 1 - i) * TILE;
        const uint32_t ks = k_s + st * TL::BYTES;
        const uint32_t vs = v_s + st * TL::BYTES;
        mbar_expect_tx(full_k + 8 * st, TL::BYTES);
        for (int p = 0; p < TL::NP; ++p)
          tma_load(ks + p * TL::PANEL, &kmap, full_k + 8 * st, p * TL::PW,
                   krow);
        mbar_expect_tx(full_v + 8 * st, TL::BYTES);
        for (int p = 0; p < TL::NP; ++p)
          tma_load(vs + p * TL::PANEL, &vmap, full_v + 8 * st, p * TL::PW,
                   krow);
      }
    }
  } else {
    consumer<D>(o, q_s, k_s, v_s, bar_q, full_k, full_v, empty, warp, lane,
                qrow0, n_tiles, causal, scale_log2);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, fetched once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A (rows, D) bf16 tensor as TMA sees it: boxes of one 128-row panel.
template <int D>
bool encode(EncodeTiled enc, CUtensorMap* map, const void* ptr,
            uint64_t rows) {
  using TL = Tile<D>;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)TL::PW, (cuuint32_t)TILE};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE,
             TL::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KVH, int S, int Tk, int dh,
                        int causal, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap qmap, kmap, vmap;
  if (!encode<D>(enc, &qmap, q, (uint64_t)B * H * S)
      || !encode<D>(enc, &kmap, k, (uint64_t)B * KVH * Tk)
      || !encode<D>(enc, &vmap, v, (uint64_t)B * KVH * Tk))
    return cudaErrorInvalidValue;
  const int smem = Tile<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch below is not made
    return err;
  }
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)dh));
  const dim3 grid(S / TILE, H, B);
  flash_attention_wgmma_kernel<D><<<grid, THREADS, smem, stream>>>(
      qmap, kmap, vmap, static_cast<__nv_bfloat16*>(o), H, KVH, S, Tk,
      causal, scale_log2);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KVH, int S, int Tk, int D, int dh,
                     int causal, cudaStream_t st) {
#define FA_LAUNCH(DIM)                                                   \
  return BF16                                                            \
      ? launch_bf16<DIM>(q, k, v, o, B, H, KVH, S, Tk, dh, causal, st)   \
      : launch_f32<DIM>(q, k, v, o, B, H, KVH, S, Tk, dh, causal, st)
  switch (D) {
    case 32: FA_LAUNCH(32);
    case 64: FA_LAUNCH(64);
    case 128: FA_LAUNCH(128);
    default: return cudaErrorInvalidValue;
  }
#undef FA_LAUNCH
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  D is the tensors' head dim (32, 64 or
// 128), dh the head dim whose 1 / sqrt(dh) scales the logits (dh <= D;
// the columns past dh are zero).  The wrapper checks shapes, types,
// divisibility, contiguity and alignment before it calls this.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KVH, int S, int T,
                               int D, int dh, int dtype, int causal,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh < 1 || dh > D)
    err = cudaErrorInvalidValue;
  else if (dtype == 0)
    err = launch_d<false>(q, k, v, o, B, H, KVH, S, T, D, dh, causal, st);
  else if (dtype == 1)
    err = launch_d<true>(q, k, v, o, B, H, KVH, S, T, D, dh, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
