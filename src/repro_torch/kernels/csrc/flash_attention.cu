// Blocked causal or full attention with an online softmax (flash
// attention, forward), written for Hopper (sm_90a).  Two kernels behind
// one C entry point, chosen by dtype, both on the tensor cores (wgmma, fed
// by TMA):
//
// * bfloat16: flash_attention_wgmma_kernel;
// * float32: flash_attention_3xtf32_kernel, each product taken in three
//   TF32 passes, after flash_attention_split_kv_kernel has split K and V.
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
// and cuts the output's zero columns.  S and T are multiples of 128.
// Masked logits are -1e30, never -inf, so no arithmetic yields NaN.  The
// output is acc / max(l, 1e-30).
//
// What bounds them: operations.  At the tinyllama-1.1b prefill shape
// (B 4, H 32, KV 4, S = T = 2048, D 64, causal) the two products are
// 6.875e10 FLOP: 69.5 us at the H100's 989 TFLOP/s of dense bf16
// tensor-core work, against 75.5 MB of q, k, v and out, 22.5 us at
// 3.35 TB/s; in float32, three TF32 passes of it at 495 TFLOP/s, 416.7 us
// (1,026 us on the CUDA cores at 67 TFLOP/s).
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
// The float32 kernel.  wgmma reads float32 as TF32 (10 mantissa bits),
// which alone misses 1e-5 by about 100 times.  So every operand x is split
// into hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// (cvt.rna), and each product is taken as lo.hi + hi.lo + hi.hi in float32
// accumulators, in that order ("3xTF32"); the dropped lo.lo and the
// roundings leave about 1e-6 of float32's answer.
// * Splits: a pre-pass (flash_attention_split_kv_kernel, 32 keys a block)
//   writes K hi and lo as (B, KV, T, D) and V^T hi and lo as (B, KV, D, T)
//   into scratch the wrapper allocates: four copies of k's bytes (33.6 MB
//   at the tinyllama shape), read and written once.  V^T, because wgmma
//   transposes only 16-bit operands: the B operand of P.V must be K-major
//   along the keys.  Q is split once per CTA, in shared memory, each
//   consumer warpgroup its own rows (hi over the loaded tile, lo beside),
//   then fence.proxy.async so that wgmma sees the generic writes.  P is
//   split in registers after the softmax.
// * P as wgmma's A operand from registers: the S accumulator gives a
//   thread columns 2t and 2t + 1 of each group of 8 keys, the tf32 A
//   fragment wants k-indices t and t + 4.  So the pre-pass stores key
//   2t + j of every group of 8 at V^T column t + 4j, and the thread passes
//   its registers (row r, key 2t), (r + 8, 2t), (r, 2t + 1), (r + 8,
//   2t + 1) as the fragment's (r, t), (r + 8, t), (r, t + 4), (r + 8,
//   t + 4).
// * Tiles (F32Tile): at D 32 and 64 two consumer warpgroups (128 query
//   rows) and 64-key tiles, at D 128 one warpgroup (64 rows) and 32-key
//   tiles, and one producer warp; a stage holds K hi, K lo, V^T hi and
//   V^T lo; 2 (D 64, 128) or 3 (D 32) stages, at most 192 KB of shared
//   memory with Q hi and lo.  Every tile lands as panels of 32 floats
//   (128 bytes) with the 128-byte swizzle; a k8 step is 32 bytes into a
//   panel.
// * S = Q.K^T: m64n{BK}k8, both operands from shared memory, 3 x D/8
//   wgmmas; t = P.V: m64nDk8, 3 x BK/8 wgmmas, P hi and lo in registers.
//   t starts from zero at every key tile and is folded into the row's
//   float32 accumulator on the CUDA cores (acc = acc alpha + t): the
//   tensor cores' own float32 sums, which truncate, then run over one
//   tile, not a whole row of keys: over 2048 keys one running
//   accumulator came close to the 1e-5 tolerance.
// * A warpgroup takes one tile at a time (S, the softmax and P's split,
//   then P.V); the other warpgroup's products fill the tensor cores
//   meanwhile.  Overlapping a warpgroup's S with its previous P.V, as the
//   bf16 kernel does, needs s, t and both halves of P live at once: more
//   than the 168 registers a thread of a 288-thread CTA gets, and it ran
//   slower at D 64 and 128 than this order, also with a producer
//   warpgroup handing its registers over by setmaxnreg.
// * The producer, the ring, the softmax (ex2 with log2(e)/sqrt(dh)
//   folded in, q unscaled) and the heaviest causal tiles first are the
//   bf16 kernel's.  Key tiles run upwards from key 0, which every row
//   sees, so the running max is finite from the first tile; the
//   per-element mask runs only on the tiles that reach past a
//   warpgroup's first row, and the first warpgroup of two skips the key
//   tile wholly above its rows.
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

// Online softmax over one key tile of NS / 2 keys.  s holds this
// thread's logits (in units of q . k): s[4j + e] is row r0 (e = 0, 1) or
// r0 + 8 (e = 2, 3), column 8j + c0 + (e & 1) of the key tile, r0 counted
// from the tile's first key.  MASK hides the keys past each row (the
// diagonal).  Updates the running max m and this thread's share l of the
// row sum, returns in alpha the factor that rescales the accumulator, and
// leaves p = 2^((s - m) sl2) in s, sl2 being log2(e) / sqrt(dh).
template <bool MASK, int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             int r0, int c0, float sl2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < NS / 4; ++j)
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
  for (int j = 0; j < NS / 4; ++j)
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

// ---------------------------------------------------------------------
// float32: three TF32 passes on the tensor cores

// Tiles of the float32 kernel at head dim D.  Every tile lies in shared
// memory as panels of 32 floats a row (128 bytes, the 128-byte swizzle):
// Q (BQ rows) and K (BK rows) as D / 32 panels, V^T (D rows of keys) as
// BK / 32 panels.  Q hi and lo, then per stage K hi, K lo, V^T hi and V^T
// lo: 192 KB at D 64 and 128, 128 KB at D 32.
template <int D>
struct F32Tile {
  static constexpr int NWG = D == 128 ? 1 : 2;     // consumer warpgroups
  static constexpr int BK = D == 128 ? 32 : 64;    // keys a K/V tile
  static constexpr int STAGES = D == 32 ? 3 : 2;   // K/V ring depth
  static constexpr int BQ = 64 * NWG;              // query rows a CTA
  static constexpr int THREADS = 128 * NWG + 32;   // and one producer warp
  static constexpr int QPANEL = BQ * 128;          // bytes of one panel
  static constexpr int KPANEL = BK * 128;
  static constexpr int VPANEL = D * 128;
  static constexpr int QBYTES = D / 32 * QPANEL;   // Q hi (Q lo the same)
  static constexpr int KBYTES = D / 32 * KPANEL;   // K hi (K lo the same)
  static constexpr int VBYTES = BK / 32 * VPANEL;  // V^T hi (V^T lo)
  static constexpr int STAGE = 2 * KBYTES + 2 * VBYTES;
  static constexpr int SMEM = 2 * QBYTES + STAGES * STAGE  // tiles
                              + 8 * (1 + 3 * STAGES)       // mbarriers
                              + 1024;                      // alignment
  static_assert(SMEM <= 232448, "shared memory of one CTA");
};

// wgmma descriptor of a k8 step (32 bytes) of a tile of 128-byte panels
// PANEL bytes apart: 8-row groups 1024 bytes apart, 128-byte swizzle.
template <int PANEL>
__device__ __forceinline__ uint64_t tf32_desc(uint32_t tile, int kk) {
  return gmma_desc(tile + (kk / 4) * PANEL + (kk % 4) * 32, 16, 1024, 1);
}

// d (64 x N, float32) (+)= A (64 x 8, tf32, smem, K-major) . B (8 x N,
// tf32, smem, K-major); scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[N / 2], uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_R16
        "}, %16, %17, p, 1, 1;\n}\n"
        : WG_F16(0)
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 64, "key tiles of 32 or 64");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R32
        "}, %32, %33, p, 1, 1;\n}\n"
        : WG_F16(0), WG_F16(16)
        : "l"(da), "l"(db), "r"(scale_d));
  }
}

// d (64 x N, float32) (+)= A (64 x 8, tf32 in registers) . B (8 x N,
// tf32, smem, K-major); scale_d 0 overwrites d.
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {" WG_R16
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : WG_F16(0)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {" WG_R32
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : WG_F16(0), WG_F16(16)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  } else {
    static_assert(N == 128, "head dim is 32, 64 or 128");
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {" WG_R64
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : WG_F16(0), WG_F16(16), WG_F16(32), WG_F16(48)
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
  }
}

// x rounded to TF32 (to nearest, ties away from zero), as a float's bits
// with the low 13 zero.
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t y;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(y) : "f"(x));
  return y;
}

// x as hi + lo, hi = tf32(x), lo = tf32(x - hi): together 22 bits of x's
// 24 (x - hi is exact in float32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void split4(float4 x, float4& hi, float4& lo) {
  uint32_t h[4], l[4];
  split_tf32(x.x, h[0], l[0]);
  split_tf32(x.y, h[1], l[1]);
  split_tf32(x.z, h[2], l[2]);
  split_tf32(x.w, h[3], l[3]);
  hi = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                   __uint_as_float(h[2]), __uint_as_float(h[3]));
  lo = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                   __uint_as_float(l[2]), __uint_as_float(l[3]));
}

// keys a block of the split pre-pass
constexpr int SPLIT_KEYS = 32;

// The pre-pass: k and v (B*KV, T, D) as k_hi, k_lo (B*KV, T, D) and v_hi,
// v_lo, which are V^T (B*KV, D, T) with the keys of every group of 8
// reordered: key 2t + j at column t + 4j (the P fragment's k-order).  One
// block of 256 threads per SPLIT_KEYS keys of one KV head; V^T is written
// through a transposed tile in shared memory, one row of 32 keys a warp.
template <int D>
__global__ void __launch_bounds__(256)
flash_attention_split_kv_kernel(const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ k_hi,
                                float* __restrict__ k_lo,
                                float* __restrict__ v_hi,
                                float* __restrict__ v_lo, int Tk) {
  __shared__ float vt[SPLIT_KEYS][D + 1];
  const int blocks = Tk / SPLIT_KEYS;
  const int64_t bk = blockIdx.x / blocks;              // b * KV + kvh
  const int t0 = (blockIdx.x % blocks) * SPLIT_KEYS;
  const int64_t in0 = (bk * Tk + t0) * D;
  for (int i = threadIdx.x; i < SPLIT_KEYS * D / 4; i += 256) {
    float4 hi, lo;
    split4(*reinterpret_cast<const float4*>(k + in0 + 4 * i), hi, lo);
    *reinterpret_cast<float4*>(k_hi + in0 + 4 * i) = hi;
    *reinterpret_cast<float4*>(k_lo + in0 + 4 * i) = lo;
    const float4 x = *reinterpret_cast<const float4*>(v + in0 + 4 * i);
    float* row = &vt[4 * i / D][4 * i % D];
    row[0] = x.x;
    row[1] = x.y;
    row[2] = x.z;
    row[3] = x.w;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPLIT_KEYS * D; i += 256) {
    const int d = i / SPLIT_KEYS, col = i % SPLIT_KEYS;
    const int key = (col & ~7) | (2 * (col & 3) + ((col >> 2) & 1));
    uint32_t hi, lo;
    split_tf32(vt[key][d], hi, lo);
    const int64_t out = (bk * D + d) * Tk + t0 + col;
    v_hi[out] = __uint_as_float(hi);
    v_lo[out] = __uint_as_float(lo);
  }
}

// Issue S = Q.K^T in three TF32 passes (Q lo.K hi, Q hi.K lo, Q hi.K hi)
// for one warpgroup's 64 query rows (q_hi, q_lo: their first row in the Q
// tiles) and one K tile, and commit it as one group.
template <int D>
__device__ __forceinline__ void issue_s_f32(float (&s)[F32Tile<D>::BK / 2],
                                            uint32_t q_hi, uint32_t q_lo,
                                            uint32_t k_hi, uint32_t k_lo) {
  using TL = F32Tile<D>;
  fence_regs(s);
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk)
      wgmma_tf32_ss<TL::BK>(
          s, tf32_desc<TL::QPANEL>(pass == 0 ? q_lo : q_hi, kk),
          tf32_desc<TL::KPANEL>(pass == 1 ? k_lo : k_hi, kk),
          pass > 0 || kk > 0);
  wgmma_commit();
}

// Issue t = P.V in three TF32 passes (P lo.V hi, P hi.V lo, P hi.V hi)
// for one V^T tile and commit it as one group; the registers of t and p
// stay untouched until it completes.  t starts from zero: the tensor
// cores sum one tile's 3 BK / 8 steps, and the tiles are summed in
// float32 on the CUDA cores (fold), so their truncated sums never run
// along a whole row of keys.
template <int D>
__device__ __forceinline__ void issue_pv_f32(
    float (&t)[D / 2], uint32_t (&p_hi)[F32Tile<D>::BK / 8][4],
    uint32_t (&p_lo)[F32Tile<D>::BK / 8][4], uint32_t v_hi, uint32_t v_lo) {
  using TL = F32Tile<D>;
  fence_regs(t);
  fence_regs(p_hi);
  fence_regs(p_lo);
  wgmma_fence();
#pragma unroll
  for (int pass = 0; pass < 3; ++pass)
#pragma unroll
    for (int kk = 0; kk < TL::BK / 8; ++kk)
      wgmma_tf32_rs<D>(t, pass == 0 ? p_lo[kk] : p_hi[kk],
                       tf32_desc<TL::VPANEL>(pass == 1 ? v_lo : v_hi, kk),
                       pass > 0 || kk > 0);
  wgmma_commit();
}

// acc = acc alpha + t: the tile's P.V added to the rows' sum, rescaled
// to the tile's running max.
template <int D>
__device__ __forceinline__ void fold(float (&acc)[D / 2],
                                     const float (&t)[D / 2],
                                     const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i)
    acc[i] = fmaf(acc[i], alpha[(i / 2) % 2], t[i]);
}

// Split P into wgmma's tf32 A fragments, k8 step kk being keys 8kk ..
// 8kk + 7: registers (r, t), (r + 8, t), (r, t + 4), (r + 8, t + 4) of the
// fragment take this thread's keys 2t, 2t, 2t + 1, 2t + 1 of rows r,
// r + 8, r, r + 8, which V^T's reordered columns t and t + 4 meet.
template <int D>
__device__ __forceinline__ void split_p(
    uint32_t (&p_hi)[F32Tile<D>::BK / 8][4],
    uint32_t (&p_lo)[F32Tile<D>::BK / 8][4],
    const float (&s)[F32Tile<D>::BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < F32Tile<D>::BK / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      split_tf32(s[4 * kk + ((e & 1) << 1 | e >> 1)], p_hi[kk][e],
                 p_lo[kk][e]);
}

// The consumer warpgroups' part of the float32 kernel.  Warpgroup g owns
// query rows 64g .. 64g + 63 of the tile (q_first: the tile's first row
// in S); this thread holds rows rw and rw + 8 of them and, in each group
// of 8 accumulator columns, columns c0 and c0 + 1.  q_gen is the Q tiles'
// generic address (q_s in the shared window).
template <int D>
__device__ __forceinline__ void consumer_f32(
    float* __restrict__ o, uint8_t* q_gen, uint32_t q_s, uint32_t ring,
    uint32_t bar_q, uint32_t full_k, uint32_t full_v, uint32_t empty,
    int warp, int lane, int qrow0, int q_first, int n_tiles, int causal,
    float scale_log2) {
  using TL = F32Tile<D>;
  constexpr int BK = TL::BK, STAGES = TL::STAGES;
  const int g = warp / 4;
  const int rw = 16 * (warp % 4) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const uint32_t q_hi = q_s + g * 64 * 128;
  const uint32_t q_lo = q_hi + TL::QBYTES;
  const auto k_hi = [&](int st) { return ring + st * TL::STAGE; };
  const auto v_hi = [&](int st) { return k_hi(st) + 2 * TL::KBYTES; };

  // split this warpgroup's rows of Q: hi over the loaded value, lo at the
  // same offset of the Q lo tile (64 rows of a panel: 8 KB)
  mbar_wait(bar_q, 0);
  const int tw = threadIdx.x % 128;
#pragma unroll
  for (int p = 0; p < D / 32; ++p)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint8_t* at =
          q_gen + p * TL::QPANEL + g * 64 * 128 + (i * 128 + tw) * 16;
      float4* hi = reinterpret_cast<float4*>(at);
      float4* lo = reinterpret_cast<float4*>(at + TL::QBYTES);
      float4 h, l;
      split4(*hi, h, l);
      *hi = h;
      *lo = l;
    }
  // wgmma reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("bar.sync %0, 128;" ::"r"(1 + g) : "memory");

  // key tiles 0 .. n - 1: when causal, the first warpgroup of two stops
  // below the tile wholly above its rows; a tile needs the mask when its
  // last key passes the warpgroup's first row
  const int first_row = q_first + 64 * g;
  const int n = causal ? n_tiles - (TL::NWG - 1 - g) * 64 / BK : n_tiles;

  // acc: the sum of the tiles so far; t: one tile's P.V
  float acc[D / 2], t[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t p_hi[BK / 8][4], p_lo[BK / 8][4];
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];

  // one tile at a time: S, the softmax and P's split, then P.V; the
  // other warpgroup's products fill the tensor cores meanwhile
  for (int i = 0; i < n; ++i) {
    const int st = i % STAGES, ph = (i / STAGES) & 1;
    mbar_wait(full_k + 8 * st, ph);
    issue_s_f32<D>(s, q_hi, q_lo, k_hi(st), k_hi(st) + TL::KBYTES);
    wgmma_wait<0>();
    fence_regs(s);
    if (causal && i * BK + BK - 1 > first_row)
      softmax_tile<true>(s, m, l, alpha, first_row + rw - i * BK, c0,
                         scale_log2);
    else
      softmax_tile<false>(s, m, l, alpha, rw, c0, scale_log2);
    split_p<D>(p_hi, p_lo, s);
    mbar_wait(full_v + 8 * st, ph);
    issue_pv_f32<D>(t, p_hi, p_lo, v_hi(st), v_hi(st) + TL::VBYTES);
    wgmma_wait<0>();
    fence_regs(t);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    fold<D>(acc, t, alpha);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    inv[r] = 1.f / fmaxf(l[r], 1e-30f);
  }
  float* out0 = o + (int64_t)(qrow0 + 64 * g + rw) * D + c0;
  float* out1 = out0 + 8 * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<float2*>(out0 + 8 * j) =
        make_float2(acc[4 * j] * inv[0], acc[4 * j + 1] * inv[0]);
    *reinterpret_cast<float2*>(out1 + 8 * j) =
        make_float2(acc[4 * j + 2] * inv[1], acc[4 * j + 3] * inv[1]);
  }
}

// q as TMA sees it: (B*H*S, D); k_hi and k_lo: (B*KV*T, D); v_hi and
// v_lo: V^T, (B*KV*D, T); all float32.
template <int D>
__global__ void __launch_bounds__(F32Tile<D>::THREADS, 1)
flash_attention_3xtf32_kernel(const __grid_constant__ CUtensorMap qmap,
                              const __grid_constant__ CUtensorMap khmap,
                              const __grid_constant__ CUtensorMap klmap,
                              const __grid_constant__ CUtensorMap vhmap,
                              const __grid_constant__ CUtensorMap vlmap,
                              float* __restrict__ o, int H, int KVH, int S,
                              int Tk, int causal, float scale_log2) {
  using TL = F32Tile<D>;
  constexpr int BK = TL::BK, STAGES = TL::STAGES;
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles start on a 1024-byte boundary
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t q_s = base;                          // Q hi, then Q lo
  const uint32_t ring = base + 2 * TL::QBYTES;        // + st * STAGE
  const uint32_t bars = ring + STAGES * TL::STAGE;
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
  const int qrow0 = (b * H + h) * S + qt * TL::BQ;   // row of q and out
  const int krow0 = (b * KVH + kvh) * Tk;            // row of k_hi, k_lo
  const int vrow0 = (b * KVH + kvh) * D;             // row of v_hi, v_lo
  // key tiles from 0 up to the last one the tile's last row sees
  const int n_tiles = causal ? (qt + 1) * TL::BQ / BK : Tk / BK;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty + 8 * st, 4 * TL::NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * TL::NWG) {
    // producer: one lane issues every copy
    if (lane == 0) {
      mbar_expect_tx(bar_q, TL::QBYTES);
      for (int p = 0; p < D / 32; ++p)
        tma_load(q_s + p * TL::QPANEL, &qmap, bar_q, 32 * p, qrow0);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + 8 * st, (i / STAGES - 1) & 1);
        const uint32_t kh = ring + st * TL::STAGE;
        const uint32_t kl = kh + TL::KBYTES;
        const uint32_t vh = kh + 2 * TL::KBYTES;
        const uint32_t vl = vh + TL::VBYTES;
        mbar_expect_tx(full_k + 8 * st, 2 * TL::KBYTES);
        for (int p = 0; p < D / 32; ++p) {
          tma_load(kh + p * TL::KPANEL, &khmap, full_k + 8 * st, 32 * p,
                   krow0 + i * BK);
          tma_load(kl + p * TL::KPANEL, &klmap, full_k + 8 * st, 32 * p,
                   krow0 + i * BK);
        }
        mbar_expect_tx(full_v + 8 * st, 2 * TL::VBYTES);
        for (int p = 0; p < BK / 32; ++p) {
          tma_load(vh + p * TL::VPANEL, &vhmap, full_v + 8 * st,
                   i * BK + 32 * p, vrow0);
          tma_load(vl + p * TL::VPANEL, &vlmap, full_v + 8 * st,
                   i * BK + 32 * p, vrow0);
        }
      }
    }
  } else {
    consumer_f32<D>(o, smem_raw + (base - raw), q_s, ring, bar_q, full_k,
                    full_v, empty, warp, lane, qrow0, qt * TL::BQ, n_tiles,
                    causal, scale_log2);
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

// A (rows, cols) float32 tensor as TMA sees it: boxes of box_rows rows of
// one 32-float panel, 128-byte swizzle.
bool encode_f32(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                uint64_t cols, uint64_t rows, uint32_t box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {32, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
             const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The split pre-pass into scratch (four of k's sizes: k_hi, k_lo, v_hi,
// v_lo), then the 3xTF32 kernel.
template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       void* scratch, int B, int H, int KVH, int S, int Tk,
                       int dh, int causal, cudaStream_t stream) {
  using TL = F32Tile<D>;
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return cudaErrorSymbolNotFound;
  if (scratch == nullptr) return cudaErrorInvalidValue;
  const int64_t n = (int64_t)B * KVH * Tk * D;
  float* k_hi = static_cast<float*>(scratch);
  float* k_lo = k_hi + n;
  float* v_hi = k_hi + 2 * n;
  float* v_lo = k_hi + 3 * n;
  const uint64_t krows = (uint64_t)B * KVH * Tk;
  const uint64_t vrows = (uint64_t)B * KVH * D;
  CUtensorMap qmap, khmap, klmap, vhmap, vlmap;
  if (!encode_f32(enc, &qmap, q, D, (uint64_t)B * H * S, TL::BQ)
      || !encode_f32(enc, &khmap, k_hi, D, krows, TL::BK)
      || !encode_f32(enc, &klmap, k_lo, D, krows, TL::BK)
      || !encode_f32(enc, &vhmap, v_hi, Tk, vrows, D)
      || !encode_f32(enc, &vlmap, v_lo, Tk, vrows, D))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_3xtf32_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, TL::SMEM);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launches below are not made
    return err;
  }
  flash_attention_split_kv_kernel<D>
      <<<(Tk / SPLIT_KEYS) * B * KVH, 256, 0, stream>>>(
          static_cast<const float*>(k), static_cast<const float*>(v), k_hi,
          k_lo, v_hi, v_lo, Tk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)dh));
  const dim3 grid(S / TL::BQ, H, B);
  flash_attention_3xtf32_kernel<D><<<grid, TL::THREADS, TL::SMEM, stream>>>(
      qmap, khmap, klmap, vhmap, vlmap, static_cast<float*>(o), H, KVH, S,
      Tk, causal, scale_log2);
  return cudaGetLastError();
}

template <bool BF16>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     void* scratch, int B, int H, int KVH, int S, int Tk,
                     int D, int dh, int causal, cudaStream_t st) {
#define FA_LAUNCH(DIM)                                                     \
  return BF16                                                              \
      ? launch_bf16<DIM>(q, k, v, o, B, H, KVH, S, Tk, dh, causal, st)     \
      : launch_f32<DIM>(q, k, v, o, scratch, B, H, KVH, S, Tk, dh, causal, \
                        st)
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
// the columns past dh are zero).  scratch: float32 only, 4 * B*KV*T*D
// floats for the split K and V (unused in bfloat16, may be null).  The
// wrapper checks shapes, types, divisibility, contiguity and alignment
// before it calls this.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, void* scratch, int B, int H, int KVH,
                               int S, int T, int D, int dh, int dtype,
                               int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dh < 1 || dh > D)
    err = cudaErrorInvalidValue;
  else if (dtype == 0)
    err = launch_d<false>(q, k, v, o, scratch, B, H, KVH, S, T, D, dh,
                          causal, st);
  else if (dtype == 1)
    err = launch_d<true>(q, k, v, o, scratch, B, H, KVH, S, T, D, dh,
                         causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
