// Blocked causal or full attention with an online softmax (flash
// attention, forward), written for Hopper (sm_90a).
//
// Replaces: repro/kernels/flash_attention.py::_attn_kernel (the Pallas TPU
// kernel, entry flash_attention_pallas).  Its plain PyTorch version is
// repro_torch/kernels/ref.py::attention_ref; the kernel stays within
// 1e-5 of it in float32 and 5e-2 in bfloat16.
//
// What it computes: q (B, H, S, D), k and v (B, KV, T, D), all contiguous,
// float32 or bfloat16; out (B, H, S, D) in q's dtype.  Head h reads K/V
// head h / (H / KV) directly, so grouped-query attention needs no repeated
// copy of K and V.  Logits are (q / sqrt(D)) . k in float32; with causal
// set, key t is visible to query s when t <= s (S == T).  D is 32, 64 or
// 128; S and T are multiples of 128.
//
// What bounds it: operations.  At the tinyllama-1.1b prefill shape
// (B 4, H 32, KV 4, S = T = 2048, D 64, bfloat16, causal) the two products
// are 6.87e10 FLOP, 69 us at the H100's 989 TFLOP/s of bf16 tensor-core
// work, against 75 MB of q, k, v and out, 23 us at 3.35 TB/s.  This first
// kernel runs on the CUDA cores in float32 (67 TFLOP/s at best, about 1 ms
// for that work), so it sits far from the bound: wgmma and TMA are later
// work.
//
// Design: one CTA per (128-row query tile, head, batch), heaviest causal
// tiles first.  Each query row belongs to D/32 neighbouring threads of a
// warp; a thread keeps 32 of the row's dims of q (pre-scaled, float32) and
// of the float32 accumulator in registers, in float4 granules r, r + R,
// ... so that the R threads of a row read distinct banks.  K/V stream
// through shared memory in 64-row tiles (converted to float32 on load) up
// to the causal diagonal.  Scores are taken 16 keys at a time: partial
// dot products are summed across the row's threads with shuffles, then the
// running max, denominator and accumulator are updated once per 16 keys.
// Masked logits are -1e30, never -inf, so no arithmetic yields NaN; the
// first 16 keys hold key 0, which every causal row sees, so the running max
// is finite after the first update.  The output is acc / max(l, 1e-30).
// Offsets are 64-bit.
//
// The C entry point takes plain pointers and the stream and returns
// cudaGetLastError(), so the Python wrapper can bind it with ctypes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;  // query rows per CTA
constexpr int BK = 64;   // key/value rows per shared-memory tile
constexpr int G = 16;    // keys per online-softmax update
constexpr int DPT = 32;  // head dims held by one thread
constexpr float NEG = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 a = p2[0];
  const __nv_bfloat162 b = p2[1];
  return make_float4(__bfloat162float(a.x), __bfloat162float(a.y),
                     __bfloat162float(b.x), __bfloat162float(b.y));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(x.x, x.y);
  p2[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T, int D>
__global__ void __launch_bounds__(BQ * D / DPT)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int H,
                       int KVH, int S, int Tk, int causal, float scale) {
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int KVH, int S, int Tk, int causal,
                   cudaStream_t stream) {
  const int smem = 2 * BK * D * (int)sizeof(float);
  // above 48 KB (D = 128) dynamic shared memory must be asked for
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it: the launch below is not made
    return err;
  }
  const float scale = (float)(1.0 / sqrt((double)D));
  const dim3 grid(S / BQ, H, B);
  flash_attention_kernel<T, D><<<grid, BQ * D / DPT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), H, KVH, S, Tk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KVH, int S, int Tk, int D, int causal,
                     cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, KVH, S, Tk, causal, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, KVH, S, Tk, causal, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, KVH, S, Tk, causal, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  The wrapper checks shapes, types,
// divisibility and contiguity before it calls this.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int KVH, int S, int T,
                               int D, int dtype, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_d<float>(q, k, v, o, B, H, KVH, S, T, D, causal, st);
  else if (dtype == 1)
    err = launch_d<__nv_bfloat16>(q, k, v, o, B, H, KVH, S, T, D, causal,
                                  st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
