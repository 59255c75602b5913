// Fused relative-position (Transformer-XL) attention, forward — CUDA C++
// for sm_90a.
//
// Replaces the Pallas TPU kernel lasr_tpu/ops/rel_attention.py
// `_fwd_kernel` (driven by `_rel_attention_pallas`).  Computes, per (bh, i):
//
//   out[bh,i] = softmax_j[(q_u[bh,i]·k[bh,j] + q_v[bh,i]·p[h, T-1-i+j])
//                         / sqrt(dk), j < kv_len[bh]] @ v[bh]
//   lse[bh,i] = log-sum-exp of the same masked scores (f32)
//
// q_u, q_v, k, v: (BH, T, dk) with bh = b*H + h; p: (H, 2T-1, dk), the
// per-head projected positional table shared by the batch (row T-1 is
// distance 0); kv_len: (BH,) int32.  Inputs are all f32 or all bf16; sums
// accumulate in f32.  A row with kv_len == 0 writes zeros and lse = +inf.
//
// What bounds it on an H100: per (i, j) pair it does 3*dk = 120 FMAs
// (content score, position score, P@V) against inputs of ~5*dk values
// per row, so at the served shape (T=248, dk=40) it is bound by the
// non-tensor-core f32 rate in f32 and by memory in bf16.
//
// Design (simple first, no tensor cores yet):
//  - grid (ceil(T/32), BH); 4 warps x 8 query rows; each warp keeps its
//    rows' scores, online softmax and P@V to itself; a loop over key
//    tiles of 32 (one key per lane) replaces the TPU's sequential grid.
//  - the rel-shift is a plain index remap: for the tile pair (q0, k0) the
//    block stages the window p[r0 .. r0+BQ+BK-2], r0 = T-1-q0-(BQ-1)+k0,
//    in shared memory (rows outside [0, 2T-2] are zero; they only ever
//    meet padded rows or keys), and lane jj of query ii reads window row
//    (BQ-1)-ii+jj directly.  That is the diagonal read of the TPU kernel's
//    (BQ, BQ+BK) window product without computing the unused half of the
//    window: the barrel shifter of rolls there exists only because Mosaic
//    cannot lower the skew reshape.
//  - key and window rows are stored with an odd stride so the per-lane
//    row reads are free of bank conflicts; query rows are float4
//    broadcasts.
//  - tiles past ceil(kv_len / 32) are skipped; P is rounded to the input
//    type before P@V as in the TPU kernel; the TPU's 128-lane dk padding
//    and its p_off alignment offset are layout artefacts, not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int ROWS = 8;
constexpr int THREADS = 128;
constexpr int WIN = BQ + BK - 1;  // window rows per tile pair
constexpr int DK_MAX = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    rel_attention_fwd_kernel(const T* __restrict__ qu,
                             const T* __restrict__ qv,
                             const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ p,
                             const int* __restrict__ kv_len,
                             T* __restrict__ out, float* __restrict__ lse,
                             int T_, int dk, int H, int D4, float scale) {
  extern __shared__ __align__(16) float smem[];
  const int RS = D4 + 1;          // odd stride of key / window rows
  float* sQu = smem;              // [BQ][D4]
  float* sQv = sQu + BQ * D4;     // [BQ][D4]
  float* sK = sQv + BQ * D4;      // [BK][RS]
  float* sP = sK + BK * RS;       // [WIN][RS]
  float* sV = sP + WIN * RS;      // [BK][dk]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t base = (size_t)bh * T_;
  const int P = 2 * T_ - 1;
  const T* ph = p + (size_t)(bh % H) * P * dk;
  const int kvl = min(kv_len[bh], T_);
  const bool d0 = lane < dk;
  const bool d1 = lane + 32 < dk;

  if (kvl <= 0) {
    for (int r = 0; r < ROWS; ++r) {
      const int row = q0 + warp * ROWS + r;
      if (row >= T_) break;
      if (d0) out[(base + row) * dk + lane] = from_f32<T>(0.f);
      if (d1) out[(base + row) * dk + lane + 32] = from_f32<T>(0.f);
      if (lane == 0) lse[base + row] = INFINITY;
    }
    return;
  }

  for (int idx = tid; idx < BQ * D4; idx += THREADS) {
    const int r = idx / D4, e = idx - r * D4, row = q0 + r;
    const bool in = row < T_ && e < dk;
    sQu[idx] = in ? to_f32(qu[(base + row) * dk + e]) : 0.f;
    sQv[idx] = in ? to_f32(qv[(base + row) * dk + e]) : 0.f;
  }

  float m[ROWS], l[ROWS], acc0[ROWS], acc1[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc0[r] = 0.f;
    acc1[r] = 0.f;
  }
  const int ntiles = (kvl + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const int r0 = (T_ - 1) - q0 - (BQ - 1) + k0;
    __syncthreads();
    for (int idx = tid; idx < BK * D4; idx += THREADS) {
      const int j = idx / D4, e = idx - j * D4, key = k0 + j;
      sK[j * RS + e] =
          (key < T_ && e < dk) ? to_f32(k[(base + key) * dk + e]) : 0.f;
    }
    for (int idx = tid; idx < WIN * D4; idx += THREADS) {
      const int w = idx / D4, e = idx - w * D4, rel = r0 + w;
      sP[w * RS + e] = (rel >= 0 && rel < P && e < dk)
                           ? to_f32(ph[(size_t)rel * dk + e])
                           : 0.f;
    }
    for (int idx = tid; idx < BK * dk; idx += THREADS) {
      const int j = idx / dk, key = k0 + j;
      sV[idx] = key < T_ ? to_f32(v[(base + key) * dk + (idx - j * dk)]) : 0.f;
    }
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    const float* krow = sK + lane * RS;
    for (int e = 0; e < D4; e += 4) {
      const float k0v = krow[e], k1v = krow[e + 1];
      const float k2v = krow[e + 2], k3v = krow[e + 3];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int ii = warp * ROWS + r;
        const float4 a = *reinterpret_cast<const float4*>(sQu + ii * D4 + e);
        const float4 b = *reinterpret_cast<const float4*>(sQv + ii * D4 + e);
        const float* prow = sP + ((BQ - 1) - ii + lane) * RS + e;
        float x = s[r];
        x = fmaf(a.x, k0v, x);
        x = fmaf(a.y, k1v, x);
        x = fmaf(a.z, k2v, x);
        x = fmaf(a.w, k3v, x);
        x = fmaf(b.x, prow[0], x);
        x = fmaf(b.y, prow[1], x);
        x = fmaf(b.z, prow[2], x);
        x = fmaf(b.w, prow[3], x);
        s[r] = x;
      }
    }

    const bool valid = k0 + lane < kvl;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float x = valid ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float pr_ = valid ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(pr_);
      m[r] = m_new;
      const float pr = to_f32(from_f32<T>(pr_));
      float a0 = acc0[r] * alpha, a1 = acc1[r] * alpha;
      for (int j = 0; j < BK; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
        if (d0) a0 = fmaf(pj, sV[j * dk + lane], a0);
        if (d1) a1 = fmaf(pj, sV[j * dk + lane + 32], a1);
      }
      acc0[r] = a0;
      acc1[r] = a1;
    }
  }

#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = q0 + warp * ROWS + r;
    if (row < T_) {
      const float inv = 1.f / l[r];
      if (d0) out[(base + row) * dk + lane] = from_f32<T>(acc0[r] * inv);
      if (d1) out[(base + row) * dk + lane + 32] = from_f32<T>(acc1[r] * inv);
      if (lane == 0) lse[base + row] = m[r] + logf(l[r]);
    }
  }
}

template <typename T>
int launch(const void* qu, const void* qv, const void* k, const void* v,
           const void* p, const int* kv_len, void* out, float* lse, int BH,
           int T_, int dk, int H, cudaStream_t stream) {
  const int D4 = (dk + 3) / 4 * 4;
  const int RS = D4 + 1;
  const size_t smem =
      sizeof(float) * ((size_t)2 * BQ * D4 + (size_t)(BK + WIN) * RS +
                       (size_t)BK * dk);
  cudaError_t err = cudaFuncSetAttribute(
      rel_attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_ + BQ - 1) / BQ, BH);
  rel_attention_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(p), kv_len, static_cast<T*>(out), lse, T_, dk, H,
      D4, 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int lasr_rel_attention_fwd(const void* qu, const void* qv,
                                      const void* k, const void* v,
                                      const void* p, const void* kv_len,
                                      void* out, void* lse, int BH, int T_,
                                      int dk, int H, int is_bf16,
                                      void* stream) {
  if (dk < 1 || dk > DK_MAX || H < 1 || BH % H != 0 || T_ < 1 || BH < 1)
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(qu, qv, k, v, p, kl, out, ls, BH, T_, dk, H,
                                 st);
  return launch<float>(qu, qv, k, v, p, kl, out, ls, BH, T_, dk, H, st);
}
