// Fused rotated-fold rel-pos attention, forward — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lasr_tpu/ops/rot_attention.py
// `_fwd_kernel` (driven by `_rot_attention_pallas`).  Computes, per (bh, i):
//
//   out[bh,i] = softmax_j[(q_u[bh,i]·k[bh,j] + u[bh,i]·V[j]) / sqrt(dk),
//                         j < kv_len[bh]] @ v[bh]
//   lse[bh,i] = log-sum-exp of the same masked scores (f32)
//
// q_u, k, v: (BH, T, dk); u: (BH, T, M); V: (T, M), one table shared by
// every bh; kv_len: (BH,) int32.  Inputs are all f32 or all bf16; every
// sum accumulates in f32.  A row with kv_len == 0 (batch padding) writes
// zeros and lse = +inf, so exp(s - lse) is 0 for its (masked) keys.
//
// What bounds it on an H100: the score contraction runs over dk+M = 360
// lanes per (i, j) pair at the served shape (dk=40, M=320), so the kernel
// does ~9x more arithmetic than it moves bytes for — f32 it is bound by
// the 67 TFLOP/s non-tensor-core rate, bf16 by memory (inputs halve, the
// arithmetic stays f32 on the CUDA cores).
//
// Design (simple first, no tensor cores yet):
//  - grid (ceil(T/32), BH); 128 threads = 4 warps; each warp owns 8 query
//    rows for the whole kernel: scores, online softmax and P@V of those
//    rows never leave the warp, so the only block-wide barriers are the
//    ones around each key tile's load.  This loop over key tiles replaces
//    the TPU's sequential grid axis.
//  - key tile = 32 keys, one per lane: lane j computes s[r][j] for the
//    warp's 8 rows; the query rows are read from shared memory as float4
//    broadcasts and the concatenated key tile [k ; V] is stored transposed
//    with a padded stride (33) so both the transposing store and the
//    per-lane reads are free of bank conflicts.
//  - the [q_u ; u] query tile (32 x 360 f32, 46 KB) and the key tile
//    (47 KB) exceed the 48 KB static limit: dynamic shared memory, raised
//    with cudaFuncSetAttribute.
//  - tiles past ceil(kv_len / 32) are never loaded, so the work follows
//    the data; every loaded tile holds key k0 < kv_len, so the running max
//    is finite after the first tile.
//  - P is rounded to the input type before P@V (what the TPU kernel does
//    with prob.astype(v.dtype)); l sums the unrounded P.
//  - the TPU's 128-lane padding of dk and M is a layout artefact of the
//    MXU and is not carried over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;    // query rows per block
constexpr int BK = 32;    // keys per tile: one per lane
constexpr int ROWS = 8;   // query rows per warp
constexpr int THREADS = 128;
constexpr int KS = BK + 1;  // padded stride of the transposed key tile
constexpr int DK_MAX = 64;  // each lane owns output columns lane, lane+32

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
    rot_attention_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ u,
                             const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ vt,
                             const int* __restrict__ kv_len,
                             T* __restrict__ out, float* __restrict__ lse,
                             int T_, int dk, int M, int E4, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;             // [BQ][E4]   rows of [q_u ; u]
  float* sK = sQ + BQ * E4;     // [E4][KS]   [k ; V] transposed
  float* sV = sK + E4 * KS;     // [BK][dk]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int E = dk + M;
  const size_t base = (size_t)bh * T_;
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

  for (int idx = tid; idx < BQ * E4; idx += THREADS) {
    const int r = idx / E4, e = idx - r * E4, row = q0 + r;
    float x = 0.f;
    if (row < T_ && e < E)
      x = e < dk ? to_f32(qu[(base + row) * dk + e])
                 : to_f32(u[(base + row) * M + (e - dk)]);
    sQ[idx] = x;
  }

  float m[ROWS], l[ROWS], acc0[ROWS], acc1[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
    acc0[r] = 0.f;
    acc1[r] = 0.f;
  }
  const float* qrows = sQ + warp * ROWS * E4;
  const int ntiles = (kvl + BK - 1) / BK;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < BK * E4; idx += THREADS) {
      const int j = idx / E4, e = idx - j * E4, key = k0 + j;
      float x = 0.f;
      if (key < T_ && e < E)
        x = e < dk ? to_f32(k[(base + key) * dk + e])
                   : to_f32(vt[(size_t)key * M + (e - dk)]);
      sK[e * KS + j] = x;
    }
    for (int idx = tid; idx < BK * dk; idx += THREADS) {
      const int j = idx / dk, key = k0 + j;
      sV[idx] = key < T_ ? to_f32(v[(base + key) * dk + (idx - j * dk)]) : 0.f;
    }
    __syncthreads();

    float s[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r] = 0.f;
    for (int e = 0; e < E4; e += 4) {
      const float k0v = sK[(e + 0) * KS + lane];
      const float k1v = sK[(e + 1) * KS + lane];
      const float k2v = sK[(e + 2) * KS + lane];
      const float k3v = sK[(e + 3) * KS + lane];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 q = *reinterpret_cast<const float4*>(qrows + r * E4 + e);
        s[r] = fmaf(q.x, k0v, s[r]);
        s[r] = fmaf(q.y, k1v, s[r]);
        s[r] = fmaf(q.z, k2v, s[r]);
        s[r] = fmaf(q.w, k3v, s[r]);
      }
    }

    const bool valid = k0 + lane < kvl;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float x = valid ? s[r] * scale : -INFINITY;
      const float m_new = fmaxf(m[r], warp_max(x));
      const float alpha = expf(m[r] - m_new);
      const float p = valid ? expf(x - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(p);
      m[r] = m_new;
      const float pr = to_f32(from_f32<T>(p));
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
int launch(const void* qu, const void* u, const void* k, const void* v,
           const void* vt, const int* kv_len, void* out, float* lse, int BH,
           int T_, int dk, int M, cudaStream_t stream) {
  const int E4 = (dk + M + 3) / 4 * 4;
  const size_t smem = sizeof(float) * ((size_t)BQ * E4 + (size_t)E4 * KS +
                                       (size_t)BK * dk);
  cudaError_t err = cudaFuncSetAttribute(
      rot_attention_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_ + BQ - 1) / BQ, BH);
  rot_attention_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(u),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(vt), kv_len, static_cast<T*>(out), lse, T_, dk, M,
      E4, 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.
extern "C" int lasr_rot_attention_fwd(const void* qu, const void* u,
                                      const void* k, const void* v,
                                      const void* vt, const void* kv_len,
                                      void* out, void* lse, int BH, int T_,
                                      int dk, int M, int is_bf16,
                                      void* stream) {
  if (dk < 1 || dk > DK_MAX || M < 0 || T_ < 1 || BH < 1)
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(qu, u, k, v, vt, kl, out, ls, BH, T_, dk, M,
                                 st);
  return launch<float>(qu, u, k, v, vt, kl, out, ls, BH, T_, dk, M, st);
}
