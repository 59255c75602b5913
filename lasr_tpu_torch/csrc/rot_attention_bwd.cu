// Fused rotated-fold rel-pos attention, backward — CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel lasr_tpu/ops/rot_attention.py
// `_bwd_kernel` (driven by `_rot_attention_pallas_bwd`).  With the
// forward's row log-sum-exp `lse` and output `out`, per (bh, i, j < kv_len):
//
//   P[i,j]  = exp((q_u[i]·k[j] + u[i]·V[j]) / sqrt(dk) - lse[i])
//   dz[i,j] = P[i,j] * (dout[i]·v[j] - delta[i]) / sqrt(dk),
//             delta[i] = dout[i]·out[i]
//   dv[j]   = sum_i P[i,j] dout[i]       dk[j] = sum_i dz[i,j] q_u[i]
//   dq_u[i] = sum_j dz[i,j] k[j]         du[i] = sum_j dz[i,j] V[j]
//
// V (the static swapped-sinusoid table) gets no gradient.  Inputs are all
// f32 or all bf16; every sum accumulates in f32; gradients are written in
// the input type.  A row with kv_len == 0 has lse = +inf, so P and every
// gradient it feeds are exact zeros.
//
// What bounds it on an H100: like the forward, each (i, j) pair recomputes
// a 360-lane score (dk + M at dk=40, M=320) and adds a 320-lane du
// product, ~4M + 10dk = 1680 FLOP per pair against a few hundred bytes
// per row: bound by the 67 TFLOP/s non-tensor-core f32 rate.
//
// Design (simple first, no tensor cores, no atomics, deterministic):
//  - the TPU kernel walks query tiles in order and sums dk/dv into one
//    output block across grid steps; blocks here run in no order, so the
//    work is split in two passes, each owning what it writes:
//      pass 1, grid (ceil(T/32), BH): one block per key tile; it keeps
//        [k ; V ; v] of its 32 keys in shared memory, walks every query
//        tile, and sums dk and dv in registers;
//      pass 2, grid (ceil(T/32), BH): one block per query tile; it walks
//        the key tiles below kv_len and sums [dq_u ; du] (32 x 360) in
//        shared memory.
//    A first tiny kernel writes delta[bh, i].
//  - scores use the forward's layout: 4 warps x 8 query rows, one key per
//    lane, query rows as float4 broadcasts, the key tile transposed with
//    a padded stride of 33 (conflict-free); P and dz of a tile pair go
//    through shared memory to the accumulation layout.
//  - the 360-lane tiles exceed the 48 KB static limit: dynamic shared
//    memory raised with cudaFuncSetAttribute (113 KB pass 1, 155 KB pass 2
//    at dk=40, M=320).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;    // query rows per tile
constexpr int BK = 32;    // keys per tile: one per lane
constexpr int ROWS = 8;   // query rows per warp
constexpr int THREADS = 128;
constexpr int KS = BK + 1;  // padded stride of the transposed key tile
constexpr int PS = BK + 1;  // padded stride of the P / dz tiles
constexpr int DK_MAX = 64;
// thread t owns column t % 32 and the d = t / 32 + DG * c of that column
constexpr int DG = THREADS / 32;
constexpr int DC = DK_MAX / DG;      // accumulators per output

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// delta[row] = dout[row]·out[row]; one warp per row.
template <typename T>
__global__ void rot_bwd_delta_kernel(const T* __restrict__ out,
                                     const T* __restrict__ dout,
                                     float* __restrict__ delta, int rows,
                                     int dk) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < dk; d += 32)
    s = fmaf(to_f32(out[(size_t)row * dk + d]),
             to_f32(dout[(size_t)row * dk + d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

struct Dims {
  int T, dk, M, E, E4, D4;
  float scale;
};

// Rows q0.. of [q_u ; u] into sQ[BQ][E4], of dout into sDO[BQ][D4], and
// their lse / delta (rows past T: lse = +inf, so their P is 0).
template <typename T>
__device__ void load_query_tile(const T* qu, const T* u, const T* dout,
                                const float* lse, const float* delta,
                                size_t base, int q0, const Dims& D, float* sQ,
                                float* sDO, float* sL, float* sD) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BQ * D.E4; idx += THREADS) {
    const int r = idx / D.E4, e = idx - r * D.E4, row = q0 + r;
    float x = 0.f;
    if (row < D.T && e < D.E)
      x = e < D.dk ? to_f32(qu[(base + row) * D.dk + e])
                   : to_f32(u[(base + row) * D.M + (e - D.dk)]);
    sQ[idx] = x;
  }
  for (int idx = tid; idx < BQ * D.D4; idx += THREADS) {
    const int r = idx / D.D4, d = idx - r * D.D4, row = q0 + r;
    sDO[idx] = (row < D.T && d < D.dk) ? to_f32(dout[(base + row) * D.dk + d])
                                       : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    const int row = q0 + r;
    sL[r] = row < D.T ? lse[base + row] : INFINITY;
    sD[r] = row < D.T ? delta[base + row] : 0.f;
  }
}

// Keys k0.. as the transposed tile sKt[E4 + D4][KS]: rows e < dk are k,
// dk <= e < E the table V, E <= e < E4 zero, E4 + d the values v.
template <typename T>
__device__ void load_key_tile(const T* k, const T* v, const T* vt,
                              size_t base, int k0, const Dims& D, float* sKt) {
  const int W = D.E4 + D.D4;
  for (int idx = threadIdx.x; idx < BK * W; idx += THREADS) {
    const int j = idx / W, e = idx - j * W, key = k0 + j;
    float x = 0.f;
    if (key < D.T) {
      if (e < D.dk)
        x = to_f32(k[(base + key) * D.dk + e]);
      else if (e < D.E)
        x = to_f32(vt[(size_t)key * D.M + (e - D.dk)]);
      else if (e >= D.E4 && e - D.E4 < D.dk)
        x = to_f32(v[(base + key) * D.dk + (e - D.E4)]);
    }
    sKt[e * KS + j] = x;
  }
}

// For the warp's 8 query rows and the lane's key: P and dz of the tile
// pair, written to sP / sDZ[BQ][PS] (sP may be null).
__device__ void tile_pair(const float* sQ, const float* sDO, const float* sL,
                          const float* sD, const float* sKt, bool key_valid,
                          const Dims& D, float* sP, float* sDZ) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float* qrows = sQ + warp * ROWS * D.E4;
  float s[ROWS], dp[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
  for (int e = 0; e < D.E4; e += 4) {
    const float k0v = sKt[(e + 0) * KS + lane];
    const float k1v = sKt[(e + 1) * KS + lane];
    const float k2v = sKt[(e + 2) * KS + lane];
    const float k3v = sKt[(e + 3) * KS + lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 q = *reinterpret_cast<const float4*>(qrows + r * D.E4 + e);
      s[r] = fmaf(q.x, k0v, s[r]);
      s[r] = fmaf(q.y, k1v, s[r]);
      s[r] = fmaf(q.z, k2v, s[r]);
      s[r] = fmaf(q.w, k3v, s[r]);
    }
  }
  const float* vrows = sKt + D.E4 * KS;
  for (int d = 0; d < D.D4; d += 4) {
    const float v0 = vrows[(d + 0) * KS + lane];
    const float v1 = vrows[(d + 1) * KS + lane];
    const float v2 = vrows[(d + 2) * KS + lane];
    const float v3 = vrows[(d + 3) * KS + lane];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 g = *reinterpret_cast<const float4*>(
          sDO + (warp * ROWS + r) * D.D4 + d);
      dp[r] = fmaf(g.x, v0, dp[r]);
      dp[r] = fmaf(g.y, v1, dp[r]);
      dp[r] = fmaf(g.z, v2, dp[r]);
      dp[r] = fmaf(g.w, v3, dp[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int ii = warp * ROWS + r;
    const float p = key_valid ? expf(s[r] * D.scale - sL[ii]) : 0.f;
    if (sP) sP[ii * PS + lane] = p;
    sDZ[ii * PS + lane] = p * (dp[r] - sD[ii]) * D.scale;
  }
}

// Pass 1: one block per (key tile, bh); dk and dv of its 32 keys.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rot_bwd_dkdv_kernel(const T* __restrict__ qu, const T* __restrict__ u,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ vt,
                        const int* __restrict__ kv_len,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout,
                        const float* __restrict__ delta, T* __restrict__ dk_,
                        T* __restrict__ dv_, Dims D) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // [BQ][E4]
  float* sDO = sQ + BQ * D.E4;            // [BQ][D4]
  float* sKt = sDO + BQ * D.D4;           // [E4 + D4][KS]
  float* sP = sKt + (D.E4 + D.D4) * KS;   // [BQ][PS]
  float* sDZ = sP + BQ * PS;              // [BQ][PS]
  float* sL = sDZ + BQ * PS;              // [BQ]
  float* sD = sL + BQ;                    // [BQ]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int lane = threadIdx.x & 31;
  const int g = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const int kvl = min(kv_len[bh], D.T);

  float adv[DC], adk[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) adv[c] = adk[c] = 0.f;

  if (k0 < kvl) {
    load_key_tile(k, v, vt, base, k0, D, sKt);
    const bool key_valid = k0 + lane < kvl;
    for (int q0 = 0; q0 < D.T; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_query_tile(qu, u, dout, lse, delta, base, q0, D, sQ, sDO, sL, sD);
      __syncthreads();
      tile_pair(sQ, sDO, sL, sD, sKt, key_valid, D, sP, sDZ);
      __syncthreads();
      for (int ii = 0; ii < BQ; ++ii) {
        const float p = sP[ii * PS + lane];
        const float z = sDZ[ii * PS + lane];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = g + DG * c;
          if (d < D.dk) {
            adv[c] = fmaf(p, sDO[ii * D.D4 + d], adv[c]);
            adk[c] = fmaf(z, sQ[ii * D.E4 + d], adk[c]);
          }
        }
      }
    }
  }
  const int key = k0 + lane;
  if (key < D.T) {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = g + DG * c;
      if (d < D.dk) {
        dv_[(base + key) * D.dk + d] = from_f32<T>(adv[c]);
        dk_[(base + key) * D.dk + d] = from_f32<T>(adk[c]);
      }
    }
  }
}

// Pass 2: one block per (query tile, bh); dq_u and du of its 32 rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rot_bwd_dq_kernel(const T* __restrict__ qu, const T* __restrict__ u,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ vt,
                      const int* __restrict__ kv_len,
                      const float* __restrict__ lse,
                      const T* __restrict__ dout,
                      const float* __restrict__ delta, T* __restrict__ dqu_,
                      T* __restrict__ du_, Dims D) {
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // [BQ][E4]
  float* sDO = sQ + BQ * D.E4;            // [BQ][D4]
  float* sAcc = sDO + BQ * D.D4;          // [BQ][E4]  [dq_u ; du]
  float* sKt = sAcc + BQ * D.E4;          // [E4 + D4][KS]
  float* sDZ = sKt + (D.E4 + D.D4) * KS;  // [BQ][PS]
  float* sL = sDZ + BQ * PS;
  float* sD = sL + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const size_t base = (size_t)bh * D.T;
  const int kvl = min(kv_len[bh], D.T);

  load_query_tile(qu, u, dout, lse, delta, base, q0, D, sQ, sDO, sL, sD);
  for (int idx = tid; idx < BQ * D.E4; idx += THREADS) sAcc[idx] = 0.f;

  for (int k0 = 0; k0 < kvl; k0 += BK) {
    __syncthreads();
    load_key_tile(k, v, vt, base, k0, D, sKt);
    __syncthreads();
    tile_pair(sQ, sDO, sL, sD, sKt, k0 + lane < kvl, D, nullptr, sDZ);
    __syncthreads();
    // thread t owns columns e = t, t + 128, ... of all 32 rows
    for (int e = tid; e < D.E; e += THREADS) {
      float kv[BK];
#pragma unroll
      for (int j = 0; j < BK; ++j) kv[j] = sKt[e * KS + j];
      for (int ii = 0; ii < BQ; ++ii) {
        float a = sAcc[ii * D.E4 + e];
#pragma unroll
        for (int j = 0; j < BK; ++j) a = fmaf(sDZ[ii * PS + j], kv[j], a);
        sAcc[ii * D.E4 + e] = a;
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < BQ * D.E; idx += THREADS) {
    const int r = idx / D.E, e = idx - r * D.E, row = q0 + r;
    if (row >= D.T) continue;
    const float a = sAcc[r * D.E4 + e];
    if (e < D.dk)
      dqu_[(base + row) * D.dk + e] = from_f32<T>(a);
    else
      du_[(base + row) * D.M + (e - D.dk)] = from_f32<T>(a);
  }
}

template <typename T>
int launch(const void* qu, const void* u, const void* k, const void* v,
           const void* vt, const int* kv_len, const void* out,
           const float* lse, const void* dout, float* delta, void* dqu,
           void* du, void* dk_, void* dv_, int BH, int T_, int dk, int M,
           cudaStream_t stream) {
  Dims D;
  D.T = T_;
  D.dk = dk;
  D.M = M;
  D.E = dk + M;
  D.E4 = (dk + M + 3) / 4 * 4;
  D.D4 = (dk + 3) / 4 * 4;
  D.scale = 1.0f / sqrtf((float)dk);
  const T* q = static_cast<const T*>(qu);
  const T* uu = static_cast<const T*>(u);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* tt = static_cast<const T*>(vt);
  const T* g = static_cast<const T*>(dout);

  const int rows = BH * T_;
  rot_bwd_delta_kernel<T><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const T*>(out), g, delta, rows, dk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t kt = (size_t)(D.E4 + D.D4) * KS;
  const size_t smem1 = sizeof(float) * ((size_t)BQ * D.E4 + (size_t)BQ * D.D4 +
                                        kt + 2 * (size_t)BQ * PS + 2 * BQ);
  const size_t smem2 = sizeof(float) * (2 * (size_t)BQ * D.E4 +
                                        (size_t)BQ * D.D4 + kt +
                                        (size_t)BQ * PS + 2 * BQ);
  err = cudaFuncSetAttribute(rot_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rot_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_ + BQ - 1) / BQ, BH);
  rot_bwd_dkdv_kernel<T><<<grid, THREADS, smem1, stream>>>(
      q, uu, kk, vv, tt, kv_len, lse, g, delta, static_cast<T*>(dk_),
      static_cast<T*>(dv_), D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rot_bwd_dq_kernel<T><<<grid, THREADS, smem2, stream>>>(
      q, uu, kk, vv, tt, kv_len, lse, g, delta, static_cast<T*>(dqu),
      static_cast<T*>(du), D);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when every launch was accepted.  `delta`
// is f32 scratch of BH*T entries.
extern "C" int lasr_rot_attention_bwd(
    const void* qu, const void* u, const void* k, const void* v,
    const void* vt, const void* kv_len, const void* out, const void* lse,
    const void* dout, void* delta, void* dqu, void* du, void* dk, void* dv,
    int BH, int T_, int dk_dim, int M, int is_bf16, void* stream) {
  if (dk_dim < 1 || dk_dim > DK_MAX || M < 0 || T_ < 1 || BH < 1)
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(qu, u, k, v, vt, kl, out, ls, dout, dl, dqu,
                                 du, dk, dv, BH, T_, dk_dim, M, st);
  return launch<float>(qu, u, k, v, vt, kl, out, ls, dout, dl, dqu, du, dk,
                       dv, BH, T_, dk_dim, M, st);
}
