// Fused relative-position (Transformer-XL) attention, backward — CUDA C++
// for sm_90a.
//
// Replaces the Pallas TPU kernel lasr_tpu/ops/rel_attention.py
// `_bwd_kernel` (driven by `_rel_attention_pallas_bwd`).  With the
// forward's row log-sum-exp `lse` and output `out`, per (bh = b*H + h, i,
// j < kv_len), r(i, j) = T-1-i+j:
//
//   P[i,j]  = exp((q_u[i]·k[j] + q_v[i]·p[h, r]) / sqrt(dk) - lse[i])
//   dz[i,j] = P[i,j] * (dout[i]·v[j] - delta[i]) / sqrt(dk),
//             delta[i] = dout[i]·out[i]
//   dv[j]   = sum_i P[i,j] dout[i]       dk[j]   = sum_i dz[i,j] q_u[i]
//   dq_u[i] = sum_j dz[i,j] k[j]         dq_v[i] = sum_j dz[i,j] p[h, r]
//   dp[h,r] = sum_b sum_{i-j = T-1-r} dz[b,h,i,j] q_v[b,h,i]
//
// Inputs are all f32 or all bf16; sums accumulate in f32; gradients are
// written in the input type.  A row with kv_len == 0 has lse = +inf, so
// its P and every gradient it feeds are exact zeros.
//
// What bounds it on an H100: per (i, j) pair the backward does ~16 dk
// FLOP (score recompute 4dk, dout·v 2dk, five dk-wide products) against
// ~10 dk values of input and output per row: bound by the non-tensor-core
// f32 rate in f32, close to the memory line in bf16.
//
// Design (simple first, no tensor cores, no atomics, deterministic):
//  - the TPU kernel sums dk, dv and dp across sequential grid steps; here
//    each pass owns what it writes:
//      pass 1, grid (ceil(T/32), BH): a block per key tile walks every
//        query tile and sums dk and dv in registers;
//      pass 2, grid (ceil(T/32), BH): a block per query tile walks the key
//        tiles below kv_len and sums dq_u and dq_v in registers;
//      pass 3, grid (ceil((2T-1)/32), H, S): a block per (32 relative
//        positions, head, batch slice) walks its slice of the batch and
//        every query tile; the 32 lanes are 32 diagonals r, so dp[h, r] is
//        a sum down the lane's own diagonal.  S partial sums, one per batch
//        slice, are added in a fixed order by a last small kernel (the TPU
//        package sums per-bh partials outside its kernel).
//    A first tiny kernel writes delta[bh, i].
//  - the rel-shift is an index remap, as in the forward: for the tile pair
//    (q0, k0) the window p[r0 .. r0+62], r0 = T-1-q0-31+k0, sits in shared
//    memory (rows outside [0, 2T-2] zero) and query ii / key jj reads
//    window row 31-ii+jj; pass 3 stages the key window k[j0 .. j0+62] the
//    same way, and query ii / diagonal rr reads key row ii+rr.  The
//    barrel-shifter rolls and the p_off / Pp padding of the TPU kernel are
//    Mosaic layout devices and are not carried over.
//  - row reads of key and window tiles use an odd stride (conflict-free);
//    query rows are float4 broadcasts; P and dz of a tile pair pass
//    through shared memory to the accumulation layout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 32;
constexpr int BK = 32;
constexpr int ROWS = 8;
constexpr int THREADS = 128;
constexpr int WIN = BQ + BK - 1;  // window rows per tile pair
constexpr int PS = BK + 1;        // padded stride of the P / dz tiles
constexpr int DK_MAX = 64;
// thread t owns column t % 32 and the d = t / 32 + DG * c of that column
constexpr int DG = THREADS / 32;
constexpr int DC = DK_MAX / DG;

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

template <typename T>
__global__ void rel_bwd_delta_kernel(const T* __restrict__ out,
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
  int T, dk, H, P, D4, RS;
  float scale;
};

// Query rows q0.. of q_u, q_v, dout into [BQ][D4] tiles, with lse / delta
// (rows past T: lse = +inf, so their P is 0).
template <typename T>
__device__ void load_query_tile(const T* qu, const T* qv, const T* dout,
                                const float* lse, const float* delta,
                                size_t base, int q0, const Dims& D, float* sQu,
                                float* sQv, float* sDO, float* sL, float* sD) {
  const int tid = threadIdx.x;
  for (int idx = tid; idx < BQ * D.D4; idx += THREADS) {
    const int r = idx / D.D4, e = idx - r * D.D4, row = q0 + r;
    const bool in = row < D.T && e < D.dk;
    const size_t off = (base + row) * D.dk + e;
    sQu[idx] = in ? to_f32(qu[off]) : 0.f;
    sQv[idx] = in ? to_f32(qv[off]) : 0.f;
    sDO[idx] = in ? to_f32(dout[off]) : 0.f;
  }
  for (int r = tid; r < BQ; r += THREADS) {
    const int row = q0 + r;
    sL[r] = row < D.T ? lse[base + row] : INFINITY;
    sD[r] = row < D.T ? delta[base + row] : 0.f;
  }
}

// n rows of x starting at row `first` into s[n][RS]; rows outside
// [0, limit) are zero.
template <typename T>
__device__ void load_rows(const T* x, int first, int n, int limit,
                          const Dims& D, float* s) {
  for (int idx = threadIdx.x; idx < n * D.D4; idx += THREADS) {
    const int w = idx / D.D4, e = idx - w * D.D4, row = first + w;
    s[w * D.RS + e] = (row >= 0 && row < limit && e < D.dk)
                          ? to_f32(x[(size_t)row * D.dk + e])
                          : 0.f;
  }
}

// s and dout·v for the warp's 8 rows and the lane's key (passes 1, 2):
// krow / vrow are the lane's key and value rows, the window row of query
// ii is sPw + (31 - ii + lane) * RS.
__device__ __forceinline__ void scores(const float* sQu, const float* sQv,
                                       const float* sDO, const float* krow,
                                       const float* vrow, const float* sPw,
                                       const Dims& D, float* s, float* dp) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) s[r] = dp[r] = 0.f;
  for (int e = 0; e < D.D4; e += 4) {
    const float k0v = krow[e], k1v = krow[e + 1];
    const float k2v = krow[e + 2], k3v = krow[e + 3];
    const float v0 = vrow[e], v1 = vrow[e + 1];
    const float v2 = vrow[e + 2], v3 = vrow[e + 3];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int ii = warp * ROWS + r;
      const float4 a = *reinterpret_cast<const float4*>(sQu + ii * D.D4 + e);
      const float4 b = *reinterpret_cast<const float4*>(sQv + ii * D.D4 + e);
      const float4 g = *reinterpret_cast<const float4*>(sDO + ii * D.D4 + e);
      const float* prow = sPw + ((BQ - 1) - ii + lane) * D.RS + e;
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
      float y = dp[r];
      y = fmaf(g.x, v0, y);
      y = fmaf(g.y, v1, y);
      y = fmaf(g.z, v2, y);
      y = fmaf(g.w, v3, y);
      dp[r] = y;
    }
  }
}

// Pass 1: one block per (key tile, bh); dk and dv of its 32 keys.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rel_bwd_dkdv_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ p,
                        const int* __restrict__ kv_len,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout,
                        const float* __restrict__ delta, T* __restrict__ dk_,
                        T* __restrict__ dv_, Dims D) {
  extern __shared__ __align__(16) float smem[];
  float* sQu = smem;               // [BQ][D4]
  float* sQv = sQu + BQ * D.D4;    // [BQ][D4]
  float* sDO = sQv + BQ * D.D4;    // [BQ][D4]
  float* sK = sDO + BQ * D.D4;     // [BK][RS]
  float* sV = sK + BK * D.RS;      // [BK][RS]
  float* sPw = sV + BK * D.RS;     // [WIN][RS]
  float* sP = sPw + WIN * D.RS;    // [BQ][PS]
  float* sDZ = sP + BQ * PS;       // [BQ][PS]
  float* sL = sDZ + BQ * PS;
  float* sD = sL + BQ;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const T* ph = p + (size_t)(bh % D.H) * D.P * D.dk;
  const int kvl = min(kv_len[bh], D.T);

  float adv[DC], adk[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) adv[c] = adk[c] = 0.f;

  if (k0 < kvl) {
    load_rows(k + base * D.dk, k0, BK, D.T, D, sK);
    load_rows(v + base * D.dk, k0, BK, D.T, D, sV);
    const bool key_valid = k0 + lane < kvl;
    for (int q0 = 0; q0 < D.T; q0 += BQ) {
      __syncthreads();
      load_query_tile(qu, qv, dout, lse, delta, base, q0, D, sQu, sQv, sDO,
                      sL, sD);
      load_rows(ph, (D.T - 1) - q0 - (BQ - 1) + k0, WIN, D.P, D, sPw);
      __syncthreads();
      float s[ROWS], dp[ROWS];
      scores(sQu, sQv, sDO, sK + lane * D.RS, sV + lane * D.RS, sPw, D, s,
             dp);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int ii = warp * ROWS + r;
        const float pr = key_valid ? expf(s[r] * D.scale - sL[ii]) : 0.f;
        sP[ii * PS + lane] = pr;
        sDZ[ii * PS + lane] = pr * (dp[r] - sD[ii]) * D.scale;
      }
      __syncthreads();
      for (int ii = 0; ii < BQ; ++ii) {
        const float pr = sP[ii * PS + lane];
        const float z = sDZ[ii * PS + lane];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = warp + DG * c;
          if (d < D.dk) {
            adv[c] = fmaf(pr, sDO[ii * D.D4 + d], adv[c]);
            adk[c] = fmaf(z, sQu[ii * D.D4 + d], adk[c]);
          }
        }
      }
    }
  }
  const int key = k0 + lane;
  if (key < D.T) {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = warp + DG * c;
      if (d < D.dk) {
        dv_[(base + key) * D.dk + d] = from_f32<T>(adv[c]);
        dk_[(base + key) * D.dk + d] = from_f32<T>(adk[c]);
      }
    }
  }
}

// Pass 2: one block per (query tile, bh); dq_u and dq_v of its 32 rows.
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rel_bwd_dq_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ p, const int* __restrict__ kv_len,
                      const float* __restrict__ lse,
                      const T* __restrict__ dout,
                      const float* __restrict__ delta, T* __restrict__ dqu_,
                      T* __restrict__ dqv_, Dims D) {
  extern __shared__ __align__(16) float smem[];
  float* sQu = smem;
  float* sQv = sQu + BQ * D.D4;
  float* sDO = sQv + BQ * D.D4;
  float* sK = sDO + BQ * D.D4;
  float* sV = sK + BK * D.RS;
  float* sPw = sV + BK * D.RS;
  float* sDZ = sPw + WIN * D.RS;
  float* sL = sDZ + BQ * PS;
  float* sD = sL + BQ;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const T* ph = p + (size_t)(bh % D.H) * D.P * D.dk;
  const int kvl = min(kv_len[bh], D.T);

  float aqu[DC], aqv[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) aqu[c] = aqv[c] = 0.f;

  load_query_tile(qu, qv, dout, lse, delta, base, q0, D, sQu, sQv, sDO, sL,
                  sD);
  for (int k0 = 0; k0 < kvl; k0 += BK) {
    __syncthreads();
    load_rows(k + base * D.dk, k0, BK, D.T, D, sK);
    load_rows(v + base * D.dk, k0, BK, D.T, D, sV);
    load_rows(ph, (D.T - 1) - q0 - (BQ - 1) + k0, WIN, D.P, D, sPw);
    __syncthreads();
    float s[ROWS], dp[ROWS];
    scores(sQu, sQv, sDO, sK + lane * D.RS, sV + lane * D.RS, sPw, D, s, dp);
    const bool key_valid = k0 + lane < kvl;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const int ii = warp * ROWS + r;
      const float pr = key_valid ? expf(s[r] * D.scale - sL[ii]) : 0.f;
      sDZ[ii * PS + lane] = pr * (dp[r] - sD[ii]) * D.scale;
    }
    __syncthreads();
    // thread (row i = lane, d-group warp): sum over the tile's keys
    const int i = lane;
    for (int j = 0; j < BK; ++j) {
      const float z = sDZ[i * PS + j];
      const float* krow = sK + j * D.RS;
      const float* prow = sPw + ((BQ - 1) - i + j) * D.RS;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = warp + DG * c;
        if (d < D.dk) {
          aqu[c] = fmaf(z, krow[d], aqu[c]);
          aqv[c] = fmaf(z, prow[d], aqv[c]);
        }
      }
    }
  }
  const int row = q0 + lane;
  if (row < D.T) {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = warp + DG * c;
      if (d < D.dk) {
        dqu_[(base + row) * D.dk + d] = from_f32<T>(aqu[c]);
        dqv_[(base + row) * D.dk + d] = from_f32<T>(aqv[c]);
      }
    }
  }
}

// Pass 3: one block per (32 relative positions, head, batch slice); the
// lane's diagonal r = rb0 + lane, summed over the slice's batch rows
// b = slice, slice + S, ... into part[slice][h][r][d] (f32).
template <typename T>
__global__ void __launch_bounds__(THREADS)
    rel_bwd_dp_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ p, const int* __restrict__ kv_len,
                      const float* __restrict__ lse,
                      const T* __restrict__ dout,
                      const float* __restrict__ delta,
                      float* __restrict__ part, int B, Dims D) {
  extern __shared__ __align__(16) float smem[];
  float* sQu = smem;
  float* sQv = sQu + BQ * D.D4;
  float* sDO = sQv + BQ * D.D4;
  float* sPr = sDO + BQ * D.D4;    // [32][RS]  p rows rb0 .. rb0+31
  float* sKw = sPr + BK * D.RS;    // [WIN][RS] key window
  float* sVw = sKw + WIN * D.RS;   // [WIN][RS] value window
  float* sDZ = sVw + WIN * D.RS;   // [BQ][PS]
  float* sL = sDZ + BQ * PS;
  float* sD = sL + BQ;

  const int rb0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int slice = blockIdx.z;
  const int S = gridDim.z;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool r_valid = rb0 + lane < D.P;

  load_rows(p + (size_t)h * D.P * D.dk, rb0, BK, D.P, D, sPr);
  float adp[DC];
#pragma unroll
  for (int c = 0; c < DC; ++c) adp[c] = 0.f;

  for (int b = slice; b < B; b += S) {
    const int bh = b * D.H + h;
    const size_t base = (size_t)bh * D.T;
    const int kvl = min(kv_len[bh], D.T);
    for (int q0 = 0; q0 < D.T; q0 += BQ) {
      // keys j = j0 + ii + rr of this (query tile, diagonal tile)
      const int j0 = q0 + rb0 - (D.T - 1);
      if (j0 + WIN - 1 < 0 || j0 >= kvl) continue;   // uniform per block
      __syncthreads();
      load_query_tile(qu, qv, dout, lse, delta, base, q0, D, sQu, sQv, sDO,
                      sL, sD);
      load_rows(k + base * D.dk, j0, WIN, kvl, D, sKw);
      load_rows(v + base * D.dk, j0, WIN, kvl, D, sVw);
      __syncthreads();
      const float* prow = sPr + lane * D.RS;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int ii = warp * ROWS + r;
        const float* krow = sKw + (ii + lane) * D.RS;
        const float* vrow = sVw + (ii + lane) * D.RS;
        float x = 0.f, y = 0.f;
        for (int e = 0; e < D.D4; e += 4) {
          const float4 a =
              *reinterpret_cast<const float4*>(sQu + ii * D.D4 + e);
          const float4 bq =
              *reinterpret_cast<const float4*>(sQv + ii * D.D4 + e);
          const float4 g =
              *reinterpret_cast<const float4*>(sDO + ii * D.D4 + e);
          x = fmaf(a.x, krow[e], x);
          x = fmaf(a.y, krow[e + 1], x);
          x = fmaf(a.z, krow[e + 2], x);
          x = fmaf(a.w, krow[e + 3], x);
          x = fmaf(bq.x, prow[e], x);
          x = fmaf(bq.y, prow[e + 1], x);
          x = fmaf(bq.z, prow[e + 2], x);
          x = fmaf(bq.w, prow[e + 3], x);
          y = fmaf(g.x, vrow[e], y);
          y = fmaf(g.y, vrow[e + 1], y);
          y = fmaf(g.z, vrow[e + 2], y);
          y = fmaf(g.w, vrow[e + 3], y);
        }
        const int j = j0 + ii + lane;
        const bool valid = r_valid && j >= 0 && j < kvl;
        const float pr = valid ? expf(x * D.scale - sL[ii]) : 0.f;
        sDZ[ii * PS + lane] = pr * (y - sD[ii]) * D.scale;
      }
      __syncthreads();
      for (int ii = 0; ii < BQ; ++ii) {
        const float z = sDZ[ii * PS + lane];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const int d = warp + DG * c;
          if (d < D.dk) adp[c] = fmaf(z, sQv[ii * D.D4 + d], adp[c]);
        }
      }
    }
  }
  if (r_valid) {
    float* out = part + (((size_t)slice * D.H + h) * D.P + rb0 + lane) * D.dk;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = warp + DG * c;
      if (d < D.dk) out[d] = adp[c];
    }
  }
}

// dp[i] = sum over slices s of part[s][i], in slice order.
template <typename T>
__global__ void rel_bwd_dp_reduce_kernel(const float* __restrict__ part,
                                         T* __restrict__ dp, int n, int S) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float a = 0.f;
  for (int s = 0; s < S; ++s) a += part[(size_t)s * n + i];
  dp[i] = from_f32<T>(a);
}

template <typename T>
int launch(const void* qu, const void* qv, const void* k, const void* v,
           const void* p, const int* kv_len, const void* out,
           const float* lse, const void* dout, float* delta, float* part,
           void* dqu, void* dqv, void* dk_, void* dv_, void* dp, int BH,
           int T_, int dk, int H, int S, cudaStream_t stream) {
  Dims D;
  D.T = T_;
  D.dk = dk;
  D.H = H;
  D.P = 2 * T_ - 1;
  D.D4 = (dk + 3) / 4 * 4;
  D.RS = D.D4 + 1;
  D.scale = 1.0f / sqrtf((float)dk);
  const T* a = static_cast<const T*>(qu);
  const T* b = static_cast<const T*>(qv);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* pp = static_cast<const T*>(p);
  const T* g = static_cast<const T*>(dout);

  const int rows = BH * T_;
  rel_bwd_delta_kernel<T><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const T*>(out), g, delta, rows, dk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t q3 = 3 * (size_t)BQ * D.D4, tail = (size_t)BQ * PS + 2 * BQ;
  const size_t smem1 = sizeof(float) * (q3 + (2 * BK + WIN) * (size_t)D.RS +
                                        (size_t)BQ * PS + tail);
  const size_t smem2 = sizeof(float) * (q3 + (2 * BK + WIN) * (size_t)D.RS +
                                        tail);
  const size_t smem3 = sizeof(float) * (q3 + (BK + 2 * WIN) * (size_t)D.RS +
                                        tail);
  err = cudaFuncSetAttribute(rel_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem1);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_bwd_dq_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem2);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_bwd_dp_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid((T_ + BQ - 1) / BQ, BH);
  rel_bwd_dkdv_kernel<T><<<grid, THREADS, smem1, stream>>>(
      a, b, kk, vv, pp, kv_len, lse, g, delta, static_cast<T*>(dk_),
      static_cast<T*>(dv_), D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_bwd_dq_kernel<T><<<grid, THREADS, smem2, stream>>>(
      a, b, kk, vv, pp, kv_len, lse, g, delta, static_cast<T*>(dqu),
      static_cast<T*>(dqv), D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid3((D.P + BK - 1) / BK, H, S);
  rel_bwd_dp_kernel<T><<<grid3, THREADS, smem3, stream>>>(
      a, b, kk, vv, pp, kv_len, lse, g, delta, part, BH / H, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n = H * D.P * dk;
  rel_bwd_dp_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, static_cast<T*>(dp), n, S);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when every launch was accepted.  Scratch:
// `delta` f32 (BH*T), `part` f32 (S, H, 2T-1, dk) with 1 <= S <= BH/H.
extern "C" int lasr_rel_attention_bwd(
    const void* qu, const void* qv, const void* k, const void* v,
    const void* p, const void* kv_len, const void* out, const void* lse,
    const void* dout, void* delta, void* part, void* dqu, void* dqv,
    void* dk, void* dv, void* dp, int BH, int T_, int dk_dim, int H, int S,
    int is_bf16, void* stream) {
  if (dk_dim < 1 || dk_dim > DK_MAX || H < 1 || BH % H != 0 || T_ < 1 ||
      BH < 1 || S < 1 || S > BH / H)
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(qu, qv, k, v, p, kl, out, ls, dout, dl, pt,
                                 dqu, dqv, dk, dv, dp, BH, T_, dk_dim, H, S,
                                 st);
  return launch<float>(qu, qv, k, v, p, kl, out, ls, dout, dl, pt, dqu, dqv,
                       dk, dv, dp, BH, T_, dk_dim, H, S, st);
}
