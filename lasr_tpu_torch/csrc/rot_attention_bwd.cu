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
// What bounds it on an H100: each (i, j) pair needs a 360-lane score
// (dk + M at dk=40, M=320), a 320-lane du product and four dk-wide ones,
// ~4M + 10dk = 1680 FLOP per pair against a few hundred bytes per row:
// bound by arithmetic.  On the CUDA cores (67 TFLOP/s f32) that bound is
// ~2.5x what the tensor cores allow even as 3xTF32, so every product here
// runs on them.
//
// Design (tensor cores through WMMA, no atomics, bitwise repeatable):
//  - the five products (S = [q_u ; u]·[k ; V]^T, dP = dout·v^T, P^T·dout,
//    dz^T·q_u, dz·[k ; V]) are m16n16k8 TF32 WMMA tiles (mma_tf32.cuh):
//    3xTF32 (hi·hi + hi·lo + lo·hi, f32 accuracy) for f32 inputs, one
//    product for bf16 inputs, which TF32 holds exactly.
//  - the TPU kernel walks query tiles in order and sums dk/dv into one
//    output block across grid steps; blocks here run in no order, so the
//    work is split in two passes, each owning what it writes:
//      key pass, grid (ceil(T/32), BH): one block per 32 keys keeps
//        [k ; V] and v resident, streams every query tile, and sums dk
//        and dv in accumulator fragments (warp w < 2*ceil(dk/16) owns one
//        16 x 16 tile of each);
//      query pass, grid (ceil(T/32), BH, ceil(E/384)): one block per 32
//        query rows keeps [q_u ; u] and dout resident, streams the key
//        tiles below kv_len, and sums its 32 x 384-column chunk of
//        [dq_u ; du] in accumulator fragments (8 warps x up to 6 tiles)
//        held in registers for the whole key loop, written once.
//    A first tiny kernel writes delta[bh, i].
//  - per tile pair, warps 0-3 take the first half of S's depth steps and
//    warps 4-7 the rest plus dP (one 16 x 16 tile each); the partials go
//    to shared memory, where each element becomes P and dz (the kv_len
//    mask, exp, lse), and come back as fragments (P^T and dz^T load the
//    stored tile column-major, with no transposing copy).
//  - tiles are f32 in shared memory (bf16 is widened on the way in, so
//    both types take one path), zero-padded to 16 columns (E 360 -> 368,
//    dk 40 -> 48), with a row stride of width + 4 floats (32-byte-aligned
//    fragment origins, conflict-free row-major fragment loads); keys are
//    loaded only below kv_len, rows past T are zero.
//  - the streamed tile's copies (tile_io.cuh) run while the current one
//    is computed: f32 by cp.async straight into the other of two buffers;
//    bf16 by cp.async into a raw staging tile, widened to f32 in shared
//    memory at the top of the next step (16-byte copies where every width
//    and base allows, else 4-byte; bf16 of odd width goes through
//    registers, 16 loads in flight per thread).  At dk=40, M=320: 173 KB
//    of dynamic shared memory in f32, 146 KB in bf16
//    (cudaFuncSetAttribute); one buffer where that does not fit.
//  - wide form (dk > 64, or a [q_u ; u] row too wide for the tiles above:
//    385 KB at the 1B config's dk = 80, M = 1280), a template branch of
//    its own, so dk <= 64 at the recipe's M compiles as before:
//      key pass: S's depth streams in chunks of DC = 128 columns, as in
//        the forward's wide form: step (query tile t, chunk c) copies
//        chunk c of the query tile's [q_u ; u] rows and of the block's
//        [k ; V] rows through a ring of NST = 3 stages, NST - 1 steps
//        ahead; each warp sums its 2 x 2 S fragments over its eighth of
//        each chunk's depth in registers.  A tile's chunks run last to
//        first, so chunk 0, which holds q_u, is in place for dk += dz^T
//        q_u; dout, lse and delta land with it.  dP = dout·v^T: warp w
//        one 16 x 16 tile over half of dk's depth.  A warp owns up to two
//        (key tile, dk column tile) positions of dk and of dv (2 x 8 at
//        dk = 128).  It writes each tile pair's dz (f32) once, into a
//        (BH, T32, T32) scratch (T32 = T rounded up to 32: 354 MB at
//        the 1B training shape);
//      query pass: [dq_u ; du] = dz·[k ; V], a plain product: the dz
//        tiles and the key tile's columns of the block's 384-column chunk
//        stream through two buffers; nothing is recomputed.
//    Both passes still own what they write: no atomics, bitwise
//    repeatable.  215,808 B of shared memory (the key pass) at dk = 128
//    in f32, 188,160 B in bf16; the query pass 108,544 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_tf32.cuh"
#include "tile_io.cuh"

namespace {

using namespace lasr_mma;
using namespace lasr_tile;

constexpr int BQ = 32;        // query rows per tile
constexpr int BK = 32;        // keys per tile
constexpr int THREADS = 32 * NWARPS;
constexpr int LS = BK + 4;    // row stride of the S / dP / P / dz tiles
constexpr int DK_NARROW = 64;
constexpr int DK_MAX = 128;   // wide form
constexpr int DC = 128;       // wide form: columns of a depth chunk
constexpr int LC = DC + 4;    // its row stride
constexpr int NST = 3;        // its ring's stages
// query pass: 2 row tiles x 4 column groups of warps; a block sums one
// chunk of CHUNK_CT column tiles of [dq_u ; du], ACC per warp
constexpr int NCG = NWARPS / (BQ / TM);
constexpr int ACC = 6;
constexpr int CHUNK_CT = NCG * ACC;
constexpr int LKC = CHUNK_CT * TN + 4;  // wide query pass: its key tile

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
  int T, dk, M, E;
  int EP, DKP;  // E and dk rounded up to 16
  int LQ, LD;   // row strides EP + 4, DKP + 4 of the wide and dk tiles
  int NKS;      // depth steps of S: ceil(E / 8)
  int NDS;      // depth steps of dP: ceil(dk / 8)
  int H0;       // S depth steps of warps 0-3
  int NCT;      // EP / 16 column tiles of [dq_u ; du]
  int NC;       // wide form: depth chunks of S, ceil(E / DC)
  int TP;       // wide form: T rounded up to 32, the dz scratch's rows
  int NBUF;     // f32 buffers of the streamed tile: 2, or 1 (see launch)
  int chunk;    // elements per cp.async copy of a tile; 0: registers
  int raw;      // bf16 tiles are staged raw and widened in shared memory
  float scale;
};

// Shared memory: f32 tiles [q_u ; u] (Q) and [k ; V] (K), the dk tiles
// dout (DO) and v (V), the query rows' lse (L) and delta (Dl), the S
// halves S0 / S1 (then dz / P) and dP; the streamed side has NBUF tile
// buffers ([1] == [0] for one) and two of L / Dl.  bf16 copies land raw
// in RW / RN (the streamed wide and dk tiles, row stride EP / DKP).
struct Smem {
  float *Q[2], *K[2], *DO[2], *V[2], *L[2], *Dl[2];
  float *S0, *S1, *DP;
  void *RW, *RN;
};

__host__ __device__ __forceinline__ size_t smem_bytes(const Dims& D) {
  const size_t floats = (size_t)(1 + D.NBUF) * BQ * (D.LQ + D.LD) +
                        3 * (size_t)BQ * LS + 4 * (size_t)BQ;
  return 4 * floats + (D.raw ? 2 * (size_t)BQ * (D.EP + D.DKP) : 0);
}

__device__ __forceinline__ void take(float*& p, float* (&buf)[2], int n,
                                     int nbuf) {
  buf[0] = p;
  p += n;
  buf[1] = buf[0];
  if (nbuf == 2) {
    buf[1] = p;
    p += n;
  }
}

// stream_keys: the query pass (K, V streamed); else the key pass (Q, DO,
// L, Dl streamed).
__device__ __forceinline__ Smem carve(float* p, const Dims& D,
                                      bool stream_keys) {
  const int nq = stream_keys ? 1 : D.NBUF, nk = stream_keys ? D.NBUF : 1;
  Smem s;
  take(p, s.Q, BQ * D.LQ, nq);
  take(p, s.K, BK * D.LQ, nk);
  take(p, s.DO, BQ * D.LD, nq);
  take(p, s.V, BK * D.LD, nk);
  s.S0 = p;
  s.S1 = s.S0 + BQ * LS;
  s.DP = s.S1 + BQ * LS;
  p = s.DP + BQ * LS;
  take(p, s.L, BQ, 2);
  take(p, s.Dl, BQ, 2);
  s.RW = p;
  s.RN = reinterpret_cast<unsigned short*>(p) + BQ * D.EP;
  return s;
}

// lse and delta of query rows q0.. (rows past T are masked by index in
// softmax_step, so their zeros are never used).
__device__ __forceinline__ void fetch_row_stats(const float* lse,
                                                const float* delta,
                                                size_t base, int q0, int T,
                                                float* sL, float* sDl) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool ok = q0 + r < T;
    const size_t at = ok ? base + q0 + r : 0;
    cp_async4(sL + r, lse + at, ok);
    cp_async4(sDl + r, delta + at, ok);
  }
}

// S = Q·K^T and dP = DO·V^T of the tile pair, as partials in shared
// memory: warp w owns output tile (w & 3) of the 2 x 2; warps 0-3 sum S's
// depth steps [0, H0) into S0, warps 4-7 the steps [H0, NKS) into S1 and
// all of dP into DP.
template <int NS>
__device__ __forceinline__ void scores(const float* Q, const float* K,
                                       const float* DO, const float* V,
                                       float* S0, float* S1, float* DP,
                                       const Dims& D) {
  const int warp = threadIdx.x >> 5;
  const int half = warp >> 2;
  const int rt = (warp >> 1) & 1, ct = warp & 1;
  // four accumulators over every fourth depth step: four independent
  // chains, and four steps' fragments loaded before their products
  FragC acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[j], 0.f);
  const float* qa = Q + rt * TM * D.LQ;
  const float* kb = K + ct * TN * D.LQ;
  const int ks1 = half ? D.NKS : D.H0;
  int ks = half ? D.H0 : 0;
  for (; ks + 3 < ks1; ks += 4) {
    Split<FragA<RowMajor>, NS> a[4];
    Split<FragB<ColMajor>, NS> b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      load_split(a[j], qa + (ks + j) * TK, D.LQ);
      load_split(b[j], kb + (ks + j) * TK, D.LQ);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_split(acc[j], a[j], b[j]);
  }
  for (; ks < ks1; ++ks) {
    Split<FragA<RowMajor>, NS> a;
    Split<FragB<ColMajor>, NS> b;
    load_split(a, qa + ks * TK, D.LQ);
    load_split(b, kb + ks * TK, D.LQ);
    mma_split(acc[1], a, b);
  }
#pragma unroll
  for (int t = 0; t < acc[0].num_elements; ++t)
    acc[0].x[t] += acc[1].x[t] + acc[2].x[t] + acc[3].x[t];
  wmma::store_matrix_sync((half ? S1 : S0) + rt * TM * LS + ct * TN, acc[0],
                          LS, wmma::mem_row_major);
  if (half) {
    wmma::fill_fragment(acc[0], 0.f);
    const float* ga = DO + rt * TM * D.LD;
    const float* vb = V + ct * TN * D.LD;
    for (int k = 0; k < D.NDS; ++k) {
      Split<FragA<RowMajor>, NS> a;
      Split<FragB<ColMajor>, NS> b;
      load_split(a, ga + k * TK, D.LD);
      load_split(b, vb + k * TK, D.LD);
      mma_split(acc[0], a, b);
    }
    wmma::store_matrix_sync(DP + rt * TM * LS + ct * TN, acc[0], LS,
                            wmma::mem_row_major);
  }
}

// Each element of the tile pair: P into S1, dz into S0 (key k0 + j valid
// below kv_len, query row i below nrows).
__device__ __forceinline__ void softmax_step(float* S0, float* S1,
                                             const float* DP, const float* L,
                                             const float* Dl, int k0, int kvl,
                                             int nrows, float scale) {
  for (int idx = threadIdx.x; idx < BQ * BK; idx += THREADS) {
    const int i = idx / BK, j = idx % BK;
    const int o = i * LS + j;
    const float s = S0[o] + S1[o];
    const float p =
        k0 + j < kvl && i < nrows ? expf(s * scale - L[i]) : 0.f;
    S1[o] = p;
    S0[o] = p * (DP[o] - Dl[i]) * scale;
  }
}

// Key pass: one block per (key tile, bh); dk and dv of its 32 keys.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    rot_bwd_dkdv_kernel(const T* __restrict__ qu, const T* __restrict__ u,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ vt,
                        const int* __restrict__ kv_len,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout,
                        const float* __restrict__ delta, T* __restrict__ dk_,
                        T* __restrict__ dv_, Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  extern __shared__ __align__(128) float smem[];
  const Smem sm = carve(smem, D, false);
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const int kvl = max(0, min(kv_len[bh], D.T));
  // warp w < 2 * ndt owns the 16 x 16 tile (kt, dt) of dv and of dk
  const int ndt = D.DKP / TN;
  const bool owner = warp < (BK / TM) * ndt;
  const int kt = warp / ndt, dt = warp % ndt;
  // the streamed query tiles and the resident key tile
  const Src<T> qw{qu + base * D.dk, u + base * D.M, D.dk, D.M, D.T, D.EP,
                  D.LQ};
  const Src<T> qn{dout + base * D.dk, dout, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> kw{k + base * D.dk, vt, D.dk, D.M, kvl, D.EP, D.LQ};
  const Src<T> kn{v + base * D.dk, v, D.dk, 0, kvl, D.DKP, D.LD};
  constexpr bool f32 = std::is_same<T, float>::value;
  // prefetch: the next tile's copies run while this one is computed
  const bool pre = f32 ? D.NBUF == 2 : D.raw != 0;
  const int ntiles = (D.T + BQ - 1) / BQ;

  FragC adv, adk;
  wmma::fill_fragment(adv, 0.f);
  wmma::fill_fragment(adk, 0.f);
  if (k0 < kvl) {
    load_resident<BK>(kw, k0, sm.K[0], D);
    load_resident<BK>(kn, k0, sm.V[0], D);
    issue<BQ>(qw, 0, sm.Q[0], sm.RW, D);
    issue<BQ>(qn, 0, sm.DO[0], sm.RN, D);
    fetch_row_stats(lse, delta, base, 0, D.T, sm.L[0], sm.Dl[0]);
    cp_async_commit();
    for (int t = 0; t < ntiles; ++t) {
      const int q0 = t * BQ;
      // this step's buffers and the next one's (selects, not indexing,
      // keep the pointer pairs in registers)
      const bool odd = f32 && D.NBUF == 2 && (t & 1);
      float* Qc = odd ? sm.Q[1] : sm.Q[0];
      float* DOc = odd ? sm.DO[1] : sm.DO[0];
      float* Qn = odd ? sm.Q[0] : sm.Q[1];
      float* DOn = odd ? sm.DO[0] : sm.DO[1];
      float* Lc = (t & 1) ? sm.L[1] : sm.L[0];
      float* Dlc = (t & 1) ? sm.Dl[1] : sm.Dl[0];
      float* Ln = (t & 1) ? sm.L[0] : sm.L[1];
      float* Dln = (t & 1) ? sm.Dl[0] : sm.Dl[1];
      if (!pre && t > 0) {
        __syncthreads();  // the previous step's readers are done
        issue<BQ>(qw, q0, sm.Q[0], sm.RW, D);
        issue<BQ>(qn, q0, sm.DO[0], sm.RN, D);
        fetch_row_stats(lse, delta, base, q0, D.T, Lc, Dlc);
        cp_async_commit();
      }
      cp_async_wait(0);
      __syncthreads();  // tile t has landed; step t-1's readers are done
      if constexpr (!f32) {
        land<BQ>(qw, q0, sm.Q[0], sm.RW, D);
        land<BQ>(qn, q0, sm.DO[0], sm.RN, D);
        __syncthreads();
      }
      if (pre && t + 1 < ntiles) {
        issue<BQ>(qw, q0 + BQ, Qn, sm.RW, D);
        issue<BQ>(qn, q0 + BQ, DOn, sm.RN, D);
        fetch_row_stats(lse, delta, base, q0 + BQ, D.T, Ln, Dln);
        cp_async_commit();
      }
      scores<NS>(Qc, sm.K[0], DOc, sm.V[0], sm.S0, sm.S1, sm.DP, D);
      __syncthreads();
      softmax_step(sm.S0, sm.S1, sm.DP, Lc, Dlc, k0, kvl, D.T - q0,
                   D.scale);
      __syncthreads();
      if (owner) {
        // dv += P^T·dout, dk += dz^T·q_u over the tile's 32 query rows
#pragma unroll
        for (int ks = 0; ks < BQ / TK; ++ks) {
          Split<FragA<ColMajor>, NS> p, z;
          Split<FragB<RowMajor>, NS> g, q;
          load_split(p, sm.S1 + ks * TK * LS + kt * TM, LS);
          load_split(z, sm.S0 + ks * TK * LS + kt * TM, LS);
          load_split(g, DOc + ks * TK * D.LD + dt * TN, D.LD);
          load_split(q, Qc + ks * TK * D.LQ + dt * TN, D.LQ);
          mma_split(adv, p, g);
          mma_split(adk, z, q);
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();
  float* sdv = sm.Q[0];
  float* sdk = sm.Q[0] + BK * D.LD;
  if (owner) {
    wmma::store_matrix_sync(sdv + kt * TM * D.LD + dt * TN, adv, D.LD,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sdk + kt * TM * D.LD + dt * TN, adk, D.LD,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BK * D.dk; idx += THREADS) {
    const int r = idx / D.dk, d = idx - r * D.dk, key = k0 + r;
    if (key >= D.T) continue;
    dv_[(base + key) * D.dk + d] = from_f32<T>(sdv[r * D.LD + d]);
    dk_[(base + key) * D.dk + d] = from_f32<T>(sdk[r * D.LD + d]);
  }
}

// Query pass: one block per (query tile, bh, column chunk); dq_u and du
// of its 32 rows in that chunk.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    rot_bwd_dq_kernel(const T* __restrict__ qu, const T* __restrict__ u,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ vt,
                      const int* __restrict__ kv_len,
                      const float* __restrict__ lse,
                      const T* __restrict__ dout,
                      const float* __restrict__ delta, T* __restrict__ dqu_,
                      T* __restrict__ du_, Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  extern __shared__ __align__(128) float smem[];
  const Smem sm = carve(smem, D, true);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ct0 = blockIdx.z * CHUNK_CT;
  const int ct1 = min(D.NCT, ct0 + CHUNK_CT);
  const int warp = threadIdx.x >> 5;
  // warp w owns row tile w & 1 and column tiles ct0 + (w >> 1) + NCG * i
  const int rt = warp & 1, cg = warp >> 1;
  const size_t base = (size_t)bh * D.T;
  const int kvl = max(0, min(kv_len[bh], D.T));
  // the resident query tile and the streamed key tiles
  const Src<T> qw{qu + base * D.dk, u + base * D.M, D.dk, D.M, D.T, D.EP,
                  D.LQ};
  const Src<T> qn{dout + base * D.dk, dout, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> kw{k + base * D.dk, vt, D.dk, D.M, kvl, D.EP, D.LQ};
  const Src<T> kn{v + base * D.dk, v, D.dk, 0, kvl, D.DKP, D.LD};
  constexpr bool f32 = std::is_same<T, float>::value;
  // prefetch: the next tile's copies run while this one is computed
  const bool pre = f32 ? D.NBUF == 2 : D.raw != 0;
  const int ntiles = (kvl + BK - 1) / BK;

  load_resident<BQ>(qw, q0, sm.Q[0], D);
  load_resident<BQ>(qn, q0, sm.DO[0], D);
  fetch_row_stats(lse, delta, base, q0, D.T, sm.L[0], sm.Dl[0]);
  if (ntiles > 0) {
    issue<BK>(kw, 0, sm.K[0], sm.RW, D);
    issue<BK>(kn, 0, sm.V[0], sm.RN, D);
  }
  cp_async_commit();

  FragC acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const bool odd = f32 && D.NBUF == 2 && (t & 1);
    float* Kc = odd ? sm.K[1] : sm.K[0];
    float* Vc = odd ? sm.V[1] : sm.V[0];
    float* Kn = odd ? sm.K[0] : sm.K[1];
    float* Vn = odd ? sm.V[0] : sm.V[1];
    if (!pre && t > 0) {
      __syncthreads();  // the previous step's readers are done
      issue<BK>(kw, k0, sm.K[0], sm.RW, D);
      issue<BK>(kn, k0, sm.V[0], sm.RN, D);
      cp_async_commit();
    }
    cp_async_wait(0);
    __syncthreads();  // tile t has landed; step t-1's readers are done
    if constexpr (!f32) {
      land<BK>(kw, k0, sm.K[0], sm.RW, D);
      land<BK>(kn, k0, sm.V[0], sm.RN, D);
      __syncthreads();
    }
    if (pre && t + 1 < ntiles) {
      issue<BK>(kw, k0 + BK, Kn, sm.RW, D);
      issue<BK>(kn, k0 + BK, Vn, sm.RN, D);
      cp_async_commit();
    }
    scores<NS>(sm.Q[0], Kc, sm.DO[0], Vc, sm.S0, sm.S1, sm.DP, D);
    __syncthreads();
    softmax_step(sm.S0, sm.S1, sm.DP, sm.L[0], sm.Dl[0], k0, kvl, D.T - q0,
                 D.scale);
    __syncthreads();
    // [dq_u ; du] += dz·[k ; V] over the tile's 32 keys
#pragma unroll
    for (int ks = 0; ks < BK / TK; ++ks) {
      Split<FragA<RowMajor>, NS> z;
      load_split(z, sm.S0 + rt * TM * LS + ks * TK, LS);
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int ct = ct0 + cg + NCG * i;
        if (ct < ct1) {
          Split<FragB<RowMajor>, NS> kf;
          load_split(kf, Kc + ks * TK * D.LQ + ct * TN, D.LQ);
          mma_split(acc[i], z, kf);
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();
  // written once: fragments -> the Q tile's place -> the outputs
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int ct = ct0 + cg + NCG * i;
    if (ct < ct1)
      wmma::store_matrix_sync(sm.Q[0] + rt * TM * D.LQ + ct * TN, acc[i],
                              D.LQ, wmma::mem_row_major);
  }
  __syncthreads();
  const int e0 = ct0 * TN, w = min(D.E, ct1 * TN) - e0;
  for (int idx = threadIdx.x; idx < BQ * w; idx += THREADS) {
    const int r = idx / w, e = e0 + (idx - r * w), row = q0 + r;
    if (row >= D.T) continue;
    const float a = sm.Q[0][r * D.LQ + e];
    if (e < D.dk)
      dqu_[(base + row) * D.dk + e] = from_f32<T>(a);
    else
      du_[(base + row) * D.M + (e - D.dk)] = from_f32<T>(a);
  }
}

// ---------------------------------------------------------------- wide form

// Key pass: a ring of NST f32 stages (bf16: one, fs = 0), each a query
// chunk (BQ x LC), a key chunk (BK x LC) and a dout tile (BQ x LD); NST
// lse / delta rows; the resident v tile; the NWARPS S partials (then P in
// partial 0 and dz in partial 1) and two dP partials; NST raw bf16
// stages.
struct WideKeySmem {
  float* F;           // f32 stage 0
  int fs;             // floats from one f32 stage to the next
  float *L, *Dl;      // NST rows of lse, delta
  float *V, *S, *DP;
  __nv_bfloat16* R;   // raw stage 0
};

__host__ __device__ __forceinline__ int key_stage(const Dims& D) {
  return (BQ + BK) * LC + BQ * D.LD;
}
__host__ __device__ __forceinline__ int key_raw_stage(const Dims& D) {
  return (BQ + BK) * DC + BQ * D.DKP;
}

__host__ __device__ __forceinline__ size_t wide_key_smem_bytes(
    const Dims& D, bool f32) {
  const size_t floats = (size_t)(f32 ? NST : 1) * key_stage(D) +
                        2 * NST * BQ + (size_t)BK * D.LD +
                        (NWARPS + 2) * (size_t)BQ * LS;
  return 4 * floats + (D.raw ? 2 * (size_t)NST * key_raw_stage(D) : 0);
}

__device__ __forceinline__ WideKeySmem carve_key(float* p, const Dims& D,
                                                 bool f32) {
  WideKeySmem s;
  s.F = p;
  s.fs = f32 ? key_stage(D) : 0;
  p += (f32 ? NST : 1) * key_stage(D);
  s.L = p;
  s.Dl = s.L + NST * BQ;
  s.V = s.Dl + NST * BQ;
  s.S = s.V + BK * D.LD;
  s.DP = s.S + NWARPS * BQ * LS;
  s.R = reinterpret_cast<__nv_bfloat16*>(s.DP + 2 * BQ * LS);
  return s;
}

// Query pass: two f32 buffers of the key tile's chunk columns (BK x LKC;
// bf16: one, and a raw one beside them) and two of the dz tile.
__host__ __device__ __forceinline__ size_t wide_query_smem_bytes(
    const Dims& D, bool f32) {
  const size_t floats = (size_t)(f32 ? 2 : 1) * BK * LKC + 2 * BQ * LS;
  return 4 * floats + (D.raw ? 2 * (size_t)BK * (LKC - 4) : 0);
}

// The columns of depth chunk c: DC, the last one's rounded up to 8.
__device__ __forceinline__ int chunk_width(const Dims& D, int c) {
  return min(DC, (D.E - c * DC + 7) / 8 * 8);
}

// Each element of the tile pair from the NWARPS S partials and the two dP
// partials: P into partial 0, dz into partial 1 (each thread reads and
// writes only its own elements).
__device__ __forceinline__ void softmax_wide(float* S, const float* DP,
                                             const float* L, const float* Dl,
                                             int k0, int kvl, int nrows,
                                             float scale) {
  for (int idx = threadIdx.x; idx < BQ * BK; idx += THREADS) {
    const int i = idx / BK, j = idx % BK;
    const int o = i * LS + j;
    float x = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) x += S[w * BQ * LS + o];
    const float p =
        k0 + j < kvl && i < nrows ? expf(x * scale - L[i]) : 0.f;
    S[o] = p;
    S[BQ * LS + o] = p * (DP[o] + DP[BQ * LS + o] - Dl[i]) * scale;
  }
}

// Key pass: one block per (key tile, bh); dk and dv of its 32 keys, and
// the dz of each of its tile pairs into the scratch.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    rot_bwd_dkdv_wide_kernel(const T* __restrict__ qu,
                             const T* __restrict__ u,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ vt,
                             const int* __restrict__ kv_len,
                             const float* __restrict__ lse,
                             const T* __restrict__ dout,
                             const float* __restrict__ delta,
                             T* __restrict__ dk_, T* __restrict__ dv_,
                             float* __restrict__ dz, Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) float smem[];
  const WideKeySmem sm = carve_key(smem, D, f32);
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const int kvl = max(0, min(kv_len[bh], D.T));
  // warp w owns positions w + NWARPS s (s < 2) of the 2 x ndt tiles
  // (kt, dt) of dv and of dk
  const int ndt = D.DKP / TN, npos = (BK / TM) * ndt;
  FragC adv[2], adk[2];
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    wmma::fill_fragment(adv[s], 0.f);
    wmma::fill_fragment(adk[s], 0.f);
  }
  if (k0 < kvl) {
    const int ntiles = (D.T + BQ - 1) / BQ, nsteps = ntiles * D.NC;
    const Src<T> qn{dout + base * D.dk, dout, D.dk, 0, D.T, D.DKP, D.LD};
    const Src<T> kn{v + base * D.dk, v, D.dk, 0, kvl, D.DKP, D.LD};
    auto qc = [&](int c) {
      return Cols<T>{qu + base * D.dk, u + base * D.M, D.dk, D.M, D.T,
                     c * DC, chunk_width(D, c), LC};
    };
    auto kc = [&](int c) {
      return Cols<T>{k + base * D.dk, vt, D.dk, D.M, kvl, c * DC,
                     chunk_width(D, c), LC};
    };
    auto fq = [&](int st) { return sm.F + st * sm.fs; };
    auto rq = [&](int st) { return sm.R + st * key_raw_stage(D); };
    // step s = (query tile t, chunk c), a tile's chunks last to first
    auto issue_step = [&](int s) {
      if (s < nsteps) {
        const int t = s / D.NC, c = D.NC - 1 - (s - t * D.NC);
        const int st = s % NST;
        issue_cols<BQ>(qc(c), t * BQ, fq(st), rq(st), D);
        issue_cols<BK>(kc(c), k0, fq(st) + BQ * LC, rq(st) + BQ * DC, D);
        if (c == 0) {
          issue<BQ>(qn, t * BQ, fq(st) + (BQ + BK) * LC,
                    rq(st) + (BQ + BK) * DC, D);
          fetch_row_stats(lse, delta, base, t * BQ, D.T, sm.L + st * BQ,
                          sm.Dl + st * BQ);
        }
      }
      cp_async_commit();
    };

    load_resident<BK>(kn, k0, sm.V, D);
    for (int s = 0; s < NST - 1; ++s) issue_step(s);
    FragC acc[2][2];
    for (int s = 0; s < nsteps; ++s) {
      const int t = s / D.NC, c = D.NC - 1 - (s - t * D.NC), st = s % NST;
      const int q0 = t * BQ;
      float* Qc = fq(st);
      float* Kc = Qc + BQ * LC;
      float* DOc = Kc + BK * LC;
      cp_async_wait(NST - 2);
      __syncthreads();  // step s has landed; step s-1's readers are done
      if constexpr (!f32) {
        land_cols<BQ>(qc(c), q0, Qc, rq(st), D);
        land_cols<BK>(kc(c), k0, Kc, rq(st) + BQ * DC, D);
        if (c == 0) land<BQ>(qn, q0, DOc, rq(st) + (BQ + BK) * DC, D);
        __syncthreads();
      }
      issue_step(s + NST - 1);
      if (c == D.NC - 1) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
      }
      // warp w: all four tiles over its eighth of the chunk's depth steps
      const int nks = chunk_width(D, c) / TK;
      mma_2x2_nt<NS>(acc, Qc, Kc, LC, warp * nks / NWARPS,
                     (warp + 1) * nks / NWARPS);
      if (c > 0) continue;
      // the tile's last step: dP, then P and dz, then dv, dk and the
      // scratch
      {
        const int half = warp >> 2, rt = (warp >> 1) & 1, ct = warp & 1;
        const int k1 = half ? D.NDS : D.NDS / 2;
        FragC dp;
        wmma::fill_fragment(dp, 0.f);
        for (int ks = half ? D.NDS / 2 : 0; ks < k1; ++ks) {
          Split<FragA<RowMajor>, NS> a;
          Split<FragB<ColMajor>, NS> b;
          load_split(a, DOc + rt * TM * D.LD + ks * TK, D.LD);
          load_split(b, sm.V + ct * TN * D.LD + ks * TK, D.LD);
          mma_split(dp, a, b);
        }
        wmma::store_matrix_sync(sm.DP + half * BQ * LS + rt * TM * LS +
                                    ct * TN,
                                dp, LS, wmma::mem_row_major);
        float* sp = sm.S + warp * BQ * LS;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::store_matrix_sync(sp + i * TM * LS + j * TN, acc[i][j], LS,
                                    wmma::mem_row_major);
      }
      __syncthreads();
      softmax_wide(sm.S, sm.DP, sm.L + st * BQ, sm.Dl + st * BQ, k0, kvl,
                   D.T - q0, D.scale);
      __syncthreads();
      const float* P = sm.S;
      const float* Z = sm.S + BQ * LS;
#pragma unroll
      for (int s2 = 0; s2 < 2; ++s2) {
        const int pos = warp + NWARPS * s2;
        if (pos >= npos) continue;
        const int kt = pos / ndt, dt = pos % ndt;
        // dv += P^T·dout, dk += dz^T·q_u over the tile's 32 query rows
#pragma unroll
        for (int ks = 0; ks < BQ / TK; ++ks) {
          Split<FragA<ColMajor>, NS> pf, zf;
          Split<FragB<RowMajor>, NS> g, q;
          load_split(pf, P + ks * TK * LS + kt * TM, LS);
          load_split(zf, Z + ks * TK * LS + kt * TM, LS);
          load_split(g, DOc + ks * TK * D.LD + dt * TN, D.LD);
          load_split(q, Qc + ks * TK * LC + dt * TN, LC);
          mma_split(adv[s2], pf, g);
          mma_split(adk[s2], zf, q);
        }
      }
      // the tile pair's dz, once (rows past T are zeros)
      {
        const int i = threadIdx.x >> 3, j = (threadIdx.x & 7) * 4;
        *reinterpret_cast<float4*>(
            dz + ((size_t)bh * D.TP + q0 + i) * D.TP + k0 + j) =
            *reinterpret_cast<const float4*>(Z + i * LS + j);
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();
  float* sdv = sm.F;
  float* sdk = sm.F + BK * D.LD;
#pragma unroll
  for (int s2 = 0; s2 < 2; ++s2) {
    const int pos = warp + NWARPS * s2;
    if (pos >= npos) continue;
    const int kt = pos / ndt, dt = pos % ndt;
    wmma::store_matrix_sync(sdv + kt * TM * D.LD + dt * TN, adv[s2], D.LD,
                            wmma::mem_row_major);
    wmma::store_matrix_sync(sdk + kt * TM * D.LD + dt * TN, adk[s2], D.LD,
                            wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BK * D.dk; idx += THREADS) {
    const int r = idx / D.dk, d = idx - r * D.dk, key = k0 + r;
    if (key >= D.T) continue;
    dv_[(base + key) * D.dk + d] = from_f32<T>(sdv[r * D.LD + d]);
    dk_[(base + key) * D.dk + d] = from_f32<T>(sdk[r * D.LD + d]);
  }
}

// The dz tile of rows q0.. and keys k0.. from the scratch (f32, 16-byte
// copies: one a thread).
__device__ __forceinline__ void copy_dz(const float* dz, size_t row0,
                                        int TP, int k0, float* s) {
  const int r = threadIdx.x >> 3, e = (threadIdx.x & 7) * 4;
  cp_async16(s + r * LS + e, dz + (row0 + r) * TP + k0 + e, true);
}

// Query pass: one block per (query tile, bh, column chunk); dq_u and du of
// its 32 rows in that chunk, [dq_u ; du] = dz·[k ; V] over the keys.
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
    rot_bwd_dq_wide_kernel(const T* __restrict__ k, const T* __restrict__ vt,
                           const int* __restrict__ kv_len,
                           const float* __restrict__ dz,
                           T* __restrict__ dqu_, T* __restrict__ du_,
                           Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) float smem[];
  float* K0 = smem;
  float* K1 = smem + (f32 ? BK * LKC : 0);
  float* Zb = smem + (f32 ? 2 : 1) * BK * LKC;
  void* raw = Zb + 2 * BQ * LS;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int ct0 = blockIdx.z * CHUNK_CT;
  const int ct1 = min(D.NCT, ct0 + CHUNK_CT);
  const int warp = threadIdx.x >> 5;
  // warp w owns row tile w & 1 and column tiles ct0 + (w >> 1) + NCG * i
  const int rt = warp & 1, cg = warp >> 1;
  const size_t base = (size_t)bh * D.T;
  const size_t zrow = (size_t)bh * D.TP + q0;
  const int kvl = max(0, min(kv_len[bh], D.T));
  const Cols<T> kc{k + base * D.dk, vt, D.dk, D.M, kvl, ct0 * TN,
                   (ct1 - ct0) * TN, LKC};
  // prefetch: the next tile's copies run while this one is computed
  const bool pre = f32 || D.raw != 0;
  const int ntiles = (kvl + BK - 1) / BK;

  if (ntiles > 0) {
    issue_cols<BK>(kc, 0, K0, raw, D);
    copy_dz(dz, zrow, D.TP, 0, Zb);
  }
  cp_async_commit();

  FragC acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    float* Kc = (t & 1) ? K1 : K0;
    float* Zc = Zb + (t & 1) * BQ * LS;
    if (!pre && t > 0) {
      __syncthreads();  // the previous step's readers are done
      copy_dz(dz, zrow, D.TP, k0, Zc);
      cp_async_commit();
    }
    cp_async_wait(0);
    __syncthreads();  // tile t has landed; step t-1's readers are done
    if constexpr (!f32) {
      land_cols<BK>(kc, k0, Kc, raw, D);
      __syncthreads();
    }
    if (pre && t + 1 < ntiles) {
      issue_cols<BK>(kc, k0 + BK, (t & 1) ? K0 : K1, raw, D);
      copy_dz(dz, zrow, D.TP, k0 + BK, Zb + ((t + 1) & 1) * BQ * LS);
      cp_async_commit();
    }
#pragma unroll
    for (int ks = 0; ks < BK / TK; ++ks) {
      Split<FragA<RowMajor>, NS> z;
      load_split(z, Zc + rt * TM * LS + ks * TK, LS);
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int ct = cg + NCG * i;
        if (ct0 + ct < ct1) {
          Split<FragB<RowMajor>, NS> kf;
          load_split(kf, Kc + ks * TK * LKC + ct * TN, LKC);
          mma_split(acc[i], z, kf);
        }
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();
  // written once: fragments -> the first key buffer -> the outputs
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int ct = cg + NCG * i;
    if (ct0 + ct < ct1)
      wmma::store_matrix_sync(K0 + rt * TM * LKC + ct * TN, acc[i], LKC,
                              wmma::mem_row_major);
  }
  __syncthreads();
  const int e0 = ct0 * TN, w = min(D.E, ct1 * TN) - e0;
  for (int idx = threadIdx.x; idx < BQ * w; idx += THREADS) {
    const int r = idx / w, e = idx - r * w, row = q0 + r;
    if (row >= D.T) continue;
    const float a = K0[r * LKC + e];
    if (e0 + e < D.dk)
      dqu_[(base + row) * D.dk + e0 + e] = from_f32<T>(a);
    else
      du_[(base + row) * D.M + (e0 + e - D.dk)] = from_f32<T>(a);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

template <typename T, bool WIDE>
int launch(const void* qu, const void* u, const void* k, const void* v,
           const void* vt, const int* kv_len, const void* out,
           const float* lse, const void* dout, float* delta, void* dqu,
           void* du, void* dk_, void* dv_, float* dz, int BH, int T_, int dk,
           int M, cudaStream_t stream) {
  Dims D;
  D.T = T_;
  D.dk = dk;
  D.M = M;
  D.E = dk + M;
  D.EP = (D.E + 15) / 16 * 16;
  D.DKP = (dk + 15) / 16 * 16;
  D.LQ = D.EP + 4;
  D.LD = D.DKP + 4;
  D.NKS = (D.E + 7) / 8;
  D.NDS = (dk + 7) / 8;
  D.H0 = min(D.NKS, (D.NKS + D.NDS + 1) / 2);
  D.NCT = D.EP / 16;
  D.NC = (D.E + DC - 1) / DC;
  D.TP = (T_ + 31) / 32 * 32;
  D.scale = 1.0f / sqrtf((float)dk);
  // cp.async copies: 16 bytes where every width and base allows, else 4
  // bytes (bf16 pairs); bf16 of odd width goes through registers
  const void* src[] = {qu, u, k, v, vt, dout};
  auto all = [&](uintptr_t n) {
    for (const void* p : src)
      if (!aligned(p, n)) return false;
    return true;
  };
  const int vec = 16 / (int)sizeof(T), pair = 4 / (int)sizeof(T);
  D.chunk = dk % vec == 0 && M % vec == 0 && all(16) ? vec
            : dk % pair == 0 && M % pair == 0 && all(4) ? pair
                                                        : 0;
  const bool f32 = std::is_same<T, float>::value;
  D.raw = !f32 && D.chunk > 0;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // f32 double-buffers the streamed tile, bf16 stages it raw; where that
  // does not fit, one buffer loaded at the top of each step (the wide
  // form: bf16 through registers)
  D.NBUF = f32 ? 2 : 1;
  auto bytes = [&](bool query) {
    return WIDE ? (query ? wide_query_smem_bytes(D, f32)
                         : wide_key_smem_bytes(D, f32))
                : smem_bytes(D);
  };
  if (std::max(bytes(false), bytes(true)) > (size_t)smem_max) {
    D.NBUF = 1;
    if (!f32) D.chunk = D.raw = 0;
  }
  const size_t smem = bytes(false), smem_q = bytes(true);

  const T* q = static_cast<const T*>(qu);
  const T* uu = static_cast<const T*>(u);
  const T* kk = static_cast<const T*>(k);
  const T* vv = static_cast<const T*>(v);
  const T* tt = static_cast<const T*>(vt);
  const T* g = static_cast<const T*>(dout);

  const int rows = BH * T_;
  rot_bwd_delta_kernel<T><<<(rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const T*>(out), g, delta, rows, dk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const dim3 grid_k((T_ + BK - 1) / BK, BH);
  const dim3 grid_q((T_ + BQ - 1) / BQ, BH,
                    (D.NCT + CHUNK_CT - 1) / CHUNK_CT);
  if constexpr (WIDE) {
    err = cudaFuncSetAttribute(rot_bwd_dkdv_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(rot_bwd_dq_wide_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_q);
    if (err != cudaSuccess) return (int)err;
    rot_bwd_dkdv_wide_kernel<T><<<grid_k, THREADS, smem, stream>>>(
        q, uu, kk, vv, tt, kv_len, lse, g, delta, static_cast<T*>(dk_),
        static_cast<T*>(dv_), dz, D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rot_bwd_dq_wide_kernel<T><<<grid_q, THREADS, smem_q, stream>>>(
        kk, tt, kv_len, dz, static_cast<T*>(dqu), static_cast<T*>(du), D);
    return (int)cudaGetLastError();
  } else {
    err = cudaFuncSetAttribute(rot_bwd_dkdv_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(rot_bwd_dq_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    rot_bwd_dkdv_kernel<T><<<grid_k, THREADS, smem, stream>>>(
        q, uu, kk, vv, tt, kv_len, lse, g, delta, static_cast<T*>(dk_),
        static_cast<T*>(dv_), D);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    rot_bwd_dq_kernel<T><<<grid_q, THREADS, smem, stream>>>(
        q, uu, kk, vv, tt, kv_len, lse, g, delta, static_cast<T*>(dqu),
        static_cast<T*>(du), D);
    return (int)cudaGetLastError();
  }
}

template <bool WIDE>
int entry(const void* qu, const void* u, const void* k, const void* v,
          const void* vt, const void* kv_len, const void* out,
          const void* lse, const void* dout, void* delta, void* dqu, void* du,
          void* dk, void* dv, void* dz, int BH, int T_, int dk_dim, int M,
          int is_bf16, void* stream) {
  if (dk_dim < 1 || dk_dim > (WIDE ? DK_MAX : DK_NARROW) || M < 0 ||
      T_ < 1 || BH < 1 || (WIDE && dz == nullptr))
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* z = static_cast<float*>(dz);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, WIDE>(qu, u, k, v, vt, kl, out, ls, dout,
                                       dl, dqu, du, dk, dv, z, BH, T_, dk_dim,
                                       M, st);
  return launch<float, WIDE>(qu, u, k, v, vt, kl, out, ls, dout, dl, dqu, du,
                             dk, dv, z, BH, T_, dk_dim, M, st);
}

}  // namespace

// Returns a cudaError_t code: 0 when every launch was accepted.  `delta`
// is f32 scratch of BH*T entries.  The narrow form: dk <= 64 and a
// [q_u ; u] row whose tiles fit a block.
extern "C" int lasr_rot_attention_bwd(
    const void* qu, const void* u, const void* k, const void* v,
    const void* vt, const void* kv_len, const void* out, const void* lse,
    const void* dout, void* delta, void* dqu, void* du, void* dk, void* dv,
    int BH, int T_, int dk_dim, int M, int is_bf16, void* stream) {
  return entry<false>(qu, u, k, v, vt, kv_len, out, lse, dout, delta, dqu,
                      du, dk, dv, nullptr, BH, T_, dk_dim, M, is_bf16,
                      stream);
}

// The wide form: dk <= 128, any M (the caller picks the form:
// ops/rot_attention.py, rot_kernel_wide); `dz` is f32 scratch of BH *
// T32 * T32 entries, T32 = T rounded up to 32.
extern "C" int lasr_rot_attention_bwd_wide(
    const void* qu, const void* u, const void* k, const void* v,
    const void* vt, const void* kv_len, const void* out, const void* lse,
    const void* dout, void* delta, void* dqu, void* du, void* dk, void* dv,
    void* dz, int BH, int T_, int dk_dim, int M, int is_bf16, void* stream) {
  return entry<true>(qu, u, k, v, vt, kv_len, out, lse, dout, delta, dqu, du,
                     dk, dv, dz, BH, T_, dk_dim, M, is_bf16, stream);
}
