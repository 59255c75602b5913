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
// Inputs are all f32 or all bf16; every sum accumulates in f32; gradients
// are written in the input type.  A row with kv_len == 0 has lse = +inf,
// so its P and every gradient it feeds are exact zeros.
//
// What bounds it on an H100: per (i, j) pair ~16 dk FLOP (the score's two
// products 4dk, dout·v 2dk, five dk-wide gradient products) against ~10 dk
// values of input and output per row: bound by arithmetic, and on the CUDA
// cores (67 TFLOP/s f32) that bound is ~2.5x what the tensor cores allow
// even as 3xTF32, so every product here runs on them.
//
// Design (tensor cores through WMMA, no atomics, bitwise repeatable):
//  - for a tile pair (32 query rows from q0, 32 keys from k0) the
//    rel-shift is an index remap between plain products.  The window
//    Pwin = p[h, r0 .. r0+63], r0 = T-1-q0-31+k0 (rows outside [0, 2T-2]
//    zero), gives W = q_v·Pwin^T (32 x 64) beside AC = q_u·k^T and
//    dPa = dout·v^T (32 x 32); query ii / key jj reads W[ii][31-ii+jj].
//    dz goes back the same way into dW[ii][31-ii+jj] (the rest of dW
//    zero), and dq_v = dW·Pwin, dPwin = dW^T·q_v are plain products again.
//    The TPU kernel's barrel-shifter rolls are Mosaic layout devices and
//    are not carried over.
//  - every product is an m16n16k8 TF32 WMMA tile (mma_tf32.cuh): 3xTF32
//    (f32 accuracy) for f32 inputs, one product for bf16 inputs, which
//    TF32 holds exactly.  Each tile's product starts from zero and is
//    added to its running sum in f32 registers: the tensor cores do not
//    round the sum they accumulate into to nearest, and over a long loop
//    that drift shows in training (K1's first version, PERF.md).
//  - the TPU kernel sums dk, dv and dp across sequential grid steps;
//    blocks here run in no order, so each pass owns what it writes:
//      key pass, grid (ceil(T/32), BH): one block per 32 keys keeps k and
//        v resident, streams every query tile and sums dk and dv;
//      query pass, grid (ceil(T/32), BH): one block per 32 query rows
//        keeps q_u, q_v and dout resident, streams the key tiles below
//        kv_len and sums dq_u and dq_v, and dp of its windows: consecutive
//        windows overlap by 31 rows, so a rolling 64-row sum in registers
//        is final for its lower 32 rows after each key tile; those rows go
//        to the block's own partial part[bh][q-tile] (f32, 32 (nq+1) rows);
//      a last kernel adds the partials of each dp row over the batch and
//        the query tiles in a fixed order.
//    A first tiny kernel writes delta[bh, i].
//  - per tile pair, warps 0-3 take a column tile of W, warps 4-7 one of
//    AC or dPa, each over both row tiles (a B fragment split once feeds
//    two products); the scores go to shared memory, where each element
//    becomes P and dz, and come back as fragments (P^T and dz^T load the
//    stored tile column-major, with no transposing copy).  The band
//    structure of dW (31-ii .. 62-ii) cuts the dq_v and dp products to the
//    6 of 8 depth steps that hold non-zeros.
//  - tiles are f32 in shared memory (bf16 is widened on the way in), zero-
//    padded to 16 columns (dk 40 -> 48) with a row stride of width + 4
//    floats; keys are loaded only below kv_len, rows past T are zero.  The
//    streamed tiles' copies (tile_io.cuh) run while the current pair is
//    computed: f32 by cp.async into the other of two buffers, bf16 by
//    cp.async into raw staging tiles widened at the top of the next step
//    (bf16 of odd width through registers).  The window is a ring of three
//    32-row halves: each step loads one new half, not 64 rows.  About
//    92 KB of dynamic shared memory per block in f32, so two 8-warp blocks
//    share an SM (at most 128 registers a thread): one block's copies,
//    barriers and element work overlap the other's products.
//  - wide heads (64 < dk <= 128, the 1B config's dk = 80): the score
//    products run 10-16 depth steps, and the 2 x ceil(dk/16) output tiles
//    of each pass (10 at dk = 80, 16 at 128) outnumber the 8 warps, so a
//    warp owns two (its running sums for both in registers: one block per
//    SM, up to 255 registers a thread); ~204 KB of shared memory at
//    dk = 128 in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_tf32.cuh"
#include "tile_io.cuh"

namespace {

using namespace lasr_mma;
using namespace lasr_tile;

constexpr int BQ = 32;           // query rows per tile
constexpr int BK = 32;           // keys per tile
constexpr int HALF = 32;         // rows of a window half
constexpr int THREADS = 32 * NWARPS;
constexpr int MIN_BLOCKS = 2;    // blocks per SM: at most 128 registers
constexpr int LS = BK + 4;       // row stride of the AC / dPa (P, dz) tiles
constexpr int LW = 2 * HALF + 4; // row stride of the W (dW) tile
constexpr int DK_MAX = 128;      // at most 2 x 8 output tiles, two a warp

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// delta[row] = dout[row]·out[row]; one warp per row.
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
  int T, dk, H, P;  // P = 2T - 1 rows of the positional table
  int DKP, LD;      // dk rounded up to 16; row stride DKP + 4 of dk tiles
  int NDS;          // depth steps of the score products: ceil(dk / 8)
  int NQT;          // query (and key) tiles: ceil(T / 32)
  int LP;           // rows of a dp partial: 32 (NQT + 1)
  int chunk;        // elements per cp.async copy of a tile; 0: registers
  int raw;          // bf16 tiles are staged raw and widened in shared memory
  float scale;
};

// Shared memory of a pass: the dk tiles q_u (Qu), q_v (Qv), dout (DO), k
// (K), v (V) — the streamed ones in two buffers for f32 ([1] == [0] for
// bf16) — the ring of three window halves, the score tiles AC, W and DP,
// the query rows' lse (L) and delta (Dl) twice, and (query pass) a 16 x 16
// staging tile per warp for the dp rows.  bf16 copies land raw in RS (the
// streamed dk tiles: the key pass's q_u, q_v, dout or the query pass's k,
// v, 32 rows each) and RP (64 window rows), each row DKP wide.
struct Smem {
  float *Qu[2], *Qv[2], *DO[2], *K[2], *V[2];
  float *ring, *AC, *W, *DP, *L[2], *Dl[2], *stage;
  __nv_bfloat16 *RS, *RP;
};

__host__ __device__ __forceinline__ size_t smem_bytes(const Dims& D,
                                                      bool query, bool f32) {
  const int nbuf = f32 ? 2 : 1;
  const size_t tile = (size_t)BQ * D.LD;
  const size_t dk_tiles = query ? 3 + 2 * nbuf : 2 + 3 * nbuf;
  const size_t floats = (dk_tiles + 3) * tile + 2 * (size_t)BQ * LS +
                        (size_t)BQ * LW + 4 * BQ +
                        (query ? NWARPS * TM * TN : 0);
  const size_t raw_rows = (query ? 2 * BK : 3 * BQ) + 2 * HALF;
  return 4 * floats + (D.raw ? 2 * raw_rows * D.DKP : 0);
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

// query: the query pass (k, v streamed); else the key pass (q_u, q_v,
// dout streamed).  f32 tiles stream through two buffers.
__device__ __forceinline__ Smem carve(float* p, const Dims& D, bool query,
                                      bool f32) {
  const int tile = BQ * D.LD;
  const int nq = query || !f32 ? 1 : 2, nk = query && f32 ? 2 : 1;
  Smem s;
  take(p, s.Qu, tile, nq);
  take(p, s.Qv, tile, nq);
  take(p, s.DO, tile, nq);
  take(p, s.K, tile, nk);
  take(p, s.V, tile, nk);
  s.ring = p;
  p += 3 * tile;
  s.AC = p;
  s.W = s.AC + BQ * LS;
  s.DP = s.W + BQ * LW;
  p = s.DP + BQ * LS;
  take(p, s.L, BQ, 2);
  take(p, s.Dl, BQ, 2);
  s.stage = p;
  if (query) p += NWARPS * TM * TN;
  s.RS = reinterpret_cast<__nv_bfloat16*>(p);
  s.RP = s.RS + (query ? 2 * BK : 3 * BQ) * D.DKP;
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

__device__ __forceinline__ void add_to(FragC& acc, const FragC& x) {
#pragma unroll
  for (int t = 0; t < acc.num_elements; ++t) acc.x[t] += x.x[t];
}

// The score tiles of the tile pair into shared memory: W = Qv·Pwin^T
// (Plo / Phi: window rows 0-31 / 32-63), AC = Qu·K^T, DP = DO·V^T.  Warp
// w < 4 takes column tile w of W, warps 4-5 a column tile of AC, warps
// 6-7 one of DP, each over both row tiles: a B fragment loaded and split
// once feeds two products.
template <int NS, int NDSX>
__device__ __forceinline__ void scores(const float* Qu, const float* Qv,
                                       const float* DO, const float* K,
                                       const float* V, const float* Plo,
                                       const float* Phi, float* AC, float* W,
                                       float* DP, const Dims& D) {
  const int warp = threadIdx.x >> 5, c = warp & 1;
  const float* a = warp < 4 ? Qv : warp < 6 ? Qu : DO;
  const float* b = (warp < 2 ? Plo : warp < 4 ? Phi : warp < 6 ? K : V) +
                   c * TN * D.LD;
  float* out = warp < 4 ? W + warp * TN : (warp < 6 ? AC : DP) + c * TN;
  const int ld = warp < 4 ? LW : LS;
  FragC x0, x1;
  wmma::fill_fragment(x0, 0.f);
  wmma::fill_fragment(x1, 0.f);
#pragma unroll
  for (int ks = 0; ks < NDSX; ++ks) {
    if (ks < D.NDS) {
      Split<FragB<ColMajor>, NS> bf;
      Split<FragA<RowMajor>, NS> a0, a1;
      load_split(bf, b + ks * TK, D.LD);
      load_split(a0, a + ks * TK, D.LD);
      load_split(a1, a + TM * D.LD + ks * TK, D.LD);
      mma_split(x0, a0, bf);
      mma_split(x1, a1, bf);
    }
  }
  wmma::store_matrix_sync(out, x0, ld, wmma::mem_row_major);
  wmma::store_matrix_sync(out + TM * ld, x1, ld, wmma::mem_row_major);
}

// Each element (i, j) of the tile pair (a warp per row, a lane per key):
// s = AC[i][j] + W[i][31-i+j] (the rel-shift), P = exp(s·scale - lse[i])
// for key k0 + j below kv_len and query row i below nrows, dz = P (dPa[i]
// [j] - delta[i]) scale into AC.  The key pass keeps P in DP; the query
// pass writes dz back to dW[i][31-i+j] in W's place and zeroes the rest of
// dW's row (each element is read and written by one thread only).
template <bool QUERY>
__device__ __forceinline__ void softmax_step(float* AC, float* W, float* DP,
                                             const float* L, const float* Dl,
                                             int k0, int kvl, int nrows,
                                             float scale) {
  for (int idx = threadIdx.x; idx < BQ * BK; idx += THREADS) {
    const int i = idx / BK, j = idx % BK;
    const int o = i * LS + j, w = i * LW + (BQ - 1) - i + j;
    const float s = AC[o] + W[w];
    const float p =
        k0 + j < kvl && i < nrows ? expf(s * scale - L[i]) : 0.f;
    const float z = p * (DP[o] - Dl[i]) * scale;
    AC[o] = z;
    if constexpr (QUERY) {
      W[w] = z;
      W[i * LW + (j < BQ - 1 - i ? j : j + BK)] = 0.f;
    } else {
      DP[o] = p;
    }
  }
}

// The warp's 16 x 16 fragment f to rows out[0 .. 15] (row stride dk),
// columns col0 .. col0+15 below dk, through its staging tile.
__device__ __forceinline__ void flush_rows(const FragC& f, float* stage,
                                           float* out, int col0, int dk) {
  const int lane = threadIdx.x & 31;
  wmma::store_matrix_sync(stage, f, TN, wmma::mem_row_major);
  __syncwarp();
#pragma unroll
  for (int e = lane; e < TM * TN; e += 32) {
    const int c = col0 + (e & (TN - 1));
    if (c < dk) out[(size_t)(e / TN) * dk + c] = stage[e];
  }
  __syncwarp();
}

// Key pass: one block per (key tile, bh); dk and dv of its 32 keys.  The
// window of query tile t is rows G(t+1) (lower half) and G(t) (upper) with
// G(h) = p rows from T + k0 - 32h; G(h) lives in ring slot 2 - h % 3, so
// G(1), G(0) sit in slots 1, 2 in row order for the first 64-row copy.
// NDSX: depth steps of the score products (ceil(dk / 8) <= NDSX); above 8
// a warp owns two output tiles.
template <typename T, int NDSX>
__global__ void __launch_bounds__(THREADS, NDSX > 8 ? 1 : MIN_BLOCKS)
    rel_bwd_dkdv_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                        const T* __restrict__ k, const T* __restrict__ v,
                        const T* __restrict__ p,
                        const int* __restrict__ kv_len,
                        const float* __restrict__ lse,
                        const T* __restrict__ dout,
                        const float* __restrict__ delta, T* __restrict__ dk_,
                        T* __restrict__ dv_, Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  constexpr int NOWN = NDSX > 8 ? 2 : 1;  // output tiles a warp owns
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) float smem[];
  const Smem sm = carve(smem, D, false, f32);
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const int kvl = max(0, min(kv_len[bh], D.T));
  const int tile = BQ * D.LD;
  // tile u < 2 * ndt is column tile u % ndt of dv (u < ndt) or of dk,
  // both row tiles (one B fragment feeds two products); warp w owns tiles
  // w + 8s, s < NOWN
  const int ndt = D.DKP / TN;
  bool owner[NOWN], is_dk[NOWN];
  int dt[NOWN];
#pragma unroll
  for (int s = 0; s < NOWN; ++s) {
    const int u = warp + NWARPS * s;
    owner[s] = u < 2 * ndt;
    is_dk[s] = u >= ndt;
    dt[s] = u % ndt;
  }
  const Src<T> su{qu + base * D.dk, qu, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> sv{qv + base * D.dk, qv, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> sg{dout + base * D.dk, dout, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> sk{k + base * D.dk, k, D.dk, 0, kvl, D.DKP, D.LD};
  const Src<T> sn{v + base * D.dk, v, D.dk, 0, kvl, D.DKP, D.LD};
  const T* ph = p + (size_t)(bh % D.H) * D.P * D.dk;
  const Src<T> sp{ph, ph, D.dk, 0, D.P, D.DKP, D.LD};
  auto slot = [&](int h) { return sm.ring + (2 - h % 3) * tile; };
  auto grow = [&](int h) { return D.T + k0 - HALF * h; };

  // rows 0-15 and 16-31 of each of the warp's dv or dk tiles
  FragC acc0[NOWN], acc1[NOWN];
#pragma unroll
  for (int s = 0; s < NOWN; ++s) {
    wmma::fill_fragment(acc0[s], 0.f);
    wmma::fill_fragment(acc1[s], 0.f);
  }
  if (k0 < kvl) {
    load_resident<BK>(sk, k0, sm.K[0], D);
    load_resident<BK>(sn, k0, sm.V[0], D);
    issue<BQ>(su, 0, sm.Qu[0], sm.RS, D);
    issue<BQ>(sv, 0, sm.Qv[0], sm.RS + BQ * D.DKP, D);
    issue<BQ>(sg, 0, sm.DO[0], sm.RS + 2 * BQ * D.DKP, D);
    issue<2 * HALF>(sp, grow(1), slot(1), sm.RP, D);
    fetch_row_stats(lse, delta, base, 0, D.T, sm.L[0], sm.Dl[0]);
    cp_async_commit();
    for (int t = 0; t < D.NQT; ++t) {
      const int q0 = t * BQ;
      // this step's buffers and the next one's (selects, not indexing,
      // keep the pointer pairs in registers)
      const bool odd = f32 && (t & 1);
      float* Quc = odd ? sm.Qu[1] : sm.Qu[0];
      float* Qvc = odd ? sm.Qv[1] : sm.Qv[0];
      float* DOc = odd ? sm.DO[1] : sm.DO[0];
      float* Lc = (t & 1) ? sm.L[1] : sm.L[0];
      float* Dlc = (t & 1) ? sm.Dl[1] : sm.Dl[0];
      cp_async_wait(0);
      __syncthreads();  // tile t has landed; step t-1's readers are done
      if constexpr (!f32) {
        land<BQ>(su, q0, sm.Qu[0], sm.RS, D);
        land<BQ>(sv, q0, sm.Qv[0], sm.RS + BQ * D.DKP, D);
        land<BQ>(sg, q0, sm.DO[0], sm.RS + 2 * BQ * D.DKP, D);
        if (t == 0)
          land<2 * HALF>(sp, grow(1), slot(1), sm.RP, D);
        else
          land<HALF>(sp, grow(t + 1), slot(t + 1), sm.RP, D);
        __syncthreads();
      }
      // the next step's copies run while this one is computed (issue does
      // nothing where bf16 goes through registers: land loads it then)
      if (t + 1 < D.NQT) {
        issue<BQ>(su, q0 + BQ, odd ? sm.Qu[0] : sm.Qu[1], sm.RS, D);
        issue<BQ>(sv, q0 + BQ, odd ? sm.Qv[0] : sm.Qv[1],
                  sm.RS + BQ * D.DKP, D);
        issue<BQ>(sg, q0 + BQ, odd ? sm.DO[0] : sm.DO[1],
                  sm.RS + 2 * BQ * D.DKP, D);
        issue<HALF>(sp, grow(t + 2), slot(t + 2), sm.RP, D);
        fetch_row_stats(lse, delta, base, q0 + BQ, D.T,
                        (t & 1) ? sm.L[0] : sm.L[1],
                        (t & 1) ? sm.Dl[0] : sm.Dl[1]);
        cp_async_commit();
      }
      scores<NS, NDSX>(Quc, Qvc, DOc, sm.K[0], sm.V[0], slot(t + 1),
                       slot(t), sm.AC, sm.W, sm.DP, D);
      __syncthreads();
      softmax_step<false>(sm.AC, sm.W, sm.DP, Lc, Dlc, k0, kvl, D.T - q0,
                          D.scale);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < NOWN; ++s) {
        if (!owner[s]) continue;
        // dv += P^T·dout or dk += dz^T·q_u over the tile's 32 query rows
        const float* at = is_dk[s] ? sm.AC : sm.DP;
        const float* bt = (is_dk[s] ? Quc : DOc) + dt[s] * TN;
        FragC t0, t1;
        wmma::fill_fragment(t0, 0.f);
        wmma::fill_fragment(t1, 0.f);
#pragma unroll
        for (int ks = 0; ks < BQ / TK; ++ks) {
          Split<FragB<RowMajor>, NS> bf;
          Split<FragA<ColMajor>, NS> a0, a1;
          load_split(bf, bt + ks * TK * D.LD, D.LD);
          load_split(a0, at + ks * TK * LS, LS);
          load_split(a1, at + ks * TK * LS + TM, LS);
          mma_split(t0, a0, bf);
          mma_split(t1, a1, bf);
        }
        add_to(acc0[s], t0);
        add_to(acc1[s], t1);
      }
    }
  }
  cp_async_wait(0);
  __syncthreads();
  float* sdv = sm.Qu[0];
  float* sdk = sm.Qv[0];
#pragma unroll
  for (int s = 0; s < NOWN; ++s) {
    if (!owner[s]) continue;
    float* o = (is_dk[s] ? sdk : sdv) + dt[s] * TN;
    wmma::store_matrix_sync(o, acc0[s], D.LD, wmma::mem_row_major);
    wmma::store_matrix_sync(o + TM * D.LD, acc1[s], D.LD,
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

// Query pass: one block per (query tile, bh); dq_u and dq_v of its 32
// rows, and its windows' dp rows into part[bh][q-tile] (row m of it is p
// row T - 32 - q0 + m).  The window of key tile t is rows G(t) (lower
// half) and G(t+1) (upper) with G(h) = p rows from T - 32 - q0 + 32h, in
// ring slot h % 3.
template <typename T, int NDSX>
__global__ void __launch_bounds__(THREADS, NDSX > 8 ? 1 : MIN_BLOCKS)
    rel_bwd_dq_kernel(const T* __restrict__ qu, const T* __restrict__ qv,
                      const T* __restrict__ k, const T* __restrict__ v,
                      const T* __restrict__ p, const int* __restrict__ kv_len,
                      const float* __restrict__ lse,
                      const T* __restrict__ dout,
                      const float* __restrict__ delta, T* __restrict__ dqu_,
                      T* __restrict__ dqv_, float* __restrict__ part,
                      Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  constexpr int NOWN = NDSX > 8 ? 2 : 1;  // output tiles a warp owns
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) float smem[];
  const Smem sm = carve(smem, D, true, f32);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const int kvl = max(0, min(kv_len[bh], D.T));
  const int tile = BQ * D.LD;
  // tile u < 2 * ndt is the 16 x 16 tile (rt, ct) = (u / ndt, u % ndt) of
  // dq_u and of dq_v, with rows rt and rt + 2 (16 each) of the rolling dp
  // window in column tile ct; warp w owns tiles w + 8s, s < NOWN
  const int ndt = D.DKP / TN;
  bool owner[NOWN];
  int rt[NOWN], ct[NOWN];
#pragma unroll
  for (int s = 0; s < NOWN; ++s) {
    const int u = warp + NWARPS * s;
    owner[s] = u < (BQ / TM) * ndt;
    rt[s] = u / ndt;
    ct[s] = u % ndt;
  }
  const Src<T> su{qu + base * D.dk, qu, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> sv{qv + base * D.dk, qv, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> sg{dout + base * D.dk, dout, D.dk, 0, D.T, D.DKP, D.LD};
  const Src<T> sk{k + base * D.dk, k, D.dk, 0, kvl, D.DKP, D.LD};
  const Src<T> sn{v + base * D.dk, v, D.dk, 0, kvl, D.DKP, D.LD};
  const T* ph = p + (size_t)(bh % D.H) * D.P * D.dk;
  const Src<T> sp{ph, ph, D.dk, 0, D.P, D.DKP, D.LD};
  auto slot = [&](int h) { return sm.ring + (h % 3) * tile; };
  auto grow = [&](int h) { return D.T - HALF - q0 + HALF * h; };
  const int ntiles = (kvl + BK - 1) / BK;
  float* const out_part =
      part + ((size_t)bh * D.NQT + blockIdx.x) * D.LP * D.dk;
  float* stage = sm.stage + warp * TM * TN;

  load_resident<BQ>(su, q0, sm.Qu[0], D);
  load_resident<BQ>(sv, q0, sm.Qv[0], D);
  load_resident<BQ>(sg, q0, sm.DO[0], D);
  fetch_row_stats(lse, delta, base, q0, D.T, sm.L[0], sm.Dl[0]);
  if (ntiles > 0) {
    issue<BK>(sk, 0, sm.K[0], sm.RS, D);
    issue<BK>(sn, 0, sm.V[0], sm.RS + BK * D.DKP, D);
    issue<2 * HALF>(sp, grow(0), slot(0), sm.RP, D);
  }
  cp_async_commit();

  // running sums: dq_u, dq_v, and the rolling dp rows (lo: window rows
  // 16 rt.., final after this key tile; hi: rows 32 + 16 rt..)
  FragC au[NOWN], av[NOWN], lo[NOWN], hi[NOWN];
#pragma unroll
  for (int s = 0; s < NOWN; ++s) {
    wmma::fill_fragment(au[s], 0.f);
    wmma::fill_fragment(av[s], 0.f);
    wmma::fill_fragment(lo[s], 0.f);
    wmma::fill_fragment(hi[s], 0.f);
  }
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    const bool odd = f32 && (t & 1);
    float* Kc = odd ? sm.K[1] : sm.K[0];
    float* Vc = odd ? sm.V[1] : sm.V[0];
    cp_async_wait(0);
    __syncthreads();  // tile t has landed; step t-1's readers are done
    if constexpr (!f32) {
      land<BK>(sk, k0, sm.K[0], sm.RS, D);
      land<BK>(sn, k0, sm.V[0], sm.RS + BK * D.DKP, D);
      if (t == 0)
        land<2 * HALF>(sp, grow(0), slot(0), sm.RP, D);
      else
        land<HALF>(sp, grow(t + 1), slot(t + 1), sm.RP, D);
      __syncthreads();
    }
    if (t + 1 < ntiles) {
      issue<BK>(sk, k0 + BK, odd ? sm.K[0] : sm.K[1], sm.RS, D);
      issue<BK>(sn, k0 + BK, odd ? sm.V[0] : sm.V[1], sm.RS + BK * D.DKP,
                D);
      issue<HALF>(sp, grow(t + 2), slot(t + 2), sm.RP, D);
      cp_async_commit();
    }
    const float* Plo = slot(t);
    const float* Phi = slot(t + 1);
    scores<NS, NDSX>(sm.Qu[0], sm.Qv[0], sm.DO[0], Kc, Vc, Plo, Phi, sm.AC,
                     sm.W, sm.DP, D);
    __syncthreads();
    softmax_step<true>(sm.AC, sm.W, sm.DP, sm.L[0], sm.Dl[0], k0, kvl,
                       D.T - q0, D.scale);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < NOWN; ++s) {
      if (!owner[s]) continue;
      const int rts = rt[s], cts = ct[s];
      // each product from zero, then added to its running sum (one
      // temporary fragment live at a time)
      FragC tmp;
      // dq_u += dz·k over the tile's 32 keys
      wmma::fill_fragment(tmp, 0.f);
#pragma unroll
      for (int ks = 0; ks < BK / TK; ++ks) {
        Split<FragA<RowMajor>, NS> a;
        Split<FragB<RowMajor>, NS> b;
        load_split(a, sm.AC + rts * TM * LS + ks * TK, LS);
        load_split(b, Kc + ks * TK * D.LD + cts * TN, D.LD);
        mma_split(tmp, a, b);
      }
      add_to(au[s], tmp);
      // dq_v += dW·Pwin over the 48 window rows where row tile rt of dW
      // has non-zeros (rt 0: rows 16-63, rt 1: rows 0-47)
      wmma::fill_fragment(tmp, 0.f);
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const int ks = j + (rts == 0 ? 2 : 0);
        Split<FragA<RowMajor>, NS> a;
        Split<FragB<RowMajor>, NS> b;
        load_split(a, sm.W + rts * TM * LW + ks * TK, LW);
        load_split(b, (ks < 4 ? Plo : Phi) + (ks & 3) * TK * D.LD + cts * TN,
                   D.LD);
        mma_split(tmp, a, b);
      }
      add_to(av[s], tmp);
      // dPwin rows of tile R = dW^T·q_v over the query rows where column
      // tile R of dW has non-zeros (R 0: rows 16-31, R 3: rows 0-15, R 1
      // and 2: all): lo += tile rt, hi += tile rt + 2
      const int lo0 = rts == 0 ? 2 : 0, hi1 = rts == 0 ? 4 : 2;
      FragC thi;
      wmma::fill_fragment(tmp, 0.f);
      wmma::fill_fragment(thi, 0.f);
#pragma unroll
      for (int ks = 0; ks < BQ / TK; ++ks) {
        Split<FragB<RowMajor>, NS> b;
        load_split(b, sm.Qv[0] + ks * TK * D.LD + cts * TN, D.LD);
        if (ks >= lo0) {
          Split<FragA<ColMajor>, NS> a;
          load_split(a, sm.W + ks * TK * LW + rts * TM, LW);
          mma_split(tmp, a, b);
        }
        if (ks < hi1) {
          Split<FragA<ColMajor>, NS> a;
          load_split(a, sm.W + ks * TK * LW + (rts + 2) * TM, LW);
          mma_split(thi, a, b);
        }
      }
      add_to(lo[s], tmp);
      add_to(hi[s], thi);
      // rows 32t + 16rt .. of the partial are final: out, then roll
      flush_rows(lo[s], stage,
                 out_part + ((size_t)rts * TM + k0) * D.dk, cts * TN, D.dk);
      lo[s] = hi[s];
      wmma::fill_fragment(hi[s], 0.f);
    }
  }
#pragma unroll
  for (int s = 0; s < NOWN; ++s)
    if (owner[s])
      flush_rows(lo[s], stage,
                 out_part + ((size_t)rt[s] * TM + ntiles * BK) * D.dk,
                 ct[s] * TN, D.dk);
  cp_async_wait(0);
  __syncthreads();
  // written once: fragments -> the K / V tiles' place -> the outputs
  float* squ = sm.K[0];
  float* sqv = sm.V[0];
#pragma unroll
  for (int s = 0; s < NOWN; ++s) {
    if (!owner[s]) continue;
    wmma::store_matrix_sync(squ + rt[s] * TM * D.LD + ct[s] * TN, au[s],
                            D.LD, wmma::mem_row_major);
    wmma::store_matrix_sync(sqv + rt[s] * TM * D.LD + ct[s] * TN, av[s],
                            D.LD, wmma::mem_row_major);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BQ * D.dk; idx += THREADS) {
    const int r = idx / D.dk, d = idx - r * D.dk, row = q0 + r;
    if (row >= D.T) continue;
    dqu_[(base + row) * D.dk + d] = from_f32<T>(squ[r * D.LD + d]);
    dqv_[(base + row) * D.dk + d] = from_f32<T>(sqv[r * D.LD + d]);
  }
}

// dp[h][r][d] = sum over b, then query tile qt, of part[b*H + h][qt][m][d]
// with m = r - (T - 32 - 32 qt), over the rows that the query pass wrote
// (m < 32 (ceil(kv_len / 32) + 1)); a fixed order, so bitwise repeatable.
template <typename T>
__global__ void rel_bwd_dp_reduce_kernel(const float* __restrict__ part,
                                         const int* __restrict__ kv_len,
                                         T* __restrict__ dp, int B, Dims D) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= D.H * D.P * D.dk) return;
  const int h = idx / (D.P * D.dk);
  const int rd = idx - h * D.P * D.dk;
  const int r = rd / D.dk, d = rd - r * D.dk;
  const int c = D.T - HALF - r;  // m = 32 qt - c
  const int qlo = c <= 0 ? 0 : (c + HALF - 1) / HALF;
  float a = 0.f;
  for (int b = 0; b < B; ++b) {
    const int bh = b * D.H + h;
    const int kvl = max(0, min(kv_len[bh], D.T));
    const int mlim = HALF * ((kvl + BK - 1) / BK + 1);
    const int x = mlim + c;
    const int qhi = x <= 0 ? 0 : min(D.NQT, (x + HALF - 1) / HALF);
    const float* pb = part + (size_t)bh * D.NQT * D.LP * D.dk + d;
#pragma unroll 4
    for (int qt = qlo; qt < qhi; ++qt)
      a += pb[((size_t)qt * D.LP + HALF * qt - c) * D.dk];
  }
  dp[idx] = from_f32<T>(a);
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

// The key and query passes, their q fragments of NDSX depth steps.
template <typename T, int NDSX>
int run_passes(const T* a, const T* b, const T* kk, const T* vv,
               const T* pp, const int* kv_len, const float* lse,
               const T* g, const float* delta, float* part, void* dqu,
               void* dqv, void* dk_, void* dv_, int BH, const Dims& D,
               cudaStream_t stream) {
  const bool f32 = std::is_same<T, float>::value;
  const size_t smem_k = smem_bytes(D, false, f32);
  const size_t smem_q = smem_bytes(D, true, f32);
  cudaError_t err = cudaFuncSetAttribute(
      rel_bwd_dkdv_kernel<T, NDSX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_k);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rel_bwd_dq_kernel<T, NDSX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_q);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(D.NQT, BH);
  rel_bwd_dkdv_kernel<T, NDSX><<<grid, THREADS, smem_k, stream>>>(
      a, b, kk, vv, pp, kv_len, lse, g, delta, static_cast<T*>(dk_),
      static_cast<T*>(dv_), D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_bwd_dq_kernel<T, NDSX><<<grid, THREADS, smem_q, stream>>>(
      a, b, kk, vv, pp, kv_len, lse, g, delta, static_cast<T*>(dqu),
      static_cast<T*>(dqv), part, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* qu, const void* qv, const void* k, const void* v,
           const void* p, const int* kv_len, const void* out,
           const float* lse, const void* dout, float* delta, float* part,
           void* dqu, void* dqv, void* dk_, void* dv_, void* dp, int BH,
           int T_, int dk, int H, cudaStream_t stream) {
  Dims D;
  D.T = T_;
  D.dk = dk;
  D.H = H;
  D.P = 2 * T_ - 1;
  D.DKP = (dk + 15) / 16 * 16;
  D.LD = D.DKP + 4;
  D.NDS = (dk + 7) / 8;
  D.NQT = (T_ + BQ - 1) / BQ;
  D.LP = HALF * (D.NQT + 1);
  D.scale = 1.0f / sqrtf((float)dk);
  // cp.async copies: 16 bytes where the width and every base allow, else
  // 4 bytes (f32 always, bf16 pairs); bf16 of odd width goes through
  // registers
  const void* src[] = {qu, qv, k, v, p, dout};
  auto all = [&](uintptr_t n) {
    for (const void* s : src)
      if (!aligned(s, n)) return false;
    return true;
  };
  const int vec = 16 / (int)sizeof(T), pair = 4 / (int)sizeof(T);
  D.chunk = dk % vec == 0 && all(16)    ? vec
            : dk % pair == 0 && all(4) ? pair
                                       : 0;
  const bool f32 = std::is_same<T, float>::value;
  D.raw = !f32 && D.chunk > 0;
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

  // wide heads (dk > 64): 16 depth steps, two output tiles a warp
  err = (cudaError_t)(D.NDS <= 8
                          ? run_passes<T, 8>(a, b, kk, vv, pp, kv_len, lse,
                                             g, delta, part, dqu, dqv, dk_,
                                             dv_, BH, D, stream)
                          : run_passes<T, 16>(a, b, kk, vv, pp, kv_len, lse,
                                              g, delta, part, dqu, dqv, dk_,
                                              dv_, BH, D, stream));
  if (err != cudaSuccess) return (int)err;
  const int n = H * D.P * dk;
  rel_bwd_dp_reduce_kernel<T><<<(n + 255) / 256, 256, 0, stream>>>(
      part, kv_len, static_cast<T*>(dp), BH / H, D);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when every launch was accepted.  Scratch:
// `delta` f32 (BH*T), `part` f32 (BH, ceil(T/32), 32 (ceil(T/32) + 1), dk).
extern "C" int lasr_rel_attention_bwd(
    const void* qu, const void* qv, const void* k, const void* v,
    const void* p, const void* kv_len, const void* out, const void* lse,
    const void* dout, void* delta, void* part, void* dqu, void* dqv,
    void* dk, void* dv, void* dp, int BH, int T_, int dk_dim, int H,
    int is_bf16, void* stream) {
  if (dk_dim < 1 || dk_dim > DK_MAX || H < 1 || BH % H != 0 || T_ < 1 ||
      BH < 1)
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* pt = static_cast<float*>(part);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(qu, qv, k, v, p, kl, out, ls, dout, dl, pt,
                                 dqu, dqv, dk, dv, dp, BH, T_, dk_dim, H, st);
  return launch<float>(qu, qv, k, v, p, kl, out, ls, dout, dl, pt, dqu, dqv,
                       dk, dv, dp, BH, T_, dk_dim, H, st);
}
