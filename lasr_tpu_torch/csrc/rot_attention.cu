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
// lanes per (i, j) pair at the served shape (dk=40, M=320), ~2(dk+M) + 2dk
// = 800 FLOP per pair against a few hundred bytes per row: bound by
// arithmetic.  On the CUDA cores (67 TFLOP/s f32) that bound is ~2.5x what
// the tensor cores allow even as 3xTF32, so both products run on them.
//
// Design (tensor cores through WMMA, the tile pipeline of the backward
// kernel's query pass):
//  - both products, S = [q_u ; u]·[k ; V]^T and P·v, are m16n16k8 TF32
//    WMMA tiles (mma_tf32.cuh): 3xTF32 (f32 accuracy) for f32 inputs, one
//    product for bf16 inputs, which TF32 holds exactly (P is rounded to
//    bf16 first, so it is exact in TF32 too).
//  - grid (ceil(T/32), BH), 8 warps: a block keeps its 32 rows of
//    [q_u ; u] resident and walks the 32-key tiles below kv_len (this loop
//    replaces the TPU's sequential grid axis).  Per key tile:
//      scores:  warp w sums the whole 32 x 32 S (2 x 2 tiles) over its
//               eighth of the depth steps into partial w (shared memory),
//               so each fragment it loads and splits feeds two products;
//      softmax: 8 threads own a row, 4 keys each: s = (the sum of the 8
//               partials)·scale masked at kv_len, the running max m and
//               sum l (of the unrounded p, in registers), P rounded to the
//               input type (what the TPU kernel does with
//               prob.astype(v.dtype)) into a shared tile and the row's
//               rescale alpha beside it;
//      P·v:     warp w < 2·ceil(dk/16) owns one 16 x 16 tile of PV, the
//               key tile's P·v summed from zero over its 32 keys; then
//               every thread updates its elements of the 32 x dk
//               accumulator O, held in registers: O = O·alpha + PV, in f32
//               (see pv_step for why not in an accumulator fragment).
//    out = O / l and lse = m + log l at the end.
//  - tiles are f32 in shared memory (bf16 is widened on the way in, so
//    both types take one path), zero-padded to 16 columns (E 360 -> 368,
//    dk 40 -> 48) with a row stride of width + 4 floats; keys are loaded
//    only below kv_len, rows past T are zero.  Every loaded tile holds key
//    k0 < kv_len, so the running max is finite after the first tile.
//  - the next key tile's copies (tile_io.cuh) run while the current one is
//    computed: f32 by cp.async into the other of two buffers, bf16 raw
//    into a staging tile widened in shared memory.  At dk=40, M=320:
//    204,544 B of dynamic shared memory in f32, 176,896 B in bf16
//    (cudaFuncSetAttribute), so one block per SM; one buffer where that
//    does not fit.
//  - the TPU's 128-lane padding of dk and M is a layout artefact of the
//    MXU and is not carried over.
//  - wide form (dk > 64, or a [q_u ; u] row too wide for the tiles above
//    to fit a block: the 1B config's dk = 80, M = 1280 needs 412 KB), a
//    template branch, so dk <= 64 at the recipe's M compiles as before:
//    the depth of S streams in chunks of DC = 128 columns.  Step (t, c)
//    copies column chunk c of the block's [q_u ; u] rows and of key tile
//    t's [k ; V] rows (and, at c = 0, the tile's v) through a ring of NST
//    = 3 stages, NST - 1 steps ahead (f32 by cp.async; bf16 staged raw and
//    widened into one f32 stage, or through registers at odd widths);
//    each warp sums its 2 x 2 S fragments over its eighth of every
//    chunk's depth steps in registers across the tile's chunks, and
//    stores them as its partial after the last one.  The query chunks are
//    read again for each key tile (from L2: the block's rows are 174 KB at
//    E = 1360 in f32) and V's rows are one (T, M) table for every bh.  A
//    warp owns up to two 16 x 16 tiles of PV (2 x 8 at dk = 128), written
//    over the S partials once the softmax has read them; O stays in f32
//    registers (16 a thread at dk = 128).  Shared memory no longer grows
//    with M: 193,792 B at dk = 128 in f32, 166,144 B in bf16.

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

constexpr int BQ = 32;       // query rows per block
constexpr int BK = 32;       // keys per tile: 4 per thread in the softmax
constexpr int THREADS = 32 * NWARPS;
constexpr int LS = BK + 4;   // row stride of the S partials and P
static_assert(BQ * 8 == THREADS && BK == 8 * 4, "softmax: 8 threads a row");
constexpr int DK_NARROW = 64;  // at most 2 x 4 output tiles of PV, one a warp
constexpr int DK_MAX = 128;    // wide form: 2 x 8, two a warp
constexpr int DC = 128;        // wide form: columns of a depth chunk
constexpr int LC = DC + 4;     // its row stride
constexpr int NST = 3;         // its ring's stages

// max / sum over the 8 threads of a query row (lanes 8r .. 8r+7)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

struct Dims {
  int T, dk, M, E;
  int EP, DKP;  // E and dk rounded up to 16
  int LQ, LD;   // row strides EP + 4, DKP + 4 of the wide and dk tiles
  int NKS;      // depth steps of S: ceil(E / 8)
  int NC;       // wide form: depth chunks of S, ceil(E / DC)
  int NBUF;     // f32 buffers of the key tile: 2, or 1 (see launch)
  int chunk;    // elements per cp.async copy of a tile; 0: registers
  int raw;      // bf16 tiles are staged raw and widened in shared memory
  float scale;
};

// Shared memory: the resident [q_u ; u] tile Q, NBUF buffers of the key
// tiles [k ; V] (K) and v (V) ([1] == [0] for one), the NWARPS partials
// of S, the probabilities P, the key tile's P·v (PV), and per query row
// alpha (A) and 1 / l (IL).  bf16 copies land raw in RW / RN (row stride
// EP / DKP).
struct Smem {
  float *Q, *K[2], *V[2], *S, *P, *PV, *A, *IL;
  void *RW, *RN;
};

__host__ __device__ __forceinline__ size_t smem_bytes(const Dims& D) {
  const size_t floats = (size_t)BQ * D.LQ +
                        (size_t)D.NBUF * BK * (D.LQ + D.LD) +
                        (NWARPS + 1) * (size_t)BQ * LS + (size_t)BQ * D.LD +
                        2 * BQ;
  return 4 * floats + (D.raw ? 2 * (size_t)BK * (D.EP + D.DKP) : 0);
}

__device__ __forceinline__ Smem carve(float* p, const Dims& D) {
  Smem s;
  s.Q = p;
  p += BQ * D.LQ;
  s.K[0] = s.K[1] = p;
  p += BK * D.LQ;
  if (D.NBUF == 2) {
    s.K[1] = p;
    p += BK * D.LQ;
  }
  s.V[0] = s.V[1] = p;
  p += BK * D.LD;
  if (D.NBUF == 2) {
    s.V[1] = p;
    p += BK * D.LD;
  }
  s.S = p;
  s.P = s.S + NWARPS * BQ * LS;
  s.PV = s.P + BQ * LS;
  s.A = s.PV + BQ * D.LD;
  s.IL = s.A + BQ;
  s.RW = s.IL + BQ;
  s.RN = reinterpret_cast<unsigned short*>(s.RW) + BK * D.EP;
  return s;
}

// S = Q·K^T of the tile pair as NWARPS partials in shared memory: warp w
// sums all four 16 x 16 tiles of S over its own run of depth steps into
// partial w, so each fragment is loaded and split once for two products.
template <int NS>
__device__ __forceinline__ void scores(const float* Q, const float* K,
                                       float* S, const Dims& D) {
  const int warp = threadIdx.x >> 5;
  FragC acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const int ks1 = (warp + 1) * D.NKS / NWARPS;
  for (int ks = warp * D.NKS / NWARPS; ks < ks1; ++ks) {
    Split<FragA<RowMajor>, NS> a[2];
    Split<FragB<ColMajor>, NS> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      load_split(a[i], Q + i * TM * D.LQ + ks * TK, D.LQ);
      load_split(b[i], K + i * TN * D.LQ + ks * TK, D.LQ);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_split(acc[i][j], a[i], b[j]);
  }
  float* s = S + warp * BQ * LS;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(s + i * TM * LS + j * TN, acc[i][j], LS,
                              wmma::mem_row_major);
}

// The online softmax of the tile's rows over keys k0 .. k0+31: 8 threads
// per query row (row tid / 8, keys k0 + 4 (tid % 8) ..), each key valid
// below kv_len.  m and l of the row are updated in registers (the same in
// its 8 threads), P (rounded to T) goes into P and the row's rescale of
// its earlier sums into A.
template <typename T>
__device__ __forceinline__ void softmax_step(const float* S, float* P,
                                             float* A, float& m, float& l,
                                             int k0, int kvl, float scale) {
  const int i = threadIdx.x >> 3, j0 = (threadIdx.x & 7) * 4;
  const int o = i * LS + j0;
  float x[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int w = 0; w < NWARPS; ++w) {
    const float4 y = *reinterpret_cast<const float4*>(S + w * BQ * LS + o);
    x[0] += y.x;
    x[1] += y.y;
    x[2] += y.z;
    x[3] += y.w;
  }
  float mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    x[c] = k0 + j0 + c < kvl ? x[c] * scale : -INFINITY;
    mx = fmaxf(mx, x[c]);
  }
  const float m_new = fmaxf(m, row_max(mx));
  const float alpha = expf(m - m_new);
  float p[4], sum = 0.f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    p[c] = k0 + j0 + c < kvl ? expf(x[c] - m_new) : 0.f;
    sum += p[c];
    p[c] = to_f32(from_f32<T>(p[c]));
  }
  l = l * alpha + row_sum(sum);
  m = m_new;
  *reinterpret_cast<float4*>(P + o) = make_float4(p[0], p[1], p[2], p[3]);
  if (j0 == 0) A[i] = alpha;
}

// Tile (rt, dt) of PV = P·v over the key tile's 32 keys, from zero (one
// warp); o_update adds it to O in f32.  O is not carried across key tiles
// in an accumulator fragment: the tensor cores do not round the f32 sum
// they accumulate into to nearest, and over a whole key loop that drift
// showed in training (on an H100, chip_smoke.py's train_a: an encoder
// gradient 2.6e-3 of its largest entry off the plain path, against the
// gate's 1e-3; 1.5e-4 with O summed here).
template <int NS>
__device__ __forceinline__ void pv_step(const float* P, const float* V,
                                        float* PV, int rt, int dt,
                                        const Dims& D) {
  FragC acc;
  wmma::fill_fragment(acc, 0.f);
#pragma unroll
  for (int ks = 0; ks < BK / TK; ++ks) {
    Split<FragA<RowMajor>, NS> p;
    Split<FragB<RowMajor>, NS> b;
    load_split(p, P + rt * TM * LS + ks * TK, LS);
    load_split(b, V + ks * TK * D.LD + dt * TN, D.LD);
    mma_split(acc, p, b);
  }
  wmma::store_matrix_sync(PV + rt * TM * D.LD + dt * TN, acc, D.LD,
                          wmma::mem_row_major);
}

// O = O·alpha + PV for the thread's elements of the 32 x dk accumulator
// (element tid + THREADS·c is row e / dk, column e % dk).
template <int OPT>
__device__ __forceinline__ void o_update(float (&o)[OPT], const float* PV,
                                         const float* A, const Dims& D) {
#pragma unroll
  for (int c = 0; c < OPT; ++c) {
    const int e = threadIdx.x + THREADS * c, r = e / D.dk;
    if (r < BQ) o[c] = fmaf(o[c], A[r], PV[r * D.LD + (e - r * D.dk)]);
  }
}

// Wide form.  Shared memory: a ring of NST f32 stages (bf16: one, fs = 0),
// each a query chunk (BQ x LC), a key chunk (BK x LC) and a v tile (BK x
// LD, by key tile: tile t in stage t % NST); NST raw bf16 stages beside
// them (row strides the chunk's width and DKP); the NWARPS partials of S,
// the key tile's PV written over them; P, A and IL as in Smem.
struct WideSmem {
  float* F;           // f32 stage 0
  int fs;             // floats from one f32 stage to the next
  __nv_bfloat16* R;   // raw stage 0
  float *S, *P, *PV, *A, *IL;
};

__host__ __device__ __forceinline__ int wide_stage(const Dims& D) {
  return (BQ + BK) * LC + BK * D.LD;
}
__host__ __device__ __forceinline__ int raw_stage(const Dims& D) {
  return (BQ + BK) * DC + BK * D.DKP;
}

__host__ __device__ __forceinline__ size_t wide_smem_bytes(const Dims& D,
                                                           bool f32) {
  const size_t floats = (size_t)(f32 ? NST : 1) * wide_stage(D) +
                        (NWARPS + 1) * (size_t)BQ * LS + 2 * BQ;
  return 4 * floats + (D.raw ? 2 * (size_t)NST * raw_stage(D) : 0);
}

__device__ __forceinline__ WideSmem carve_wide(float* p, const Dims& D,
                                               bool f32) {
  WideSmem s;
  s.F = p;
  s.fs = f32 ? wide_stage(D) : 0;
  p += (f32 ? NST : 1) * wide_stage(D);
  s.S = s.PV = p;
  s.P = s.S + NWARPS * BQ * LS;
  s.A = s.P + BQ * LS;
  s.IL = s.A + BQ;
  s.R = reinterpret_cast<__nv_bfloat16*>(s.IL + BQ);
  return s;
}

// The columns of depth chunk c: DC, the last one's rounded up to 8.
__device__ __forceinline__ int chunk_width(const Dims& D, int c) {
  return min(DC, (D.E - c * DC + 7) / 8 * 8);
}

// The wide form's key loop over the block's query rows q0.. (kvl >= 1):
// m, l and O as the narrow loop leaves them.
template <typename T, int OPT>
__device__ __forceinline__ void wide_loop(
    const T* __restrict__ qu, const T* __restrict__ u,
    const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ vt, const WideSmem& sm, size_t base, int q0,
    int kvl, float (&o)[OPT], float& m, float& l, const Dims& D) {
  constexpr int NS = SplitsFor<T>::value;
  constexpr bool f32 = std::is_same<T, float>::value;
  const int warp = threadIdx.x >> 5;
  const int ntiles = (kvl + BK - 1) / BK, nsteps = ntiles * D.NC;
  const int ndt = D.DKP / TN;
  const Src<T> kn{v + base * D.dk, v, D.dk, 0, kvl, D.DKP, D.LD};
  // column chunk c of the block's [q_u ; u] rows and of the keys' [k ; V]
  auto qc = [&](int c) {
    return Cols<T>{qu + base * D.dk, u + base * D.M, D.dk, D.M, D.T,
                   c * DC, chunk_width(D, c), LC};
  };
  auto kc = [&](int c) {
    return Cols<T>{k + base * D.dk, vt, D.dk, D.M, kvl, c * DC,
                   chunk_width(D, c), LC};
  };
  // stage st's tiles: f32 query chunk, key chunk, v; their raw copies
  auto fq = [&](int st) { return sm.F + st * sm.fs; };
  auto rq = [&](int st) { return sm.R + st * raw_stage(D); };
  // step s = (key tile t, chunk c): its copies NST - 1 steps ahead
  auto issue_step = [&](int s) {
    if (s < nsteps) {
      const int t = s / D.NC, c = s - t * D.NC, st = s % NST;
      const int vs = t % NST;
      issue_cols<BQ>(qc(c), q0, fq(st), rq(st), D);
      issue_cols<BK>(kc(c), t * BK, fq(st) + BQ * LC, rq(st) + BQ * DC, D);
      if (c == 0)
        issue<BK>(kn, t * BK, fq(vs) + (BQ + BK) * LC,
                  rq(vs) + (BQ + BK) * DC, D);
    }
    cp_async_commit();
  };

  for (int s = 0; s < NST - 1; ++s) issue_step(s);
  FragC acc[2][2];
  for (int s = 0; s < nsteps; ++s) {
    const int t = s / D.NC, c = s - t * D.NC, st = s % NST, vs = t % NST;
    float* Qc = fq(st);
    float* Kc = Qc + BQ * LC;
    float* Vc = fq(vs) + (BQ + BK) * LC;
    cp_async_wait(NST - 2);
    __syncthreads();  // step s has landed; step s-1's readers are done
    if constexpr (!f32) {
      land_cols<BQ>(qc(c), q0, Qc, rq(st), D);
      land_cols<BK>(kc(c), t * BK, Kc, rq(st) + BQ * DC, D);
      if (c == 0) land<BK>(kn, t * BK, Vc, rq(vs) + (BQ + BK) * DC, D);
      __syncthreads();
    }
    issue_step(s + NST - 1);
    if (c == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
    }
    // warp w: all four tiles over its eighth of the chunk's depth steps
    const int nks = chunk_width(D, c) / TK;
    mma_2x2_nt<NS>(acc, Qc, Kc, LC, warp * nks / NWARPS,
                   (warp + 1) * nks / NWARPS);
    if (c == D.NC - 1) {
      float* sp = sm.S + warp * BQ * LS;
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(sp + i * TM * LS + j * TN, acc[i][j], LS,
                                  wmma::mem_row_major);
      __syncthreads();
      softmax_step<T>(sm.S, sm.P, sm.A, m, l, t * BK, kvl, D.scale);
      __syncthreads();
      // warp w owns the PV tiles w and w + NWARPS of the 2 x ndt
      for (int i = warp; i < (BQ / TM) * ndt; i += NWARPS)
        pv_step<NS>(sm.P, Vc, sm.PV, i / ndt, i % ndt, D);
      __syncthreads();
      o_update(o, sm.PV, sm.A, D);
    }
  }
}

template <typename T, bool WIDE>
__global__ void __launch_bounds__(THREADS, 1)
    rot_attention_fwd_kernel(const T* __restrict__ qu, const T* __restrict__ u,
                             const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ vt,
                             const int* __restrict__ kv_len,
                             T* __restrict__ out, float* __restrict__ lse,
                             Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  constexpr int OPT = BQ * (WIDE ? DK_MAX : DK_NARROW) / THREADS;
  extern __shared__ __align__(128) float smem[];
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5;
  const size_t base = (size_t)bh * D.T;
  const int kvl = max(0, min(kv_len[bh], D.T));

  if (kvl == 0) {
    for (int idx = threadIdx.x; idx < BQ * D.dk; idx += THREADS) {
      const int r = idx / D.dk, row = q0 + r;
      if (row < D.T)
        out[(base + row) * D.dk + (idx - r * D.dk)] = from_f32<T>(0.f);
    }
    for (int r = threadIdx.x; r < BQ; r += THREADS)
      if (q0 + r < D.T) lse[base + q0 + r] = INFINITY;
    return;
  }

  constexpr bool f32 = std::is_same<T, float>::value;
  float o[OPT], m = -INFINITY, l = 0.f;
#pragma unroll
  for (int c = 0; c < OPT; ++c) o[c] = 0.f;
  float* IL;
  if constexpr (WIDE) {
    const WideSmem sm = carve_wide(smem, D, f32);
    wide_loop<T>(qu, u, k, v, vt, sm, base, q0, kvl, o, m, l, D);
    IL = sm.IL;
  } else {
    const Smem sm = carve(smem, D);
    IL = sm.IL;
    // the resident query tile and the streamed key tiles
    const Src<T> qw{qu + base * D.dk, u + base * D.M, D.dk, D.M, D.T, D.EP,
                    D.LQ};
    const Src<T> kw{k + base * D.dk, vt, D.dk, D.M, kvl, D.EP, D.LQ};
    const Src<T> kn{v + base * D.dk, v, D.dk, 0, kvl, D.DKP, D.LD};
    // prefetch: the next tile's copies run while this one is computed
    const bool pre = f32 ? D.NBUF == 2 : D.raw != 0;
    const int ntiles = (kvl + BK - 1) / BK;
    // warp w < 2 * ndt owns the 16 x 16 tile (rt, dt) of PV
    const int ndt = D.DKP / TN;
    const bool owner = warp < (BQ / TM) * ndt;
    const int rt = warp / ndt, dt = warp % ndt;

    // the first key tile's copies start before the query tile's (bf16
    // loads it through registers), so the two overlap
    issue<BK>(kw, 0, sm.K[0], sm.RW, D);
    issue<BK>(kn, 0, sm.V[0], sm.RN, D);
    load_resident<BQ>(qw, q0, sm.Q, D);
    cp_async_commit();

    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * BK;
      // this step's buffers and the next one's (selects, not indexing,
      // keep the pointer pairs in registers)
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
      scores<NS>(sm.Q, Kc, sm.S, D);
      __syncthreads();
      softmax_step<T>(sm.S, sm.P, sm.A, m, l, k0, kvl, D.scale);
      __syncthreads();
      if (owner) pv_step<NS>(sm.P, Vc, sm.PV, rt, dt, D);
      __syncthreads();
      o_update(o, sm.PV, sm.A, D);
    }
  }

  // the first of a row's 8 threads writes its stats
  if ((threadIdx.x & 7) == 0) {
    const int i = threadIdx.x >> 3;
    IL[i] = 1.f / l;
    if (q0 + i < D.T) lse[base + q0 + i] = m + logf(l);
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < OPT; ++c) {
    const int e = threadIdx.x + THREADS * c, r = e / D.dk;
    if (r < BQ && q0 + r < D.T)
      out[(base + q0) * D.dk + e] = from_f32<T>(o[c] * IL[r]);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

template <typename T, bool WIDE>
int launch(const void* qu, const void* u, const void* k, const void* v,
           const void* vt, const int* kv_len, void* out, float* lse, int BH,
           int T_, int dk, int M, cudaStream_t stream) {
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
  D.NC = (D.E + DC - 1) / DC;
  D.scale = 1.0f / sqrtf((float)dk);
  // cp.async copies: 16 bytes where every width and base allows, else 4
  // bytes (bf16 pairs); bf16 of odd width goes through registers
  const void* src[] = {qu, u, k, v, vt};
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
  // f32 double-buffers the key tile, bf16 stages it raw; where that does
  // not fit, one buffer loaded at the top of each step (the wide form:
  // bf16 through registers)
  D.NBUF = f32 ? 2 : 1;
  size_t smem = WIDE ? wide_smem_bytes(D, f32) : smem_bytes(D);
  if (smem > (size_t)smem_max) {
    D.NBUF = 1;
    if (!f32) D.chunk = D.raw = 0;
    smem = WIDE ? wide_smem_bytes(D, f32) : smem_bytes(D);
  }
  err = cudaFuncSetAttribute(rot_attention_fwd_kernel<T, WIDE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T_ + BQ - 1) / BQ, BH);
  rot_attention_fwd_kernel<T, WIDE><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(u),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(vt), kv_len, static_cast<T*>(out), lse, D);
  return (int)cudaGetLastError();
}

template <bool WIDE>
int entry(const void* qu, const void* u, const void* k, const void* v,
          const void* vt, const void* kv_len, void* out, void* lse, int BH,
          int T_, int dk, int M, int is_bf16, void* stream) {
  if (dk < 1 || dk > (WIDE ? DK_MAX : DK_NARROW) || M < 0 || T_ < 1 ||
      BH < 1)
    return (int)cudaErrorInvalidValue;
  const int* kl = static_cast<const int*>(kv_len);
  float* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, WIDE>(qu, u, k, v, vt, kl, out, ls, BH, T_,
                                       dk, M, st);
  return launch<float, WIDE>(qu, u, k, v, vt, kl, out, ls, BH, T_, dk, M,
                             st);
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  The narrow
// form: dk <= 64 and a [q_u ; u] row whose tiles fit a block.
extern "C" int lasr_rot_attention_fwd(const void* qu, const void* u,
                                      const void* k, const void* v,
                                      const void* vt, const void* kv_len,
                                      void* out, void* lse, int BH, int T_,
                                      int dk, int M, int is_bf16,
                                      void* stream) {
  return entry<false>(qu, u, k, v, vt, kv_len, out, lse, BH, T_, dk, M,
                      is_bf16, stream);
}

// The wide form: dk <= 128, any M (the caller picks the form:
// ops/rot_attention.py, rot_kernel_wide).
extern "C" int lasr_rot_attention_fwd_wide(const void* qu, const void* u,
                                           const void* k, const void* v,
                                           const void* vt,
                                           const void* kv_len, void* out,
                                           void* lse, int BH, int T_, int dk,
                                           int M, int is_bf16, void* stream) {
  return entry<true>(qu, u, k, v, vt, kv_len, out, lse, BH, T_, dk, M,
                     is_bf16, stream);
}
