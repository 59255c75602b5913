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
// What bounds it on an H100: per (i, j) pair 3 dk-deep products (content
// score, position score, P·v: 6 dk FLOP) against ~5 dk values of input
// and output per row, so it is bound by arithmetic, and on the CUDA cores
// (67 TFLOP/s f32) that bound is ~2.5x what the tensor cores allow even as
// 3xTF32.  At dk = 40 the products are shallow, though: what sets the time
// is the work around them (fragment loads and splits, score remap,
// softmax, O update, tile copies) and block barriers, so the design gives
// every warp its own rows, one barrier a key tile and few copy
// instructions, and keeps two blocks on each SM.
//
// Design (tensor cores through WMMA; warps own their query rows):
//  - every product is an m16n16k8 TF32 WMMA tile (mma_tf32.cuh): 3xTF32
//    (f32 accuracy) for f32 inputs, one product for bf16 inputs, which
//    TF32 holds exactly (P is rounded to the input type first, as the TPU
//    kernel's prob.astype(v.dtype), so it is exact in TF32 too).
//  - grid (ceil(T/64), BH), 4 warps; warp w owns query rows q0+16w ..
//    q0+16w+15 and keeps their q_u and q_v as split A fragments in
//    registers for the whole key loop (this loop replaces the TPU's
//    sequential grid axis).  Per 32-key tile, in the warp's own shared
//    scratch and synchronised by __syncwarp only:
//      AC = q_u·k^T (16 x 32) and W = q_v·Pwin^T (16 x 48) over the
//        warp's window Pwin = p[h, r_w .. r_w+47], r_w = T-1-(q0+16w)-15
//        +k0: query ii and key jj read s = AC[ii][jj] + W[ii][15-ii+jj]
//        (the rel-shift as an index remap between plain products; a
//        16-row tile pays 1.5x the position products where a 32-row one
//        pays 2x);
//      the online softmax of the warp's 16 rows, 2 lanes a row (16 keys
//        each, max and sum by one shfl_xor), P rounded to the input type
//        in AC's place, the row's running max m and sum l (of the
//        unrounded P) in registers;
//      PV = P·v (16 x dk) from zero, stored in W's place, and O = O·alpha
//        + PV in f32 registers (each lane 20 values at dk = 40): the
//        tensor cores do not round the sum they accumulate into to
//        nearest, and over a key loop that drift showed in training when
//        K1 carried O in accumulator fragments (PERF.md, PR 5).
//    The only block barrier per key tile guards the shared k, v and
//    window tiles.  K1 splits one score tile's depth over 8 warps and
//    pays 4 barriers a tile, which suits its depth of 360; at K3's depth
//    of 40 a warp's own rows leave nothing to split.
//  - the block's window is the 95 rows its warps' windows cover, kept as
//    a ring of 32-row chunks: three in use and those loading, so each key
//    tile copies one new chunk.  Warp windows start at 16-row offsets of
//    the block's, so each 16-row B tile lies inside one chunk.  Window
//    rows outside [0, 2T-2] are zero (they meet only padded rows or keys).
//  - tiles are f32 in shared memory, with a row stride of 16-column
//    padding + 4 floats (dk 40 -> 52); the 8 ceil(dk/8) columns that the
//    products read are copied (zeros past dk).  Keys are loaded only below
//    kv_len (tiles past it are skipped), rows past T are zero.  Copies go
//    through tile_io.cuh's spread forms, which deal a narrow tile's
//    pieces over all 128 threads (whole rows a warp left most lanes idle:
//    the copies took 30% of a warp's time, PERF.md PR 7): q_u and q_v
//    stay resident; f32 k, v and window chunks arrive by cp.async two
//    tiles ahead into three buffers; bf16 is staged raw by cp.async two
//    tiles ahead and widened into the other of two f32 buffers one tile
//    ahead (bf16 of odd width goes through registers there).  The q_u /
//    q_v tile becomes the warps' score scratch once the fragments are in
//    registers.
//  - 99,840 B of dynamic shared memory at dk = 40 in f32 (95,232 in
//    bf16), so two 4-warp blocks share an SM: one block's copies, barrier
//    and element work overlap the other's products (one block per SM is
//    1.4x slower; 32-row blocks 1.4x, PERF.md PR 7).
//  - the TPU kernel's barrel-shifter rolls, its 128-lane dk padding and
//    its p_off alignment offset are Mosaic layout devices, not carried
//    over.
//  - wide heads (64 < dk <= 128, the 1B config's dk = 80): the q
//    fragments of 10-16 depth steps do not fit in registers, nor the
//    tiles above in shared memory.  There a warp reloads its q_u / q_v
//    fragments from the resident tiles at each key tile, keeps its AC / P
//    and W scratch (and a 16-column PV tile, one output column tile at a
//    time) apart from the q tiles, and the k, v and window tiles stream
//    through two buffers, copied one tile ahead (f32) or as for bf16
//    above: ~225 KB at dk = 128 in f32, one block per SM.  bf16 whose raw
//    staging would not fit (dk > 80) loads its tiles through registers.

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

constexpr int WARPS = 4;           // warps of a block, 16 query rows each
constexpr int BQ = TM * WARPS;     // query rows per block
constexpr int BK = 32;             // keys per tile: 16 per lane of a row
constexpr int CH = 32;             // rows of a window chunk
constexpr int NWIN = BQ / CH + 1;  // chunks a key tile's window spans
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;      // blocks per SM
constexpr int LS = BK + 4;         // row stride of a warp's AC (P) tile
constexpr int WCOLS = 48;          // columns of a warp's W tile: 47 used
constexpr int LW = WCOLS + 4;      // row stride of a wide warp's W / PV
constexpr int DK_MAX = 128;
static_assert(BQ % CH == 0 && TM * 2 == BK, "2 lanes a row, 16 keys each");

// f32 k, v tiles stream through three buffers (copied two tiles ahead),
// or two for wide heads (copied one tile ahead); bf16 through two (staged
// raw two tiles ahead, widened one tile ahead).  The window ring holds the
// NWIN chunks in use and those loading.
template <typename T, bool WIDE>
struct Pipe {
  static constexpr bool f32 = std::is_same<T, float>::value;
  static constexpr int NBUF = f32 && !WIDE ? 3 : 2;
  static constexpr int NRING = NWIN + NBUF - 1;
  // tiles ahead that a step starts copying (bf16: staging raw)
  static constexpr int AHEAD = f32 && WIDE ? 1 : 2;
};

struct Dims {
  int T, dk, H, P;  // P = 2T - 1 rows of the positional table
  int DKP, LD;      // dk rounded up to 16; row stride DKP + 4 of k, v, Pwin
  int LQ;           // row stride of q_u / q_v: LD, at least WCOLS + 4
  int NDS;          // depth steps of the score products: ceil(dk / 8)
  int KW;           // columns copied: 8 NDS, all the products read (P·v's
                    // last column tile reads up to DKP: columns past KW
                    // reach only columns of PV past dk, never used)
  int chunk;        // elements per cp.async copy of a tile; 0: registers
  int raw;          // bf16 tiles are staged raw and widened in shared memory
  float scale;
};

// Shared memory: the resident q_u and q_v tiles (Qu, Qv; warp w's 16 rows
// of each become its AC / P and W / PV scratch, or, for wide heads, stay
// and the warp's scratch is its own part of S: 16 x LS, then 16 x LW),
// NBUF buffers of k (K) and of v (V), the window ring, and (bf16 by
// cp.async) raw staging for k, v and a window chunk in two parities (RK,
// RV, RP), each row KW wide.
struct Smem {
  float *Qu, *Qv, *K, *V, *ring, *S;
  __nv_bfloat16 *RK, *RV, *RP;
};

template <typename T, bool WIDE>
__host__ __device__ __forceinline__ size_t smem_bytes(const Dims& D) {
  using P = Pipe<T, WIDE>;
  const size_t floats = 2 * (size_t)BQ * D.LQ +
                        2 * (size_t)P::NBUF * BK * D.LD +
                        (size_t)P::NRING * CH * D.LD +
                        (WIDE ? (size_t)WARPS * TM * (LS + LW) : 0);
  return 4 * floats + (D.raw ? 2 * 2 * (size_t)(2 * BK + CH) * D.KW : 0);
}

template <typename T, bool WIDE>
__device__ __forceinline__ Smem carve(float* p, const Dims& D) {
  using P = Pipe<T, WIDE>;
  Smem s;
  s.Qu = p;
  s.Qv = s.Qu + BQ * D.LQ;
  s.K = s.Qv + BQ * D.LQ;
  s.V = s.K + P::NBUF * BK * D.LD;
  s.ring = s.V + P::NBUF * BK * D.LD;
  s.S = s.ring + P::NRING * CH * D.LD;
  s.RK = reinterpret_cast<__nv_bfloat16*>(
      s.S + (WIDE ? WARPS * TM * (LS + LW) : 0));
  s.RV = s.RK + 2 * BK * D.KW;
  s.RP = s.RV + 2 * BK * D.KW;
  return s;
}

// The warp's scores of the tile pair into its scratch: AC = Qu·K^T (two
// column tiles, row stride LS) and W = Qv·Pwin^T (three column tiles, row
// stride LQ), where Pwin's column tile c is the 16 window rows at pw[c].
// The ks-outer loop keeps the five products independent.
template <int NS, int NDSX>
__device__ __forceinline__ void scores(
    const Split<FragA<RowMajor>, NS> (&fu)[NDSX],
    const Split<FragA<RowMajor>, NS> (&fv)[NDSX], const float* K,
    const float* const (&pw)[3], float* ac, float* w, const Dims& D) {
  FragC acc[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) wmma::fill_fragment(acc[c], 0.f);
#pragma unroll
  for (int ks = 0; ks < NDSX; ++ks) {
    if (ks < D.NDS) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        Split<FragB<ColMajor>, NS> b;
        load_split(b, K + c * TN * D.LD + ks * TK, D.LD);
        mma_split(acc[c], fu[ks], b);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        Split<FragB<ColMajor>, NS> b;
        load_split(b, pw[c] + ks * TK, D.LD);
        mma_split(acc[2 + c], fv[ks], b);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    wmma::store_matrix_sync(ac + c * TN, acc[c], LS, wmma::mem_row_major);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    wmma::store_matrix_sync(w + c * TN, acc[2 + c], D.LQ,
                            wmma::mem_row_major);
}

// The same for wide heads: the q fragments of each depth step are loaded
// and split from the warp's resident rows qu / qv (row stride LQ) at every
// key tile, and W goes to the warp's scratch at row stride LW.
template <int NS>
__device__ __forceinline__ void scores_wide(const float* qu, const float* qv,
                                            const float* K,
                                            const float* const (&pw)[3],
                                            float* ac, float* w,
                                            const Dims& D) {
  FragC acc[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) wmma::fill_fragment(acc[c], 0.f);
#pragma unroll 2
  for (int ks = 0; ks < D.NDS; ++ks) {
    Split<FragA<RowMajor>, NS> fu, fv;
    load_split(fu, qu + ks * TK, D.LQ);
    load_split(fv, qv + ks * TK, D.LQ);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      Split<FragB<ColMajor>, NS> b;
      load_split(b, K + c * TN * D.LD + ks * TK, D.LD);
      mma_split(acc[c], fu, b);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      Split<FragB<ColMajor>, NS> b;
      load_split(b, pw[c] + ks * TK, D.LD);
      mma_split(acc[2 + c], fv, b);
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c)
    wmma::store_matrix_sync(ac + c * TN, acc[c], LS, wmma::mem_row_major);
#pragma unroll
  for (int c = 0; c < 3; ++c)
    wmma::store_matrix_sync(w + c * TN, acc[2 + c], LW, wmma::mem_row_major);
}

// The online softmax of the warp's 16 rows over keys k0 .. k0+31: lane
// (r, h) = (lane / 2, lane % 2) takes row r, keys 16h .. 16h+15:
// s = AC[r][j] + W[r][15-r+j] (the rel-shift), scaled and masked at
// kv_len.  m, l and the rescale alpha of the row are updated in registers
// (the same in both lanes); P, rounded to T, replaces AC.  W's row
// stride is ldw.
template <typename T>
__device__ __forceinline__ void softmax_step(float* ac, const float* w,
                                             int ldw, float& m, float& l,
                                             float& alpha, int k0, int kvl,
                                             const Dims& D) {
  const int lane = threadIdx.x & 31, r = lane >> 1, j0 = (lane & 1) * 16;
  float* a = ac + r * LS + j0;
  const float* wr = w + r * ldw + (TM - 1) - r + j0;
  float x[16], mx = -INFINITY;
#pragma unroll
  for (int c = 0; c < 16; c += 4) {
    const float4 y = *reinterpret_cast<const float4*>(a + c);
    x[c] = y.x + wr[c];
    x[c + 1] = y.y + wr[c + 1];
    x[c + 2] = y.z + wr[c + 2];
    x[c + 3] = y.w + wr[c + 3];
  }
  const int nvalid = kvl - k0 - j0;  // keys of this lane below kv_len
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    x[c] = c < nvalid ? x[c] * D.scale : -INFINITY;
    mx = fmaxf(mx, x[c]);
  }
  const float m_new = fmaxf(m, fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1)));
  alpha = expf(m - m_new);
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    const float p = c < nvalid ? expf(x[c] - m_new) : 0.f;
    sum += p;
    x[c] = to_f32(from_f32<T>(p));
  }
  l = l * alpha + sum + __shfl_xor_sync(0xffffffffu, sum, 1);
  m = m_new;
#pragma unroll
  for (int c = 0; c < 16; c += 4)
    *reinterpret_cast<float4*>(a + c) =
        make_float4(x[c], x[c + 1], x[c + 2], x[c + 3]);
}

// PV = P·V over the tile's 32 keys, from zero, into pv (row stride LQ):
// the four P fragments are loaded and split once for every column tile.
template <int NS, int NDSX>
__device__ __forceinline__ void pv_step(const float* P, const float* V,
                                        float* pv, const Dims& D) {
  constexpr int NDTX = (NDSX + 1) / 2;  // column tiles of PV at most
  const int ndt = D.DKP / TN;
  Split<FragA<RowMajor>, NS> a[BK / TK];
#pragma unroll
  for (int ks = 0; ks < BK / TK; ++ks) load_split(a[ks], P + ks * TK, LS);
#pragma unroll
  for (int dt = 0; dt < NDTX; ++dt) {
    if (dt < ndt) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int ks = 0; ks < BK / TK; ++ks) {
        Split<FragB<RowMajor>, NS> b;
        load_split(b, V + ks * TK * D.LD + dt * TN, D.LD);
        mma_split(acc, a[ks], b);
      }
      wmma::store_matrix_sync(pv + dt * TN, acc, D.LQ, wmma::mem_row_major);
    }
  }
}

// Wide heads: PV one 16-column tile at a time into the warp's scratch pv
// (row stride LW), each followed by O = O·alpha + PV of its columns (o's
// layout as o_update's: element 8 dt + i is column 16 dt + lane % 2 + 2i).
template <int NS, int NDTX>
__device__ __forceinline__ void pv_o_wide(const float* P, const float* V,
                                          float* pv, float (&o)[NDTX * 8],
                                          float alpha, const Dims& D) {
  const int lane = threadIdx.x & 31;
  const int ndt = D.DKP / TN;
  const float* row = pv + (lane >> 1) * LW + (lane & 1);
  Split<FragA<RowMajor>, NS> a[BK / TK];
#pragma unroll
  for (int ks = 0; ks < BK / TK; ++ks) load_split(a[ks], P + ks * TK, LS);
#pragma unroll
  for (int dt = 0; dt < NDTX; ++dt) {
    if (dt < ndt) {
      FragC acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int ks = 0; ks < BK / TK; ++ks) {
        Split<FragB<RowMajor>, NS> b;
        load_split(b, V + ks * TK * D.LD + dt * TN, D.LD);
        mma_split(acc, a[ks], b);
      }
      wmma::store_matrix_sync(pv, acc, LW, wmma::mem_row_major);
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (dt * TN + (lane & 1) + 2 * i < D.dk)
          o[dt * 8 + i] = fmaf(o[dt * 8 + i], alpha, row[2 * i]);
      __syncwarp();
    }
  }
}

// O = O·alpha + PV for the lane's elements: row lane / 2, columns
// lane % 2 + 2i below dk.
template <int OPL>
__device__ __forceinline__ void o_update(float (&o)[OPL], const float* pv,
                                         float alpha, const Dims& D) {
  const int lane = threadIdx.x & 31;
  const float* row = pv + (lane >> 1) * D.LQ + (lane & 1);
#pragma unroll
  for (int i = 0; i < OPL; ++i)
    if ((lane & 1) + 2 * i < D.dk) o[i] = fmaf(o[i], alpha, row[2 * i]);
}

// NDSX: depth steps the q fragments are held for (ceil(dk / 8) <= NDSX);
// above 8 (dk > 64) the wide-head form, which reloads them per key tile.
template <typename T, int NDSX>
__global__ void __launch_bounds__(THREADS, NDSX > 8 ? 1 : MIN_BLOCKS)
    rel_attention_fwd_kernel(const T* __restrict__ qu,
                             const T* __restrict__ qv,
                             const T* __restrict__ k, const T* __restrict__ v,
                             const T* __restrict__ p,
                             const int* __restrict__ kv_len,
                             T* __restrict__ out, float* __restrict__ lse,
                             Dims D) {
  constexpr int NS = SplitsFor<T>::value;
  constexpr bool WIDE = NDSX > 8;
  using Pp = Pipe<T, WIDE>;
  constexpr bool f32 = Pp::f32;
  constexpr int NBUF = Pp::NBUF, NRING = Pp::NRING, AHEAD = Pp::AHEAD;
  constexpr int OPL = NDSX * TK / 2;  // O elements a lane: 16 rows x dk
  extern __shared__ __align__(128) float smem[];
  const Smem sm = carve<T, WIDE>(smem, D);
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
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

  const Src<T> su{qu + base * D.dk, qu, D.dk, 0, D.T, D.KW, D.LQ};
  const Src<T> sv{qv + base * D.dk, qv, D.dk, 0, D.T, D.KW, D.LQ};
  const Src<T> sk{k + base * D.dk, k, D.dk, 0, kvl, D.KW, D.LD};
  const Src<T> sn{v + base * D.dk, v, D.dk, 0, kvl, D.KW, D.LD};
  const T* ph = p + (size_t)(bh % D.H) * D.P * D.dk;
  const Src<T> sp{ph, ph, D.dk, 0, D.P, D.KW, D.LD};
  // key tile t lives in buffer t % NBUF (raw bf16 in parity t % 2);
  // chunk g of the block's windows, p rows from T - q0 - BQ + 32g (key
  // tile t's window is chunks t .. t+NWIN-1), in ring slot g % NRING
  auto kbuf = [&](int t) { return sm.K + (t % NBUF) * BK * D.LD; };
  auto vbuf = [&](int t) { return sm.V + (t % NBUF) * BK * D.LD; };
  auto rk = [&](int t) { return sm.RK + (t & 1) * BK * D.KW; };
  auto rv = [&](int t) { return sm.RV + (t & 1) * BK * D.KW; };
  auto rp = [&](int t) { return sm.RP + (t & 1) * CH * D.KW; };
  auto slot = [&](int g) { return sm.ring + (g % NRING) * CH * D.LD; };
  auto grow = [&](int g) { return D.T - q0 - BQ + CH * g; };
  const int ntiles = (kvl + BK - 1) / BK;

  // resident q tiles, the first key tile and window (f32 by cp.async,
  // bf16 through registers), then tile 1: f32 in its own group (so a
  // step waits for its tile only), bf16 staged raw; f32 of wide heads
  // copies tile 1 in step 0.  The cp.async copies and the widening take
  // tile_io.cuh's spread forms: the tiles are narrow.
  constexpr bool SP = true;
  load_resident<BQ, T, Dims, WARPS, SP>(su, q0, sm.Qu, D);
  load_resident<BQ, T, Dims, WARPS, SP>(sv, q0, sm.Qv, D);
  load_resident<BK, T, Dims, WARPS, SP>(sk, 0, kbuf(0), D);
  load_resident<BK, T, Dims, WARPS, SP>(sn, 0, vbuf(0), D);
  load_resident<NWIN * CH, T, Dims, WARPS, SP>(sp, grow(0), slot(0), D);
  if constexpr (f32) cp_async_commit();
  if (AHEAD == 2 && ntiles > 1) {
    issue<BK, T, Dims, WARPS, SP>(sk, BK, kbuf(1), rk(1), D);
    issue<BK, T, Dims, WARPS, SP>(sn, BK, vbuf(1), rv(1), D);
    issue<CH, T, Dims, WARPS, SP>(sp, grow(NWIN), slot(NWIN), rp(1), D);
  }
  cp_async_commit();

  // the warp's rows, its scratch and its window's column tiles: window
  // rows 16c.. of warp w lie at 16 (WARPS-1-w) + 16c in the block's
  const bool active = q0 + warp * TM < D.T;
  float* const qu_w = sm.Qu + warp * TM * D.LQ;
  float* const qv_w = sm.Qv + warp * TM * D.LQ;  // last: the output
  float* sac = WIDE ? sm.S + warp * TM * (LS + LW) : qu_w;  // AC, then P
  float* sw = WIDE ? sac + TM * LS : qv_w;  // W, then PV
  int wofs[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) wofs[c] = TM * (WARPS - 1 - warp) + TN * c;
  // the q fragments, held in registers (narrow heads only)
  Split<FragA<RowMajor>, NS> fu[WIDE ? 1 : NDSX], fv[WIDE ? 1 : NDSX];
  float o[OPL], m = -INFINITY, l = 0.f;
#pragma unroll
  for (int i = 0; i < OPL; ++i) o[i] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    // f32: tile t's group has landed, tile t+1's may be in flight (wide
    // heads: none is); bf16: tile t was widened in step t-1, tile t+1's
    // raw copy has landed
    cp_async_wait(f32 && !WIDE ? 1 : 0);
    __syncthreads();  // tile t has landed; step t-1's readers are done
    // the next tiles' copies run while this one is computed: f32 copies
    // tile t+AHEAD into the buffer step t-1 read; bf16 widens (or loads
    // through registers) tile t+1 and stages tile t+2 raw
    if (!f32 && t + 1 < ntiles) {
      const int n = t + 1;
      land<BK, T, Dims, WARPS, SP>(sk, k0 + BK, kbuf(n), rk(n), D);
      land<BK, T, Dims, WARPS, SP>(sn, k0 + BK, vbuf(n), rv(n), D);
      land<CH, T, Dims, WARPS, SP>(sp, grow(n + NWIN - 1),
                                   slot(n + NWIN - 1), rp(n), D);
    }
    if (t + AHEAD < ntiles) {
      const int n = t + AHEAD;
      issue<BK, T, Dims, WARPS, SP>(sk, n * BK, kbuf(n), rk(n), D);
      issue<BK, T, Dims, WARPS, SP>(sn, n * BK, vbuf(n), rv(n), D);
      issue<CH, T, Dims, WARPS, SP>(sp, grow(n + NWIN - 1),
                                    slot(n + NWIN - 1), rp(n), D);
    }
    cp_async_commit();
    if (!active) continue;
    if constexpr (!WIDE) {
      if (t == 0) {
        // the q fragments, split once; the tiles then serve as scratch
#pragma unroll
        for (int ks = 0; ks < NDSX; ++ks) {
          if (ks < D.NDS) {
            load_split(fu[ks], sac + ks * TK, D.LQ);
            load_split(fv[ks], sw + ks * TK, D.LQ);
          }
        }
        __syncwarp();
      }
    }
    const float* Kc = kbuf(t);
    const float* Vc = vbuf(t);
    const float* pw[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      pw[c] = slot(t + wofs[c] / CH) + (wofs[c] % CH) * D.LD;
    float alpha;
    if constexpr (WIDE) {
      scores_wide<NS>(qu_w, qv_w, Kc, pw, sac, sw, D);
      __syncwarp();
      softmax_step<T>(sac, sw, LW, m, l, alpha, k0, kvl, D);
      __syncwarp();
      pv_o_wide<NS, NDSX / 2>(sac, Vc, sw, o, alpha, D);
    } else {
      scores<NS, NDSX>(fu, fv, Kc, pw, sac, sw, D);
      __syncwarp();
      softmax_step<T>(sac, sw, D.LQ, m, l, alpha, k0, kvl, D);
      __syncwarp();
      pv_step<NS, NDSX>(sac, Vc, sw, D);
      __syncwarp();
      o_update(o, sw, alpha, D);
    }
  }

  if (!active) return;
  // out = O / l through the warp's scratch, so its 16 rows (contiguous in
  // out) are written coalesced; lse = m + log l
  __syncwarp();
  const int r = lane >> 1, row0 = q0 + warp * TM;
  const float inv = 1.f / l;
#pragma unroll
  for (int i = 0; i < OPL; ++i) {
    const int e = (lane & 1) + 2 * i;
    if (e < D.dk) qv_w[r * D.LQ + e] = o[i] * inv;
  }
  if ((lane & 1) == 0 && row0 + r < D.T) lse[base + row0 + r] = m + logf(l);
  __syncwarp();
  const int n = min(TM, D.T - row0) * D.dk;
  T* dst = out + (base + row0) * D.dk;
  for (int idx = lane; idx < n; idx += 32) {
    const int rr = idx / D.dk;
    dst[idx] = from_f32<T>(qv_w[rr * D.LQ + (idx - rr * D.dk)]);
  }
}

bool aligned(const void* p, uintptr_t n) {
  return (reinterpret_cast<uintptr_t>(p) & (n - 1)) == 0;
}

Dims make_dims(int T_, int dk, int H, bool f32, int chunk) {
  Dims D;
  D.T = T_;
  D.dk = dk;
  D.H = H;
  D.P = 2 * T_ - 1;
  D.DKP = (dk + 15) / 16 * 16;
  D.LD = D.DKP + 4;
  D.LQ = D.LD > WCOLS + 4 ? D.LD : WCOLS + 4;
  D.NDS = (dk + 7) / 8;
  D.KW = 8 * D.NDS;
  D.chunk = chunk;
  D.raw = !f32 && chunk > 0;
  D.scale = 1.0f / sqrtf((float)dk);
  return D;
}

template <typename T, int NDSX>
int launch_as(Dims D, const void* qu, const void* qv, const void* k,
              const void* v, const void* p, const int* kv_len, void* out,
              float* lse, int BH, cudaStream_t stream) {
  constexpr bool WIDE = NDSX > 8;
  cudaError_t err = cudaSuccess;
  if constexpr (WIDE) {
    // (narrow heads always fit)
    int dev = 0, smem_max = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    // bf16 whose raw staging does not fit loads its tiles through
    // registers
    if (D.raw && smem_bytes<T, WIDE>(D) > (size_t)smem_max)
      D.chunk = D.raw = 0;
    if (smem_bytes<T, WIDE>(D) > (size_t)smem_max)
      return (int)cudaErrorInvalidValue;
  }
  const size_t smem = smem_bytes<T, WIDE>(D);
  auto kern = rel_attention_fwd_kernel<T, NDSX>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((D.T + BQ - 1) / BQ, BH);
  kern<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(qu), static_cast<const T*>(qv),
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(p), kv_len, static_cast<T*>(out), lse, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* qu, const void* qv, const void* k, const void* v,
           const void* p, const int* kv_len, void* out, float* lse, int BH,
           int T_, int dk, int H, cudaStream_t stream) {
  // cp.async copies: 16 bytes where the width and every base allow, else
  // 4 bytes (f32 always, bf16 pairs); bf16 of odd width goes through
  // registers
  const void* src[] = {qu, qv, k, v, p};
  auto all = [&](uintptr_t n) {
    for (const void* s : src)
      if (!aligned(s, n)) return false;
    return true;
  };
  const int vec = 16 / (int)sizeof(T), pair = 4 / (int)sizeof(T);
  const int chunk = dk % vec == 0 && all(16)    ? vec
                    : dk % pair == 0 && all(4) ? pair
                                               : 0;
  const Dims D = make_dims(T_, dk, H, std::is_same<T, float>::value, chunk);
  // q fragments held for 5 depth steps (dk <= 40, the recipe's) or 8;
  // wide heads (dk > 64) reload them per key tile
  if (D.NDS <= 5)
    return launch_as<T, 5>(D, qu, qv, k, v, p, kv_len, out, lse, BH, stream);
  if (D.NDS <= 8)
    return launch_as<T, 8>(D, qu, qv, k, v, p, kv_len, out, lse, BH, stream);
  return launch_as<T, 16>(D, qu, qv, k, v, p, kv_len, out, lse, BH, stream);
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

// The launch's dynamic shared memory and resident blocks per SM for a
// (T, dk, type) with 16-byte copies (for reports; not on the path).
namespace {

template <typename T, int NDSX>
int occupancy_as(const Dims& D, int* smem, int* blocks) {
  *smem = (int)smem_bytes<T, (NDSX > 8)>(D);
  const void* kern = (const void*)rel_attention_fwd_kernel<T, NDSX>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            THREADS, *smem);
}

template <typename T>
int occupancy(const Dims& D, int* smem, int* blocks) {
  if (D.NDS <= 5) return occupancy_as<T, 5>(D, smem, blocks);
  if (D.NDS <= 8) return occupancy_as<T, 8>(D, smem, blocks);
  return occupancy_as<T, 16>(D, smem, blocks);
}

}  // namespace

extern "C" int lasr_rel_attention_fwd_occupancy(int T_, int dk, int is_bf16,
                                                int* smem, int* blocks) {
  if (dk < 1 || dk > DK_MAX || T_ < 1) return (int)cudaErrorInvalidValue;
  const Dims D = make_dims(T_, dk, 1, !is_bf16, is_bf16 ? 8 : 4);
  return is_bf16 ? occupancy<__nv_bfloat16>(D, smem, blocks)
                 : occupancy<float>(D, smem, blocks);
}
