// Fused rotated-fold rel-pos attention, backward, bf16 wide form — CUDA
// C++ for sm_90a (wgmma and TMA).
//
// Replaces the Pallas TPU kernel lasr_tpu/ops/rot_attention.py
// `_bwd_kernel` (driven by `_rot_attention_pallas_bwd`) for bf16 inputs
// where K2 takes its wide form and TMA can describe the tensors (as the
// forward, csrc/rot_attention_sm90.cu).  The same function as
// csrc/rot_attention_bwd.cu, from the forward's lse and out:
//
//   P[i,j]  = exp((q_u[i]·k[j] + u[i]·V[j]) / sqrt(dk) - lse[i])
//   dz[i,j] = P[i,j] * (dout[i]·v[j] - delta[i]) / sqrt(dk),
//             delta[i] = dout[i]·out[i]
//   dv[j]   = sum_i P[i,j] dout[i]       dk[j] = sum_i dz[i,j] q_u[i]
//   dq_u[i] = sum_j dz[i,j] k[j]         du[i] = sum_j dz[i,j] V[j]
//
// over j < kv_len[bh]; V gets no gradient; all bf16, sums in f32.  dz is
// rounded to bf16 before its three products, as the Pallas kernel rounds
// it (`dzc = dz.astype(qu.dtype)`); P is rounded to bf16 for P^T·dout.
//
// What bounds it on an H100: at the 1B training shape (BH = 512, T = 388,
// dk = 80, M = 1280) the bytes it must move (u and du are 508 MB each)
// take 375 us at HBM's rate, a little more than its ~0.35 ms of bf16
// tensor-core work (~4M + 10 dk FLOP a (query, key) pair): the bytes
// bound it.  What holds it above that bound is L2: the key pass re-reads
// a block's [k ; V] chunks for every query tile (~5.7 GB a call) and the
// query pass each dz tile for every column chunk, hence 128 keys a
// key-pass block and dz stored once, in bf16.  The wide form of csrc/rot_attention_bwd.cu, which bf16 took before, ran
// TF32 mma.sync on 32-row tiles widened to f32, summed S from 8 per-warp
// partials in shared memory and kept dz in f32: 56x its tensor-core bound.
//
// Design: three passes, each owning what it writes (no atomics: bitwise
// repeatable).
//  - delta: one warp a row (rot_bwd_delta_kernel, as csrc/
//    rot_attention_bwd.cu's).
//  - key pass, grid (ceil(T / 128), BH), 384 threads: a block owns 128
//    keys (two consumer warpgroups of 64) and walks the 64-row query
//    tiles.  Per tile: S^T (64 keys x 64 queries a warpgroup) through
//    csrc/sm90_pipe.cuh's main loop with the sides swapped (wgmma
//    m64n64k16, a stage: the chunk's 128 keys and 64 queries, 24 KB);
//    dP^T = v·dout^T (wgmma over dk's depth; v resident, dout in one of
//    two side slots with the tile's q_u); P^T and dz^T in registers, on
//    the accumulator's layout (lse and delta per column); dv += P^T·dout
//    and dk += dz^T·q_u as register-A wgmma (dout and q_u MN-major), f32
//    accumulators held for the whole walk; dz^T written once, in bf16,
//    into a (BH, T, T8) scratch (T8 = T rounded up to 8: 156 MB at the 1B
//    training shape, against the f32 wide form's 354 MB).
//  - query pass, grid (ceil(T / 128), BH, ceil(E64 / 256)): [dq_u ; du]
//    = dz·[k ; V], a wgmma GEMM over the keys below kv_len: dz (MN-major
//    A, from the transposed scratch) and 4 boxes of 64 columns of [k ; V]
//    (MN-major B) a 64-key stage, by TMA; f32 accumulators in registers,
//    written once.
// Shared memory: key pass 4 x 24 KB stages, 2 x 32 KB side slots and 32
// KB of v at dk > 64 (193 KB); query pass 4 x 48 KB stages (193 KB).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90_pipe.cuh"

namespace {

using namespace lasr_sm90;

constexpr int BKEY = 128;  // keys a key-pass block: two warpgroups of 64
constexpr int BQT = 64;    // query rows a key-pass tile
constexpr int NST = 4;     // stages of the rings
constexpr int KEY_STAGE = (BKEY + BQT) / BOX * BOX_BYTES;
constexpr int BQR = 128;   // query rows a query-pass block
constexpr int QBOX = 4;    // column boxes of [dq_u ; du] a query-pass block
constexpr int QUERY_STAGE = (BQR / BOX + QBOX) * BOX_BYTES;

struct Maps {
  CUtensorMap qu, u, k, v, vt, dout, dzt;
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// delta[row] = dout[row]·out[row]; one warp per row.
__global__ void rot_bwd_delta_kernel(const __nv_bfloat16* __restrict__ out,
                                     const __nv_bfloat16* __restrict__ dout,
                                     float* __restrict__ delta, int rows,
                                     int dk) {
  const int row = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  float s = 0.f;
  for (int d = lane; d < dk; d += 32)
    s = fmaf(__bfloat162float(out[(size_t)row * dk + d]),
             __bfloat162float(dout[(size_t)row * dk + d]), s);
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// a side slot: the query tile's dout, then its q_u (NDB boxes each)
template <int NDB>
__host__ __device__ constexpr int side_bytes() {
  return 2 * NDB * BOX_BYTES;
}

template <int NDB>
__host__ __device__ constexpr int key_smem_bytes() {
  return 1024 + NST * KEY_STAGE + 2 * side_bytes<NDB>() +
         NDB * (BKEY / BOX) * BOX_BYTES;
}

__host__ __device__ constexpr int query_smem_bytes() {
  return 1024 + NST * QUERY_STAGE;
}

// the 64 x 64 accumulator `a` of rows r0 + 16 wq + g (+ 8) and columns
// c0 + 8 j + 2 tq (+ 1) into a (rows, width) bf16 tensor at `dst` (row
// stride `width`), where row < rows and column < width
__device__ __forceinline__ void store_tile(const float (&a)[32],
                                           __nv_bfloat16* dst, int r0,
                                           int rows, int c0, int width,
                                           int wq, int g, int tq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + 16 * wq + g + 8 * h;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = c0 + 8 * j + 2 * tq;
      if (col < width)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row * width + col) =
            pack_bf16(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
    }
  }
}

// Key pass: one block per (128 keys, bh); dk and dv of its keys, and dz^T
// of its keys against every query row into the scratch.
template <int NDB>
__global__ void __launch_bounds__(THREADS, 1)
    rot_bwd_key_wgmma_kernel(const __grid_constant__ Maps maps,
                             const int* __restrict__ kv_len,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             __nv_bfloat16* __restrict__ dzt,
                             __nv_bfloat16* __restrict__ dk_,
                             __nv_bfloat16* __restrict__ dv_, int T, int T8,
                             int dk, int M, float scale) {
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BKEY;
  const size_t base = (size_t)bh * T;
  const int kvl = max(0, min(kv_len[bh], T));
  if (k0 >= kvl) {  // keys past kv_len: zero gradients, no dz is read
    for (int idx = threadIdx.x; idx < BKEY * dk; idx += THREADS) {
      const int r = idx / dk, key = k0 + r;
      if (key < T) {
        const size_t o = (base + key) * dk + (idx - r * dk);
        dk_[o] = dv_[o] = __float2bfloat16(0.f);
      }
    }
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST], sfull[2],
      sempty[2], vbar;
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* sides = smem + NST * KEY_STAGE;
  uint8_t* vres = sides + 2 * side_bytes<NDB>();
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&sfull[i], 1);
      bar_init(&sempty[i], CONSUMER_WARPS);
    }
    bar_init(&vbar, 1);
    bar_init_fence();
  }
  __syncthreads();

  const int nlo = (dk + BOX - 1) / BOX;
  const int nchunks = nlo + (M + BOX - 1) / BOX;
  const int ntiles = (T + BQT - 1) / BQT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Ring ring{smem, full, empty, KEY_STAGE, NST, 0, 0};

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      const Side kk{&maps.k, &maps.vt, true};
      const Side q{&maps.qu, &maps.u, false};
      bar_expect(&vbar, NDB * (BKEY / BOX) * BOX_BYTES);
      for (int db = 0; db < NDB; ++db)
        for (int h = 0; h < BKEY / BOX; ++h)
          tma_load(vres + (db * (BKEY / BOX) + h) * BOX_BYTES, &maps.v,
                   &vbar, db * BOX, k0 + h * BOX, bh);
      int ss = 0;
      uint32_t sph = 0;
      for (int t = 0; t < ntiles; ++t) {
        const int q0 = t * BQT;
        uint8_t* side = sides + ss * side_bytes<NDB>();
        bar_wait(&sempty[ss], sph ^ 1);
        bar_expect(&sfull[ss], side_bytes<NDB>());
        for (int db = 0; db < NDB; ++db) {
          tma_load(side + db * BOX_BYTES, &maps.dout, &sfull[ss], db * BOX,
                   q0, bh);
          tma_load(side + (NDB + db) * BOX_BYTES, &maps.qu, &sfull[ss],
                   db * BOX, q0, bh);
        }
        if (++ss == 2) {
          ss = 0;
          sph ^= 1;
        }
        produce_scores<BKEY / BOX, BQT / BOX>(ring, kk, k0, q, q0, bh,
                                              nchunks, nlo);
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  // a consumer warpgroup: keys k0 + 64 wg + 16 wq + g (+ 8)
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  const bool lead = lane == 0;
  const float sl2 = scale * LOG2E;
  const int key0 = k0 + 64 * wg + 16 * wq + g;
  float dv[NDB][32], dkv[NDB][32];
#pragma unroll
  for (int db = 0; db < NDB; ++db)
#pragma unroll
    for (int i = 0; i < 32; ++i) dv[db][i] = dkv[db][i] = 0.f;
  int ss = 0;
  uint32_t sph = 0;
  bar_wait(&vbar, 0);

  for (int t = 0; t < ntiles; ++t) {
    const int q0 = t * BQT;
    float st[32], dp[32];
    consume_scores<BKEY / BOX, BQT / BOX>(st, ring, wg, nchunks);
    bar_wait(&sfull[ss], sph);
    uint8_t* side = sides + ss * side_bytes<NDB>();
    // dP^T = v·dout^T over dk (both K-major; the boxes' zero-filled
    // columns past dk add nothing)
    fence_regs(dp);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < 4 * NDB; ++ks) {
      const int db = ks >> 2, step = 2 * (ks & 3);
      wgmma_ss64<0, 0>(
          dp, desc(vres + (db * (BKEY / BOX) + wg) * BOX_BYTES) + step,
          desc(side + db * BOX_BYTES) + step, ks > 0);
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dp);
    // element i: key key0 + 8 ((i >> 1) & 1), query q0 + 8 (i >> 2) + 2 tq
    // + (i & 1); P^T into st, dz^T into dp
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int q = q0 + 8 * j + 2 * tq + e;
        const bool qv = q < T;
        const float L = qv ? lse[base + q] * LOG2E : 0.f;
        const float D = qv ? delta[base + q] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h + e;
          const bool valid = qv && key0 + 8 * h < kvl;
          const float p = valid ? exp2f(st[i] * sl2 - L) : 0.f;
          st[i] = p;
          dp[i] = p * (dp[i] - D) * scale;
        }
      }
    uint32_t pf[BQT / 16][4], zf[BQT / 16][4];
    to_a_frags<BQT / 16>(st, pf);
    to_a_frags<BQT / 16>(dp, zf);
    // dz^T, once: (key, query pair) as one 4-byte store (rows < T)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h;
      if (key >= T) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = q0 + 8 * j + 2 * tq;
        if (q < T8)
          *reinterpret_cast<uint32_t*>(
              dzt + ((size_t)bh * T + key) * T8 + q) =
              zf[j >> 1][2 * (j & 1) + h];
      }
    }
    // dv += P^T·dout, dk += dz^T·q_u (dout, q_u MN-major: rows are queries)
#pragma unroll
    for (int db = 0; db < NDB; ++db) {
      fence_regs(dv[db]);
      fence_regs(dkv[db]);
    }
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BQT / 16; ++kk)
#pragma unroll
      for (int db = 0; db < NDB; ++db) {
        wgmma_rs64<1>(dv[db], pf[kk],
                      desc(side + db * BOX_BYTES + kk * MN_STEP), 1);
        wgmma_rs64<1>(dkv[db], zf[kk],
                      desc(side + (NDB + db) * BOX_BYTES + kk * MN_STEP), 1);
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int db = 0; db < NDB; ++db) {
      fence_regs(dv[db]);
      fence_regs(dkv[db]);
    }
    fence_regs(pf);
    fence_regs(zf);
    if (lead) bar_arrive(&sempty[ss]);
    if (++ss == 2) {
      ss = 0;
      sph ^= 1;
    }
  }

#pragma unroll
  for (int db = 0; db < NDB; ++db) {
    store_tile(dv[db], dv_ + base * dk, k0 + 64 * wg, T, db * BOX, dk, wq,
               g, tq);
    store_tile(dkv[db], dk_ + base * dk, k0 + 64 * wg, T, db * BOX, dk, wq,
               g, tq);
  }
}

// Query pass: one block per (128 query rows, bh, 4 column boxes of [dq_u ;
// du]); [dq_u ; du] = dz·[k ; V] over the keys below kv_len.
__global__ void __launch_bounds__(THREADS, 1)
    rot_bwd_query_wgmma_kernel(const __grid_constant__ Maps maps,
                               const int* __restrict__ kv_len,
                               __nv_bfloat16* __restrict__ dqu,
                               __nv_bfloat16* __restrict__ du, int T, int dk,
                               int M) {
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQR;
  const int nlo = (dk + BOX - 1) / BOX;
  const int b0 = blockIdx.z * QBOX;
  const int nb = min(QBOX, nlo + (M + BOX - 1) / BOX - b0);
  const int kvl = max(0, min(kv_len[bh], T));
  const int ntiles = (kvl + BOX - 1) / BOX;

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST];
  uint8_t* smem = aligned_smem(smem_raw);
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], CONSUMER_WARPS);
    }
    bar_init_fence();
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Ring ring{smem, full, empty, QUERY_STAGE, NST, 0, 0};

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      for (int t = 0; t < ntiles; ++t) {
        const int key = t * BOX;
        uint8_t* st = ring.stage();
        bar_wait(&ring.empty[ring.s], ring.ph ^ 1);
        bar_expect(&ring.full[ring.s], QUERY_STAGE);
        for (int i = 0; i < BQR / BOX; ++i)  // dz^T: keys x queries
          tma_load(st + i * BOX_BYTES, &maps.dzt, &ring.full[ring.s],
                   q0 + i * BOX, key, bh);
        for (int i = 0; i < QBOX; ++i) {  // past the last: it again
          const int b = b0 + min(i, nb - 1);
          const bool lo = b < nlo;
          tma_load(st + (BQR / BOX + i) * BOX_BYTES,
                   lo ? &maps.k : &maps.vt, &ring.full[ring.s],
                   (lo ? b : b - nlo) * BOX, key, lo ? bh : 0);
        }
        ring.next();
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  // a consumer warpgroup: rows q0 + 64 wg + 16 wq + g (+ 8)
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  const bool lead = lane == 0;
  float acc[QBOX][32];
#pragma unroll
  for (int i = 0; i < QBOX; ++i)
#pragma unroll
    for (int r = 0; r < 32; ++r) acc[i][r] = 0.f;
  int prev = 0;
  for (int t = 0; t < ntiles; ++t) {
    bar_wait(&ring.full[ring.s], ring.ph);
    uint8_t* st = ring.stage();
#pragma unroll
    for (int i = 0; i < QBOX; ++i) fence_regs(acc[i]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BOX / 16; ++kk)
#pragma unroll
      for (int i = 0; i < QBOX; ++i)
        wgmma_ss64<1, 1>(
            acc[i], desc(st + wg * BOX_BYTES + kk * MN_STEP),
            desc(st + (BQR / BOX + i) * BOX_BYTES + kk * MN_STEP), 1);
    wg_commit();
    if (t > 0) {
      wg_wait<1>();
      if (lead) bar_arrive(&ring.empty[prev]);
    }
    prev = ring.s;
    ring.next();
  }
  wg_wait<0>();
#pragma unroll
  for (int i = 0; i < QBOX; ++i) fence_regs(acc[i]);
  if (ntiles > 0 && lead) bar_arrive(&ring.empty[prev]);

  const size_t base = (size_t)bh * T;
#pragma unroll
  for (int i = 0; i < QBOX; ++i) {
    if (i >= nb) continue;
    const int b = b0 + i;
    if (b < nlo)
      store_tile(acc[i], dqu + base * dk, q0 + 64 * wg, T, b * BOX, dk, wq,
                 g, tq);
    else
      store_tile(acc[i], du + base * M, q0 + 64 * wg, T, (b - nlo) * BOX, M,
                 wq, g, tq);
  }
}

template <int NDB>
int launch_key(const Maps& maps, const int* kv_len, const float* lse,
               const float* delta, __nv_bfloat16* dzt, __nv_bfloat16* dk_,
               __nv_bfloat16* dv_, int BH, int T, int T8, int dk, int M,
               cudaStream_t stream) {
  const int smem = key_smem_bytes<NDB>();
  cudaError_t err = cudaFuncSetAttribute(
      rot_bwd_key_wgmma_kernel<NDB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BKEY - 1) / BKEY, BH);
  rot_bwd_key_wgmma_kernel<NDB><<<grid, THREADS, smem, stream>>>(
      maps, kv_len, lse, delta, dzt, dk_, dv_, T, T8, dk, M,
      1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when every launch was accepted.  bf16
// only; 1 <= dk <= 128 and dk, M multiples of 8, every tensor 16-byte
// aligned (the caller checks: ops/rot_attention.py, rot_kernel_form).
// `delta` is f32 scratch of BH * T entries, `dzt` bf16 scratch of BH * T *
// T8 entries (T8 = T rounded up to 8): dz^T, keys by query rows.
extern "C" int lasr_rot_attention_bwd_wgmma(
    const void* qu, const void* u, const void* k, const void* v,
    const void* vt, const void* kv_len, const void* out, const void* lse,
    const void* dout, void* delta, void* dqu, void* du, void* dk, void* dv,
    void* dzt, int BH, int T, int dk_dim, int M, void* stream) {
  if (dk_dim < 8 || dk_dim > 128 || dk_dim % 8 || M < 8 || M % 8 || T < 1 ||
      BH < 1 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {qu, u, k, v, vt, dout, (const void*)dqu,
                        (const void*)du, (const void*)dk, (const void*)dv,
                        (const void*)dzt})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  const int T8 = (T + 7) / 8 * 8;
  Maps maps;
  cudaError_t err = tensor_map(&maps.qu, qu, dk_dim, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.u, u, M, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.k, k, dk_dim, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.v, v, dk_dim, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.vt, vt, M, T, 1);
  if (err == cudaSuccess) err = tensor_map(&maps.dout, dout, dk_dim, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.dzt, dzt, T8, T, BH);
  if (err != cudaSuccess) return (int)err;
  const int* kl = static_cast<const int*>(kv_len);
  const float* ls = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  auto* z = static_cast<__nv_bfloat16*>(dzt);
  auto* gq = static_cast<__nv_bfloat16*>(dqu);
  auto* gu = static_cast<__nv_bfloat16*>(du);
  auto* gk = static_cast<__nv_bfloat16*>(dk);
  auto* gv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const int rows = BH * T;
  rot_bwd_delta_kernel<<<(rows + 3) / 4, 128, 0, st>>>(
      static_cast<const __nv_bfloat16*>(out),
      static_cast<const __nv_bfloat16*>(dout), dl, rows, dk_dim);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = dk_dim <= BOX
                     ? launch_key<1>(maps, kl, ls, dl, z, gk, gv, BH, T, T8,
                                     dk_dim, M, st)
                     : launch_key<2>(maps, kl, ls, dl, z, gk, gv, BH, T, T8,
                                     dk_dim, M, st);
  if (rc != 0) return rc;
  const int smem = query_smem_bytes();
  err = cudaFuncSetAttribute(rot_bwd_query_wgmma_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return (int)err;
  const int nbox = (dk_dim + BOX - 1) / BOX + (M + BOX - 1) / BOX;
  const dim3 grid((T + BQR - 1) / BQR, BH, (nbox + QBOX - 1) / QBOX);
  rot_bwd_query_wgmma_kernel<<<grid, THREADS, smem, st>>>(maps, kl, gq, gu,
                                                          T, dk_dim, M);
  return (int)cudaGetLastError();
}
