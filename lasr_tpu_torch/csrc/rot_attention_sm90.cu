// Fused rotated-fold rel-pos attention, forward, bf16 wide form — CUDA C++
// for sm_90a (wgmma and TMA).
//
// Replaces the Pallas TPU kernel lasr_tpu/ops/rot_attention.py
// `_fwd_kernel` (driven by `_rot_attention_pallas`) for bf16 inputs where
// K1 takes its wide form (ops/rot_attention.py, rot_kernel_form: dk > 64,
// or a [q_u ; u] row too wide for the narrow tiles) and TMA can describe
// the tensors (dk and M multiples of 8, 16-byte-aligned bases).  The same
// function as csrc/rot_attention.cu:
//
//   out[bh,i] = softmax_j[(q_u[bh,i]·k[bh,j] + u[bh,i]·V[j]) / sqrt(dk),
//                         j < kv_len[bh]] @ v[bh]
//   lse[bh,i] = log-sum-exp of the same masked scores (f32)
//
// q_u, k, v: (BH, T, dk); u: (BH, T, M); V: (T, M); kv_len: (BH,) int32;
// all bf16 but kv_len.  A row with kv_len == 0 writes zeros and lse = +inf.
//
// What bounds it on an H100: at the 1B training shape (BH = 512, T = 388,
// dk = 80, M = 1280) the bytes it must move (u alone is 508 MB) take
// 185 us at HBM's rate, a little more than its ~0.17 ms of bf16
// tensor-core work (the score contraction over E = 1360 columns a pair):
// the bytes bound it.  What holds it above that bound is L2: a block
// re-reads its [q_u ; u] chunks for every key tile, ~3.7 GB of L2 reads
// a call, hence 128 query rows a block (each chunk feeds 128 rows, not
// 32).  The wide form of csrc/rot_attention.cu (WIDE),
// which bf16 took before, widened bf16 to f32 in shared memory for TF32
// mma.sync products, fed each 128-column chunk to 32 query rows only, and
// summed S from 8 per-warp partials in shared memory: 85x its tensor-core
// bound.
//
// Design (csrc/sm90_pipe.cuh's main loop):
//  - grid (ceil(T / 128), BH), 384 threads: a block owns 128 query rows,
//    two consumer warpgroups of 64 rows each and a producer warpgroup, and
//    walks the 128-key tiles below kv_len (the TPU's sequential grid axis).
//  - per key tile, S (64 x 128 a warpgroup, f32 in registers) is summed
//    over S's depth by wgmma m64n128k16 straight from the ring of 4 stages
//    (a stage: the chunk's 128 query rows and 128 keys, 32 KB), so every
//    chunk the producer copies feeds 128 rows;
//  - the online softmax runs on the accumulator's register layout: a
//    thread holds 2 rows x 32 keys, the 4 threads of a row reduce by
//    shuffles; the running max m and the sum l (of the unrounded P, per
//    thread until the end) in f32, the rescale alpha;
//  - P rounded to bf16 (what the TPU kernel does with prob.astype(v.dtype))
//    is the register A operand of P·v (wgmma m64n64k16 per 64 columns of
//    dk, v MN-major by TMA into one of two slots of the key tile's v); O
//    stays in f32 registers, rescaled and accumulated in f32;
//  - out = O / l and lse = m + log l at the end.
// Shared memory: 4 x 32 KB stages and 2 x 32 KB of v at dk > 64 (193 KB);
// one block an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

#include "sm90_pipe.cuh"

namespace {

using namespace lasr_sm90;

constexpr int BQ = 128;  // query rows a block: two warpgroups of 64
constexpr int BK = 128;  // keys a tile
constexpr int NST = 4;   // stages of the ring
constexpr int STAGE_BYTES = (BQ + BK) / BOX * BOX_BYTES;

struct Maps {
  CUtensorMap qu, u, k, v, vt;
};

// bytes of one v slot: NDB column boxes of dk, 128 keys each
template <int NDB>
__host__ __device__ constexpr int vslot_bytes() {
  return NDB * (BK / BOX) * BOX_BYTES;
}

template <int NDB>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + NST * STAGE_BYTES + 2 * vslot_bytes<NDB>();
}

// NDB: 64-column boxes of dk (1 for dk <= 64, else 2)
template <int NDB>
__global__ void __launch_bounds__(THREADS, 1)
    rot_attention_fwd_wgmma_kernel(const __grid_constant__ Maps maps,
                                   const int* __restrict__ kv_len,
                                   __nv_bfloat16* __restrict__ out,
                                   float* __restrict__ lse, int T, int dk,
                                   int M, float scale) {
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * T;
  const int kvl = max(0, min(kv_len[bh], T));
  if (kvl == 0) {
    for (int idx = threadIdx.x; idx < BQ * dk; idx += THREADS) {
      const int r = idx / dk, row = q0 + r;
      if (row < T)
        out[(base + row) * dk + (idx - r * dk)] = __float2bfloat16(0.f);
    }
    for (int r = threadIdx.x; r < BQ; r += THREADS)
      if (q0 + r < T) lse[base + q0 + r] = INFINITY;
    return;
  }

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST], empty[NST], vfull[2],
      vempty[2];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* vslots = smem + NST * STAGE_BYTES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < NST; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], CONSUMER_WARPS);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&vfull[i], 1);
      bar_init(&vempty[i], CONSUMER_WARPS);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int nlo = (dk + BOX - 1) / BOX;
  const int nchunks = nlo + (M + BOX - 1) / BOX;
  const int ntiles = (kvl + BK - 1) / BK;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  Ring ring{smem, full, empty, STAGE_BYTES, NST, 0, 0};

  if (warp >= CONSUMER_WARPS) {  // the producer warpgroup
    reg_dealloc<PRODUCER_REGS>();
    if (warp == CONSUMER_WARPS && lane == 0) {
      const Side q{&maps.qu, &maps.u, false};
      const Side kk{&maps.k, &maps.vt, true};
      int vs = 0;
      uint32_t vph = 0;
      for (int t = 0; t < ntiles; ++t) {
        const int k0 = t * BK;
        uint8_t* slot = vslots + vs * vslot_bytes<NDB>();
        bar_wait(&vempty[vs], vph ^ 1);
        bar_expect(&vfull[vs], vslot_bytes<NDB>());
        for (int db = 0; db < NDB; ++db)
          for (int h = 0; h < BK / BOX; ++h)
            tma_load(slot + (db * (BK / BOX) + h) * BOX_BYTES, &maps.v,
                     &vfull[vs], db * BOX, k0 + h * BOX, bh);
        if (++vs == 2) {
          vs = 0;
          vph ^= 1;
        }
        produce_scores<BQ / BOX, BK / BOX>(ring, q, q0, kk, k0, bh, nchunks,
                                           nlo);
      }
    }
    return;
  }

  reg_alloc<CONSUMER_REGS>();
  // a consumer warpgroup: rows q0 + 64 wg + 16 wq + g (+ 8)
  const int wg = warp >> 2, wq = warp & 3, g = lane >> 2, tq = lane & 3;
  const bool lead = lane == 0;
  const float sl2 = scale * LOG2E;  // scores in log2 units
  float s[BK / 2], o[NDB][32];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int db = 0; db < NDB; ++db)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[db][i] = 0.f;
  int vs = 0;
  uint32_t vph = 0;

  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BK;
    consume_scores<BQ / BOX, BK / BOX>(s, ring, wg, nchunks);
    // the online softmax; element i: row g + 8 ((i >> 1) & 1), key
    // k0 + 8 (i >> 2) + 2 tq + (i & 1)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const bool valid = k0 + 8 * j + 2 * tq + e < kvl;
          s[i] = valid ? s[i] * sl2 : -INFINITY;
          mx = fmaxf(mx, s[i]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mnew = fmaxf(m[h], mx);  // finite: key k0 < kvl
      const float alpha = exp2f(m[h] - mnew);
      m[h] = mnew;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          s[i] = exp2f(s[i] - mnew);
          sum += s[i];
        }
      l[h] = l[h] * alpha + sum;
#pragma unroll
      for (int db = 0; db < NDB; ++db)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          o[db][4 * j + 2 * h] *= alpha;
          o[db][4 * j + 2 * h + 1] *= alpha;
        }
    }
    uint32_t p[BK / 16][4];
    to_a_frags<BK / 16>(s, p);
    // O += P·v over the tile's 128 keys, v MN-major from its slot
    bar_wait(&vfull[vs], vph);
    uint8_t* slot = vslots + vs * vslot_bytes<NDB>();
#pragma unroll
    for (int db = 0; db < NDB; ++db) fence_regs(o[db]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int db = 0; db < NDB; ++db)
        wgmma_rs64<1>(o[db], p[kk],
                      desc(slot + db * (BK / BOX) * BOX_BYTES +
                           kk * MN_STEP),
                      1);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int db = 0; db < NDB; ++db) fence_regs(o[db]);
    fence_regs(p);
    if (lead) bar_arrive(&vempty[vs]);
    if (++vs == 2) {
      vs = 0;
      vph ^= 1;
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    const int row = q0 + 64 * wg + 16 * wq + g + 8 * h;
    if (row >= T) continue;
    if (tq == 0) lse[base + row] = (m[h] + log2f(l[h])) * LN2;
    const float inv = 1.f / l[h];
    __nv_bfloat16* orow = out + (base + row) * dk;
#pragma unroll
    for (int db = 0; db < NDB; ++db)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = db * BOX + 8 * j + 2 * tq;
        if (col < dk)
          *reinterpret_cast<uint32_t*>(orow + col) =
              pack_bf16(o[db][4 * j + 2 * h] * inv,
                        o[db][4 * j + 2 * h + 1] * inv);
      }
  }
}

template <int NDB>
int launch(const Maps& maps, const int* kv_len, __nv_bfloat16* out,
           float* lse, int BH, int T, int dk, int M, cudaStream_t stream) {
  const int smem = smem_bytes<NDB>();
  cudaError_t err = cudaFuncSetAttribute(
      rot_attention_fwd_wgmma_kernel<NDB>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, BH);
  rot_attention_fwd_wgmma_kernel<NDB><<<grid, THREADS, smem, stream>>>(
      maps, kv_len, out, lse, T, dk, M, 1.0f / sqrtf((float)dk));
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t code: 0 when the launch was accepted.  bf16 only;
// 1 <= dk <= 128 and dk, M multiples of 8, every tensor 16-byte aligned
// (the caller checks: ops/rot_attention.py, rot_kernel_form).
extern "C" int lasr_rot_attention_fwd_wgmma(const void* qu, const void* u,
                                            const void* k, const void* v,
                                            const void* vt,
                                            const void* kv_len, void* out,
                                            void* lse, int BH, int T, int dk,
                                            int M, void* stream) {
  if (dk < 8 || dk > 128 || dk % 8 || M < 8 || M % 8 || T < 1 || BH < 1 ||
      BH > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* p : {qu, u, k, v, vt, (const void*)out})
    if (!aligned16(p)) return (int)cudaErrorInvalidValue;
  Maps maps;
  cudaError_t err = tensor_map(&maps.qu, qu, dk, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.u, u, M, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.k, k, dk, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.v, v, dk, T, BH);
  if (err == cudaSuccess) err = tensor_map(&maps.vt, vt, M, T, 1);
  if (err != cudaSuccess) return (int)err;
  const int* kl = static_cast<const int*>(kv_len);
  auto* o = static_cast<__nv_bfloat16*>(out);
  auto* ls = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dk <= BOX ? launch<1>(maps, kl, o, ls, BH, T, dk, M, st)
                   : launch<2>(maps, kl, o, ls, BH, T, dk, M, st);
}
