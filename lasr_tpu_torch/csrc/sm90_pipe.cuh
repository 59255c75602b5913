// Hopper (sm_90a) building blocks of the bf16 wide forms of K1 and K2
// (csrc/rot_attention_sm90.cu, csrc/rot_attention_bwd_sm90.cu): tensor
// maps, TMA copies and mbarriers, wgmma, and the main loop the two share.
//
// The main loop computes S = [q_u ; u]·[k ; V]^T for a tile of rows of one
// side against a tile of rows of the other (K1: query rows against keys;
// K2's key pass: keys against query rows).  S's depth, E = dk + M, streams
// in chunks of 64 bf16 columns: ceil(dk / 64) chunks of the dk-wide
// tensor (q_u or k), then ceil(M / 64) of the M-wide one (u, or the table
// V that every bh shares).  A producer warp copies each chunk's tiles by
// TMA, in 64 x 64 boxes with the 128-byte swizzle, into a ring of stages
// in shared memory and signals each stage's full barrier; TMA's zero fill
// past a tensor's edge pads dk, M, the last rows and the last keys, so no
// padded copy of any input exists.  Two consumer warpgroups, 64 rows each,
// run wgmma m64nNk16 (bf16 in, f32 accumulators in registers) straight on
// the swizzled boxes and release a stage through its empty barrier once
// its products are done.
//
// A block is three warpgroups: the producer (warps 8-11; one thread copies,
// the group gives its registers to the others) and the two consumers.
//
// Each TMA box is 64 rows of 128 bytes (8 KB), 1024-byte aligned: the
// canonical 128-byte-swizzled layout of a wgmma operand, K-major (rows of
// the depth) or MN-major (rows of the product's depth, columns of M or N),
// whose 8-row groups lie 1024 bytes apart.  A K-major operand steps its
// 16-column depth steps by 32 bytes inside the box, an MN-major one by 16
// rows (2048 bytes).  Every MN-major operand here is one box wide (N or
// M = 64), so a descriptor never spans two boxes.
#pragma once

#include <cuda.h>  // CUtensorMap; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lasr_sm90 {

constexpr int BOX = 64;                   // rows, and bf16 columns, of a box
constexpr int BOX_BYTES = BOX * BOX * 2;  // 8 KB
constexpr int CONSUMER_WARPS = 8;         // two consumer warpgroups
constexpr int THREADS = 32 * (CONSUMER_WARPS + 4);  // and a producer one
// registers a thread, moved from the producer warpgroup (one thread of it
// copies) to the consumers (setmaxnreg): 128 x 40 + 256 x 232 of the SM's
// 65,536 (a block of 384 threads starts at 168, where the key pass of K2
// spilled its accumulators)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int MN_STEP = 16 * 128;         // an MN-major operand's depth step
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------- host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime, so the
// library does not link libcuda.
inline cudaError_t tensor_map_encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return err;
    if (found != cudaDriverEntryPointSuccess || p == nullptr)
      return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// The map of a (batch, rows, cols) bf16 tensor at `base` (16-byte
// aligned; cols a multiple of 8, so every row is a multiple of 16 bytes),
// read in 64 x 64 boxes with the 128-byte swizzle, zeros past each edge.
inline cudaError_t tensor_map(CUtensorMap* map, const void* base, int cols,
                              int rows, int batch) {
  EncodeTiled encode;
  cudaError_t err = tensor_map_encoder(&encode);
  if (err != cudaSuccess) return err;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * rows * 2};
  const cuuint32_t box[3] = {BOX, BOX, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---------------------------------------------------------------- device

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA copies to come
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// until the phase of parity `parity` has completed; a wait of more than
// 10 s (a copy or an arrival that never comes) traps, so the launch fails
// instead of holding the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t tries = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if ((++tries & 1023) == 0) {
      if (t0 == 0)
        t0 = global_ns();
      else if (global_ns() - t0 > 10000000000ull)
        asm volatile("trap;");
    }
  }
}

// the box at (column c0, row c1, batch c2) of `map` into `dst`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(
          smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(smem_addr(bar))
      : "memory");
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(N));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keep registers that an in-flight wgmma reads or writes out of the
// compiler's reach until the wait that ends it
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// The descriptor of a 128-byte-swizzled operand starting at `p`: 8-row
// groups 1024 bytes apart (the stride field); the leading field is unused
// (K-major, or an MN-major operand one box wide).  Adding n to it moves
// the start by 16 n bytes.
__device__ __forceinline__ uint64_t desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// a pair of f32 as two bf16 (the first in the low half): one register of
// a wgmma A fragment, or one 4-byte store
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// D(64 x 64, f32) (+)= A(64 x 16) * B(16 x 64), both bf16 from shared
// memory through their descriptors; TA / TB: 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// D(64 x 128, f32) (+)= A(64 x 16) * B(16 x 128), both bf16 from shared
// memory through their descriptors; TA / TB: 1 for an MN-major operand.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss128(float (&d)[64], uint64_t a,
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TA), "n"(TB));
}

// D(64 x 64, f32) (+)= A(64 x 16, bf16 fragments in registers, the
// accumulator's layout) * B(16 x 64, bf16 in shared memory); TB as above.
template <int TB>
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
        "r"(accumulate), "n"(TB));
}

// An accumulator's columns as the A fragments of a product over them:
// column block kk (16 columns) of the 64 x 16 NK accumulator is A's
// depth step kk (the f32 accumulator layout of m64nNk16 is, pair for
// pair, the bf16 register-fragment layout of A).
template <int NK>
__device__ __forceinline__ void to_a_frags(const float (&d)[8 * NK],
                                           uint32_t (&a)[NK][4]) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = pack_bf16(d[8 * kk + 2 * r], d[8 * kk + 2 * r + 1]);
}

// A ring of stages in shared memory, each with a full barrier (the
// producer's one arrival and the TMA bytes) and an empty one (one arrival
// from each consumer warp).  The producer and each consumer thread keep
// their own copy of the position: stage s and the parity of its round.
struct Ring {
  uint8_t* base;
  uint64_t* full;
  uint64_t* empty;
  int bytes;
  int nst;
  int s;
  uint32_t ph;
  __device__ uint8_t* stage() const { return base + s * bytes; }
  __device__ void next() {
    if (++s == nst) {
      s = 0;
      ph ^= 1;
    }
  }
};

// One operand side of S: its dk-wide tensor `lo` (q_u or k) and its
// M-wide one `hi` (u, or the table V, which every bh shares: batch 0).
struct Side {
  const CUtensorMap* lo;
  const CUtensorMap* hi;
  bool hi_shared;
};

// Depth chunk c of S (64 columns; chunks c < nlo are lo's) for nbox boxes
// of 64 rows from row0, into consecutive boxes at dst.
__device__ __forceinline__ void load_chunk(const Side& side, int c, int nlo,
                                           int row0, int nbox, int bh,
                                           uint8_t* dst, uint64_t* bar) {
  const bool lo = c < nlo;
  const CUtensorMap* map = lo ? side.lo : side.hi;
  const int col = (lo ? c : c - nlo) * BOX;
  const int batch = lo || !side.hi_shared ? bh : 0;
  for (int i = 0; i < nbox; ++i)
    tma_load(dst + i * BOX_BYTES, map, bar, col, row0 + i * BOX, batch);
}

// The main loop's producer (one thread): every depth chunk of S for the
// NA * 64 rows of side a from a0 against the NB * 64 rows of side b from
// b0; a stage holds a's boxes, then b's.
template <int NA, int NB>
__device__ __forceinline__ void produce_scores(Ring& r, const Side& a,
                                               int a0, const Side& b, int b0,
                                               int bh, int nchunks,
                                               int nlo) {
  for (int c = 0; c < nchunks; ++c) {
    bar_wait(&r.empty[r.s], r.ph ^ 1);
    bar_expect(&r.full[r.s], (NA + NB) * BOX_BYTES);
    load_chunk(a, c, nlo, a0, NA, bh, r.stage(), &r.full[r.s]);
    load_chunk(b, c, nlo, b0, NB, bh, r.stage() + NA * BOX_BYTES,
               &r.full[r.s]);
    r.next();
  }
}

// The main loop's consumer (a warpgroup): acc = its 64 rows of side a
// (box `abox` of each stage) times the NB * 64 rows of side b, summed over
// S's whole depth (acc is overwritten).  A stage is released once the
// products that read it are done: the wait for all but the latest group.
template <int NA, int NB>
__device__ __forceinline__ void consume_scores(float (&acc)[32 * NB],
                                               Ring& r, int abox,
                                               int nchunks) {
  static_assert(NB == 1 || NB == 2, "64 or 128 columns of S");
  const bool lead = (threadIdx.x & 31) == 0;
  int prev = 0;
  fence_regs(acc);
  for (int c = 0; c < nchunks; ++c) {
    bar_wait(&r.full[r.s], r.ph);
    const uint64_t da = desc(r.stage() + abox * BOX_BYTES);
    const uint64_t db = desc(r.stage() + NA * BOX_BYTES);
    wg_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {  // 16 columns of depth: 32 bytes
      if constexpr (NB == 2)
        wgmma_ss128<0, 0>(acc, da + 2 * k, db + 2 * k, c > 0 || k > 0);
      else
        wgmma_ss64<0, 0>(acc, da + 2 * k, db + 2 * k, c > 0 || k > 0);
    }
    wg_commit();
    if (c > 0) {
      wg_wait<1>();
      if (lead) bar_arrive(&r.empty[prev]);
    }
    prev = r.s;
    r.next();
  }
  wg_wait<0>();
  fence_regs(acc);
  if (nchunks > 0 && lead) bar_arrive(&r.empty[prev]);
}

// The 1024-byte-aligned start of the dynamic shared memory (the 128-byte
// swizzle's pattern repeats every 1024 bytes): launches ask for 1 KB more.
__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  const uint32_t a = smem_addr(raw);
  return raw + ((1024 - (a & 1023)) & 1023);
}

}  // namespace lasr_sm90
