// Tile copies from device memory into shared memory for the attention
// kernels on sm_90a: f32 tiles, bf16 widened to f32 on the way in.
//
// A tile is R rows of [a | b] (two row-major sources side by side), zero
// before row 0, past a row limit and in its padding columns, stored in
// shared memory with a row stride ld.  Three routes:
//  - cp.async straight into the f32 tile (f32 inputs), 16-byte copies
//    where every width and base allows, else 4-byte;
//  - cp.async of raw bf16 into a staging tile, widened to f32 in shared
//    memory once it has landed;
//  - loads through registers (bf16 of odd width), 16 in flight per thread.
// A kernel issues a streamed tile's copies, computes on the current tile,
// and lands the next one after cp_async_wait and a barrier.  A block
// that uses these has NWARPS warps, or the NW that each call names.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

namespace lasr_tile {

constexpr int NWARPS = 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
// A global load widened to f32 (bf16 through its bits, so the compiler
// keeps many in flight).
__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __uint_as_float(
      (unsigned)*reinterpret_cast<const unsigned short*>(p) << 16);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// cp.async: global -> shared copies that bypass the registers; a source
// size of 0 writes zeros.
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// waits until at most `pending` committed groups are in flight (0 or 1)
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The source of one shared tile: rows r0 .. r0+R-1 of [a | b], a wa wide
// and b wb wide (row strides wa, wb), zero before row 0 (r0 may be
// negative: one unsigned compare with rmax >= 0 tests both ends), at or
// past row rmax and in
// columns wa+wb .. width-1; the f32 tile's row stride is ld.
template <typename T>
struct Src {
  const T* a;
  const T* b;
  int wa, wb, rmax, width, ld;
};

// The tile into s (f32) through registers.  A warp takes R/8 rows, a lane
// every 32nd column, 4 columns of each row per round: 16 loads in flight
// per thread (every load is issued, from a valid address, and masked
// after it returns, so none waits behind a branch).
template <int R, typename T, int NW = NWARPS>
__device__ __forceinline__ void load_rows(const Src<T>& src, int r0,
                                          float* __restrict__ s) {
  static_assert(R % NW == 0, "rows split evenly over the warps");
  constexpr int RW = R / NW;
  constexpr int CB = 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = src.wa + src.wb;
  for (int e0 = 0; e0 < src.width; e0 += 32 * CB) {
    float x[RW][CB];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int row = r0 + warp + NW * i;
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const int e = e0 + lane + 32 * c;
        const bool ok = (unsigned)row < (unsigned)src.rmax && e < w;
        const T* p = e < src.wa ? src.a + (size_t)row * src.wa + e
                                : src.b + (size_t)row * src.wb + (e - src.wa);
        const float val = load_f32(ok ? p : src.a);
        x[i][c] = ok ? val : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
#pragma unroll
      for (int c = 0; c < CB; ++c) {
        const int e = e0 + lane + 32 * c;
        if (e < src.width) s[(warp + NW * i) * src.ld + e] = x[i][c];
      }
    }
  }
}

// The tile by cp.async into s (element type T, row stride ld), `chunk`
// elements per copy (16 or 4 bytes; wa, wb and the bases multiples of
// it); it lands at the next cp_async_wait.
template <int R, typename T, int NW = NWARPS>
__device__ __forceinline__ void copy_rows(const Src<T>& src, int r0, T* s,
                                          int ld, int chunk) {
  static_assert(R % NW == 0, "rows split evenly over the warps");
  constexpr int RW = R / NW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int w = src.wa + src.wb;
  const bool wide = chunk * (int)sizeof(T) == 16;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + NW * i, row = r0 + r;
    for (int e = lane * chunk; e < src.width; e += 32 * chunk) {
      const bool ok = (unsigned)row < (unsigned)src.rmax && e < w;
      const T* p = e < src.wa ? src.a + (size_t)row * src.wa + e
                              : src.b + (size_t)row * src.wb + (e - src.wa);
      if (wide)
        cp_async16(s + r * ld + e, ok ? p : src.a, ok);
      else
        cp_async4(s + r * ld + e, ok ? p : src.a, ok);
    }
  }
}

// A raw bf16 tile (row stride width) widened into s (row stride ld).
template <int R, int NW = NWARPS>
__device__ __forceinline__ void widen_rows(const __nv_bfloat16* raw,
                                           int width, float* s, int ld) {
  static_assert(R % NW == 0, "rows split evenly over the warps");
  constexpr int RW = R / NW;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < RW; ++i) {
    const int r = warp + NW * i;
    const __nv_bfloat162* in =
        reinterpret_cast<const __nv_bfloat162*>(raw + r * width);
    float2* out = reinterpret_cast<float2*>(s + r * ld);
    for (int e = lane; e < width / 2; e += 32)
      out[e] = __bfloat1622float2(in[e]);
  }
}

// Narrow tiles (a row of a few copies, as at dk = 40): copy_rows and
// widen_rows give each warp whole rows, so most lanes idle and each
// thread issues a copy per row.  The *_spread forms deal the tile's
// (row, piece) positions over all 32 NW threads in turn instead (the
// same rows, zeros and routes); a thread steps its position by a fixed
// (rows, pieces) stride, with no division per piece (K3's forward,
// PERF.md PR 7).

// A thread's position in a tile of rows `per` pieces wide, and its step
// to the next one 32 NW pieces on.
template <int NW>
struct Walk {
  int r, c, dr, dc, per;
  __device__ __forceinline__ explicit Walk(int per_) : per(per_) {
    r = threadIdx.x / per;
    c = threadIdx.x - r * per;
    dr = 32 * NW / per;
    dc = 32 * NW - dr * per;
  }
  __device__ __forceinline__ void next() {
    r += dr;
    c += dc;
    if (c >= per) {
      c -= per;
      ++r;
    }
  }
};

// The tile by cp.async, as copy_rows.
template <int R, typename T, int NW>
__device__ __forceinline__ void copy_spread(const Src<T>& src, int r0, T* s,
                                            int ld, int chunk) {
  const int w = src.wa + src.wb;
  const bool wide = chunk * (int)sizeof(T) == 16;
  for (Walk<NW> at(src.width / chunk); at.r < R; at.next()) {
    const int e = at.c * chunk, row = r0 + at.r;
    const bool ok = (unsigned)row < (unsigned)src.rmax && e < w;
    const T* p = e < src.wa ? src.a + (size_t)row * src.wa + e
                            : src.b + (size_t)row * src.wb + (e - src.wa);
    if (wide)
      cp_async16(s + at.r * ld + e, ok ? p : src.a, ok);
    else
      cp_async4(s + at.r * ld + e, ok ? p : src.a, ok);
  }
}

// A raw bf16 tile widened, as widen_rows: each thread loads U pairs
// before it stores any, so the loads are in flight together (a store
// may alias the next load, so the compiler keeps them in order).
template <int R, int NW>
__device__ __forceinline__ void widen_spread(const __nv_bfloat16* raw,
                                             int width, float* s, int ld) {
  constexpr int U = 4;
  const int half = width / 2;
  const __nv_bfloat162* in = reinterpret_cast<const __nv_bfloat162*>(raw);
  for (Walk<NW> at(half); at.r < R;) {
    __nv_bfloat162 x[U];
    int to[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = at.r < R;
      x[u] = in[ok ? at.r * half + at.c : 0];
      to[u] = ok ? at.r * ld + 2 * at.c : -1;
      at.next();
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (to[u] >= 0)
        *reinterpret_cast<float2*>(s + to[u]) = __bfloat1622float2(x[u]);
  }
}

// The route of a kernel's copies (Dims: any struct with the fields
// `chunk`, elements per cp.async copy, 0 for registers, and `raw`, bf16
// tiles staged raw and widened in shared memory; SPREAD: the *_spread
// forms of the copies).

// A resident tile, loaded once: by cp.async for f32 (it lands with the
// first step's wait), through registers for bf16.
template <int R, typename T, typename Dims, int NW = NWARPS,
          bool SPREAD = false>
__device__ __forceinline__ void load_resident(const Src<T>& src, int r0,
                                              float* s, const Dims& D) {
  if constexpr (std::is_same<T, float>::value && SPREAD)
    copy_spread<R, T, NW>(src, r0, s, src.ld, D.chunk);
  else if constexpr (std::is_same<T, float>::value)
    copy_rows<R, T, NW>(src, r0, s, src.ld, D.chunk);
  else
    load_rows<R, T, NW>(src, r0, s);
}

// Starts the copies of a streamed tile: f32 straight into its buffer s,
// bf16 into the raw staging tile (nothing where bf16 goes through
// registers).
template <int R, typename T, typename Dims, int NW = NWARPS,
          bool SPREAD = false>
__device__ __forceinline__ void issue(const Src<T>& src, int r0, float* s,
                                      void* raw, const Dims& D) {
  if constexpr (SPREAD) {
    if constexpr (std::is_same<T, float>::value)
      copy_spread<R, T, NW>(src, r0, s, src.ld, D.chunk);
    else if (D.raw)
      copy_spread<R, T, NW>(src, r0, static_cast<T*>(raw), src.width,
                            D.chunk);
  } else if constexpr (std::is_same<T, float>::value)
    copy_rows<R, T, NW>(src, r0, s, src.ld, D.chunk);
  else if (D.raw)
    copy_rows<R, T, NW>(src, r0, static_cast<T*>(raw), src.width, D.chunk);
}

// After the copies landed (wait, then a barrier): bf16 is widened from the
// staging tile, or loaded through registers; f32 is in place already.
template <int R, typename T, typename Dims, int NW = NWARPS,
          bool SPREAD = false>
__device__ __forceinline__ void land(const Src<T>& src, int r0, float* s,
                                     const void* raw, const Dims& D) {
  if constexpr (!std::is_same<T, float>::value) {
    if (D.raw && SPREAD)
      widen_spread<R, NW>(static_cast<const __nv_bfloat16*>(raw), src.width,
                          s, src.ld);
    else if (D.raw)
      widen_rows<R, NW>(static_cast<const __nv_bfloat16*>(raw), src.width,
                        s, src.ld);
    else
      load_rows<R, T, NW>(src, r0, s);
  }
}

// Column chunks of a wide tile (K1 / K2's wide form, where a row of
// [q_u ; u] does not fit a block): columns c0 .. c0+width-1 of rows r0 ..
// r0+R-1 of [a | b], a wa wide and b wb wide (row strides wa, wb), zero
// before row 0, at or past row rmax and at or past column wa+wb; the f32
// tile's row stride is ld (a raw bf16 tile's is width).  The pieces of a
// tile are dealt over all 32 NW threads (Walk).
template <typename T>
struct Cols {
  const T* a;
  const T* b;
  int wa, wb, rmax, c0, width, ld;
};

template <typename T>
__device__ __forceinline__ const T* col_ptr(const Cols<T>& src, int row,
                                            int col) {
  return col < src.wa ? src.a + (size_t)row * src.wa + col
                      : src.b + (size_t)row * src.wb + (col - src.wa);
}

// By cp.async into s (element type T, row stride ld), `chunk` elements a
// copy (16 or 4 bytes; wa, wb, c0 and the bases multiples of it).
template <int R, typename T, int NW = NWARPS>
__device__ __forceinline__ void copy_cols(const Cols<T>& src, int r0, T* s,
                                          int ld, int chunk) {
  const int w = src.wa + src.wb;
  const bool wide = chunk * (int)sizeof(T) == 16;
  for (Walk<NW> at(src.width / chunk); at.r < R; at.next()) {
    const int e = at.c * chunk, row = r0 + at.r, col = src.c0 + e;
    const bool ok = (unsigned)row < (unsigned)src.rmax && col < w;
    const T* p = ok ? col_ptr(src, row, col) : src.a;
    if (wide)
      cp_async16(s + at.r * ld + e, p, ok);
    else
      cp_async4(s + at.r * ld + e, p, ok);
  }
}

// Through registers into the f32 tile s (bf16 of odd width).
template <int R, typename T, int NW = NWARPS>
__device__ __forceinline__ void load_cols(const Cols<T>& src, int r0,
                                          float* s) {
  const int w = src.wa + src.wb;
  for (Walk<NW> at(src.width); at.r < R; at.next()) {
    const int row = r0 + at.r, col = src.c0 + at.c;
    const bool ok = (unsigned)row < (unsigned)src.rmax && col < w;
    s[at.r * src.ld + at.c] = ok ? load_f32(col_ptr(src, row, col)) : 0.f;
  }
}

// issue / land for a column chunk, by the routes of issue / land above.
template <int R, typename T, typename Dims, int NW = NWARPS>
__device__ __forceinline__ void issue_cols(const Cols<T>& src, int r0,
                                           float* s, void* raw,
                                           const Dims& D) {
  if constexpr (std::is_same<T, float>::value)
    copy_cols<R, T, NW>(src, r0, s, src.ld, D.chunk);
  else if (D.raw)
    copy_cols<R, T, NW>(src, r0, static_cast<T*>(raw), src.width, D.chunk);
}

template <int R, typename T, typename Dims, int NW = NWARPS>
__device__ __forceinline__ void land_cols(const Cols<T>& src, int r0,
                                          float* s, const void* raw,
                                          const Dims& D) {
  if constexpr (!std::is_same<T, float>::value) {
    if (D.raw)
      widen_rows<R, NW>(static_cast<const __nv_bfloat16*>(raw), src.width, s,
                        src.ld);
    else
      load_cols<R, T, NW>(src, r0, s);
  }
}

}  // namespace lasr_tile
