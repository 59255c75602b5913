// Tensor-core tiles for f32 attention kernels on sm_90a: WMMA m16n16k8
// fragments in TF32 with f32 accumulators (they compile to mma.sync).
//
// TF32 keeps 10 mantissa bits, so one product of f32 operands is good to
// about 1e-3.  For f32 inputs the kernels use the 3xTF32 split: each
// operand x becomes hi (x with its low 13 mantissa bits cleared, a TF32
// value) and lo = x - hi (exact in f32), and
//
//   a·b ~= a_hi·b_hi + a_hi·b_lo + a_lo·b_hi
//
// The tensor cores read lo's top TF32 bits and a_lo·b_lo is dropped, so
// the product is good to about 2^-20 relative: f32 accuracy at three
// tensor-core products.  hi is cut with one bitwise AND: the rounding
// conversion (cvt.rna.tf32.f32) on every fragment element made the
// kernels' inner loops much slower on the card, at the same accuracy.
// bf16 inputs widened to f32 are exact in TF32, so one product
// (NSPLIT = 1) with no conversion is exact for them; only values
// computed in f32 inside a kernel (probabilities, score gradients) are
// cut to TF32, which is finer than bf16.
//
// Operands come from shared memory with load_matrix_sync: the tile origin
// 32-byte aligned and the row (or column) stride a multiple of 4 floats.

#pragma once

#include <mma.h>

namespace lasr_mma {

namespace wmma = nvcuda::wmma;

constexpr int TM = 16;  // rows of an output tile
constexpr int TN = 16;  // columns of an output tile
constexpr int TK = 8;   // depth of one product

template <typename Layout>
using FragA = wmma::fragment<wmma::matrix_a, TM, TN, TK,
                             wmma::precision::tf32, Layout>;
template <typename Layout>
using FragB = wmma::fragment<wmma::matrix_b, TM, TN, TK,
                             wmma::precision::tf32, Layout>;
using FragC = wmma::fragment<wmma::accumulator, TM, TN, TK, float>;
using RowMajor = wmma::row_major;
using ColMajor = wmma::col_major;

// An operand fragment split into NSPLIT TF32 parts (1: hi; 3: hi and lo).
template <typename Frag, int NSPLIT>
struct Split;
template <typename Frag>
struct Split<Frag, 1> {
  Frag hi;
};
template <typename Frag>
struct Split<Frag, 3> {
  Frag hi, lo;
};

// NSPLIT from the kernel's input type: 3 for f32, 1 for bf16.
template <typename T>
struct SplitsFor {
  static constexpr int value = 1;
};
template <>
struct SplitsFor<float> {
  static constexpr int value = 3;
};

// x with its low 13 mantissa bits cleared: a TF32 value, x - hi exact.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// Loads the f32 tile at p (stride ld) and splits it elementwise (NSPLIT
// 1: as loaded; the tensor cores read its TF32 bits).
template <typename Frag, int NSPLIT>
__device__ __forceinline__ void load_split(Split<Frag, NSPLIT>& s,
                                           const float* p, unsigned ld) {
  wmma::load_matrix_sync(s.hi, p, ld);
  if constexpr (NSPLIT == 3) {
#pragma unroll
    for (int t = 0; t < s.hi.num_elements; ++t) {
      const float x = s.hi.x[t];
      const float h = tf32_hi(x);
      s.hi.x[t] = h;
      s.lo.x[t] = x - h;
    }
  }
}

// acc += a·b with the 3xTF32 split (the small terms first).
template <typename FA, typename FB>
__device__ __forceinline__ void mma_x3(FragC& acc, const Split<FA, 3>& a,
                                       const Split<FB, 3>& b) {
  wmma::mma_sync(acc, a.lo, b.hi, acc);
  wmma::mma_sync(acc, a.hi, b.lo, acc);
  wmma::mma_sync(acc, a.hi, b.hi, acc);
}

// acc += a·b in one TF32 product.
template <typename FA, typename FB>
__device__ __forceinline__ void mma_x1(FragC& acc, const Split<FA, 1>& a,
                                       const Split<FB, 1>& b) {
  wmma::mma_sync(acc, a.hi, b.hi, acc);
}

template <typename FA, typename FB>
__device__ __forceinline__ void mma_split(FragC& acc, const Split<FA, 3>& a,
                                          const Split<FB, 3>& b) {
  mma_x3(acc, a, b);
}
template <typename FA, typename FB>
__device__ __forceinline__ void mma_split(FragC& acc, const Split<FA, 1>& a,
                                          const Split<FB, 1>& b) {
  mma_x1(acc, a, b);
}

// acc[i][j] += A_i·B_j^T over depth steps ks0 .. ks1-1, for the two
// 16-row tiles A_0, A_1 at A and B_0, B_1 at B (row-major, stride ld; B
// read as column-major fragments): each fragment loaded and split once
// feeds two products (the wide K1 / K2's share of a score chunk).
template <int NS>
__device__ __forceinline__ void mma_2x2_nt(FragC (&acc)[2][2],
                                           const float* A, const float* B,
                                           unsigned ld, int ks0, int ks1) {
  for (int ks = ks0; ks < ks1; ++ks) {
    Split<FragA<wmma::row_major>, NS> a[2];
    Split<FragB<wmma::col_major>, NS> b[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      load_split(a[i], A + i * TM * ld + ks * TK, ld);
      load_split(b[i], B + i * TN * ld + ks * TK, ld);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) mma_split(acc[i][j], a[i], b[j]);
  }
}

}  // namespace lasr_mma
