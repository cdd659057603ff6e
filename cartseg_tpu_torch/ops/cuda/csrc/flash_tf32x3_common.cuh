// Shared pieces of the float32 flash-attention kernels on Hopper's tensor
// cores as split-TF32 products (flash_relpos.cu, the forward;
// flash_relpos_bwd.cu, the backward): the swizzled fp32 [64][HD] tiles and
// the cp.async copies that fill them, the hi/lo split of an fp32 operand,
// the m16n8k8 tf32 mma and its three-product form, and the fragment
// gathers of the first products (over head_dim) and the second products
// (over a tile's 64 keys or queries).
//
// Split TF32. One TF32 product keeps 10 of fp32's 23 mantissa bits. So each
// fp32 operand x is cut into hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest with ties away from zero (the bits plus 0x1000, the
// low 13 bits cleared: cvt.rna.tf32.f32 for finite x), and a product is
// hi_a lo_b + lo_a hi_b + hi_a hi_b on mma.sync m16n8k8 tf32 into one fp32
// accumulator, the small terms first (CUTLASS's OpMultiplyAddFastF32). hi +
// lo holds x to ~2^-22 of it and the dropped lo_a lo_b is ~2^-22 of the
// product, near fp32's own 2^-24. The tensor cores add into their fp32
// accumulator with truncation, whose bias grows with the length of the
// chain, so a long sum is kept as tile products summed from zero and added
// on the FP32 pipes (`tile_product`).

#pragma once

#include <stdint.h>

#include "flash_tc_common.cuh"

namespace flash_tf32x3 {

using flash_tc::cp16;
using flash_tc::cp_commit;
using flash_tc::cp_wait_all;
using flash_tc::kLog2e;
using flash_tc::smem_u32;

constexpr int kR = 64;         // rows of a tile
constexpr int kThreads = 128;  // 4 warps, 16 rows of the tile each
constexpr unsigned kFull = 0xffffffffu;

// ------------------------------------------------------------------ tiles

// A [64][HD] fp32 tile: rows HD + 8 floats apart (8 banks mod 32), and in
// rows with bit 2 set column d stored at d ^ 8. A warp's reads are then
// free of bank conflicts both ways the kernels read a tile: columns
// (d, d + 1) of rows 8j + g as one 8-byte load (the first products), and
// column d of rows 8c + 2t and 8c + 2t + 1 (the second products' B).
template <int HD>
struct Tile {
  static constexpr int kStride = HD + 8;
  static constexpr int kFloats = kR * kStride;
};
template <int HD>
__device__ __forceinline__ int at(int r, int d) {
  return r * Tile<HD>::kStride + (d ^ ((r & 4) << 1));
}

// rows [r0, r0 + 64) of a [S, HD] fp32 slice into a tile, zeros past S
template <int HD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int S) {
  constexpr int C = HD / 4;  // 16-byte chunks a row
  const uint32_t d0 = smem_u32(dst);
#pragma unroll
  for (int j = 0; j < kR * C / kThreads; ++j) {
    const int e = threadIdx.x + j * kThreads, r = e / C, d = (e % C) * 4;
    const bool ok = r0 + r < S;
    cp16(d0 + 4 * at<HD>(r, d), ok ? src + (size_t)(r0 + r) * HD + d : src,
         ok ? 16 : 0);
  }
}

// ------------------------------------------------------- split TF32 mma

// x rounded to TF32, to nearest, ties away from zero; the low 13 bits 0
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

struct FragA {  // an m16n8k8 A operand: a0 (g, t), a1 (g+8, t), a2 (g,
  uint32_t hi[4], lo[4];  // t+4), a3 (g+8, t+4), each x = hi + lo
};
struct FragB {  // a B operand: b0 (k t, n g), b1 (k t+4, n g)
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  split(a0, f.hi[0], f.lo[0]);
  split(a1, f.hi[1], f.lo[1]);
  split(a2, f.hi[2], f.lo[2]);
  split(a3, f.hi[3], f.lo[3]);
  return f;
}
__device__ __forceinline__ FragB split_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// D (16 x 8, fp32) += A (16 x 8, tf32) . B (8 x 8, tf32)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// d += a b in split TF32: hi lo and lo hi, then hi hi
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.hi);
}

// The accumulator of an m16n8 tile: thread (g = lane / 4, t = lane % 4)
// holds x[0] (row g, column 2t), x[1] (g, 2t + 1), x[2] (g + 8, 2t) and
// x[3] (g + 8, 2t + 1). Read as an A operand whose k index t is column 2t
// and t + 4 is 2t + 1, it needs no shuffle:
__device__ __forceinline__ FragA a_acc(const float (&x)[4]) {
  return split_a(x[0], x[2], x[1], x[3]);
}
// A of a first product: rows ra and ra + 8 of a tile, columns (d, d + 1)
// as k indices t and t + 4
template <int HD>
__device__ __forceinline__ FragA a_rows(const float* x, int ra, int d) {
  const float2 u = *reinterpret_cast<const float2*>(x + at<HD>(ra, d));
  const float2 w = *reinterpret_cast<const float2*>(x + at<HD>(ra + 8, d));
  return split_a(u.x, w.x, u.y, w.y);
}
// B of a first product: columns (d, d + 1) of a tile's row r
template <int HD>
__device__ __forceinline__ FragB b_row(const float* y, int r, int d) {
  const float2 u = *reinterpret_cast<const float2*>(y + at<HD>(r, d));
  return split_b(u.x, u.y);
}
// B of a second product: column d of a tile's rows r and r + 1
template <int HD>
__device__ __forceinline__ FragB b_col(const float* y, int r, int d) {
  return split_b(y[at<HD>(r, d)], y[at<HD>(r + 1, d)]);
}

// A second product's tile, summed from zero: t (the warp's 16 rows x HD) =
// x (its 16 x 64 accumulator tile, k = the 64 columns) . y (a [64][HD]
// tile). The caller adds t to its running sum on the FP32 pipes, rounded to
// nearest, so the tensor cores' truncating adds stay 64 terms long.
template <int HD>
__device__ __forceinline__ void tile_product(float (&t)[HD / 8][4],
                                             const float (&x)[8][4],
                                             const float* y, int gq,
                                             int tq) {
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) t[n][i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < 8; ++kc) {
    const FragA fa = a_acc(x[kc]);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      mma3(t[n], fa, b_col<HD>(y, 8 * kc + 2 * tq, 8 * n + gq));
  }
}

}  // namespace flash_tf32x3
