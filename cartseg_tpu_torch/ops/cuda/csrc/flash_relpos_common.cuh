// Pieces of the float32 decomposed rel-pos flash-attention forward on the
// CUDA cores (flash_relpos.cu): tile sizes, the tile loads, and the padded
// row strides of the shared-memory tiles.

#pragma once

#include <cuda_runtime.h>

namespace flash_relpos {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;

// 4 consecutive elements, 16-byte aligned
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// row stride of the [64, g] bias slices: == 4 (mod 8) floats, so the two
// query-row groups of a warp (4 rows apart) land 16 banks apart
__host__ __device__ __forceinline__ int rel_stride(int g) {
  return g + (12 - g % 8) % 8;
}

// row stride of the [64, HD] q / k / v / dO tiles: the 16 threads of a
// half-warp read rows tx + 16 j as float4, 4 banks apart
template <int HD>
__host__ __device__ constexpr int row_stride() { return HD + 4; }

// rows [r0, r0 + 64) of a [S, HD] slice into a [64, HD + 4] fp32 tile,
// zeros past S
template <int HD>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int r0, int S) {
  for (int e = threadIdx.x; e < 64 * HD / 4; e += kThreads) {
    const int r = e / (HD / 4), d = (e % (HD / 4)) * 4;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) t = load4(src + (size_t)(r0 + r) * HD + d);
    *reinterpret_cast<float4*>(dst + r * row_stride<HD>() + d) = t;
  }
}

// rows [r0, r0 + 64) of the two [S, g] bias factors into [64, rst] fp32
// tiles, zeros past S
__device__ __forceinline__ void load_rel(float* rh_dst, float* rw_dst,
                                         const float* rel_h,
                                         const float* rel_w, int r0, int S,
                                         int g, int rst) {
  for (int e = threadIdx.x; e < 64 * g; e += kThreads) {
    const int r = e / g, c = e - r * g;
    const bool ok = r0 + r < S;
    const size_t off = (size_t)r0 * g + e;
    rh_dst[r * rst + c] = ok ? rel_h[off] : 0.f;
    rw_dst[r * rst + c] = ok ? rel_w[off] : 0.f;
  }
}

}  // namespace flash_relpos
