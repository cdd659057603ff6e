// Smoothed one-hot rows on Hopper.
//
// Replaces the TPU kernel `_kernel` (cartseg_tpu/ops/pallas/one_hot.py:21),
// the analog of the reference's one_hot_kernel.cu `label_one_hot`. For
// labels [n] (int32 or int64) it writes out [n, C] float32:
//   out[i, c] = 0    where labels[i] == ignore,
//               hi   where c == labels[i],
//               lo   elsewhere,
// with hi = 1 - lb_smooth and lo = lb_smooth / C, rounded to float32 by
// the wrapper. A label outside [0, C) gives a row of lo, as on the TPU.
//
// Bound on this card: memory bandwidth. It reads the labels once and
// writes 4C bytes a row: at [6,262144] with C = 8 and int64 labels
// 62.9 MB, 18.8 us at 3.35 TB/s.
//
// Design: the TPU wrote channels-first [C, n] tiles and transposed them
// afterwards (a Mosaic layout need, one_hot.py:1-5). Here one thread
// owns a row and writes its C channels in place, channels-last, 16 bytes
// a store when C is a multiple of 4 and the output is aligned; a warp's
// stores cover one contiguous span. Only selects, no arithmetic: the
// output is bit-equal to the plain version. int64 offsets.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename T, bool VEC>
__global__ void smooth_one_hot(const T* __restrict__ lab,
                               float* __restrict__ out, long long n, int C,
                               float hi, float lo, long long ignore) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long l = (long long)lab[i];
  const bool ign = l == ignore;
  float* row = out + i * C;
  if (VEC) {
    for (int c = 0; c < C; c += 4) {
      float4 v;
      v.x = ign ? 0.0f : (l == c ? hi : lo);
      v.y = ign ? 0.0f : (l == c + 1 ? hi : lo);
      v.z = ign ? 0.0f : (l == c + 2 ? hi : lo);
      v.w = ign ? 0.0f : (l == c + 3 ? hi : lo);
      *reinterpret_cast<float4*>(row + c) = v;
    }
  } else {
    for (int c = 0; c < C; ++c) row[c] = ign ? 0.0f : (l == c ? hi : lo);
  }
}

template <typename T>
void launch(const void* lab, float* out, long long n, int C, float hi,
            float lo, long long ignore, int vec, cudaStream_t s) {
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const T* p = static_cast<const T*>(lab);
  if (vec)
    smooth_one_hot<T, true><<<grid, kThreads, 0, s>>>(p, out, n, C, hi, lo,
                                                      ignore);
  else
    smooth_one_hot<T, false><<<grid, kThreads, 0, s>>>(p, out, n, C, hi, lo,
                                                       ignore);
}

}  // namespace

// lab: [n] int32 (lab64 = 0) or int64 (lab64 = 1); out: [n, C] float32.
// vec = 1: C is a multiple of 4 and out is 16-byte aligned.
extern "C" int cartseg_one_hot(const void* lab, float* out, long long n,
                               int C, float hi, float lo, long long ignore,
                               int lab64, int vec, void* stream) {
  if (C <= 0 || (vec && C % 4 != 0)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (lab64)
      launch<long long>(lab, out, n, C, hi, lo, ignore, vec, s);
    else
      launch<int>(lab, out, n, C, hi, lo, ignore, vec, s);
  }
  return (int)cudaGetLastError();
}
