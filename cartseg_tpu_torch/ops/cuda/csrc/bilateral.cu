// cv2.bilateralFilter of an 8-bit three-channel image on Hopper.
//
// Replaces no TPU kernel: the JAX package runs cv2.bilateralFilter on
// the host (cartseg_tpu/tools/annotate.py:49, the first stage of the
// annotation tool's `seg_friendly`), and the card's install has no
// OpenCV. Its plain version is ops/filters.py `bilateral_u8_plain`,
// some twenty elementwise launches a tap, 149 taps at d = 15.
//
// For each pixel and each tap k (offset (dy, dx), rows outer, the order
// of cv2's space table):
//   w      = space[k] * colour[|b - b0| + |g - g0| + |r - r0|]
//   wsum  += w
//   sum_c  = fma(c, w, sum_c)            (c = the tap's channel value)
// out_c = rint(sum_c / wsum), with the image padded by BORDER_REFLECT_101.
// Each operation is an explicitly rounded float32 intrinsic (__fmul_rn,
// __fadd_rn, __fmaf_rn, __fdiv_rn: nvcc neither contracts nor splits
// them), in the plain version's order, so the two are bit-equal.
//
// Bound on this card: operations. A pixel does 149 taps x (3 channels x
// (multiply + add) + the weight's multiply + add) = 1,192 float32
// operations (a fused multiply-add counted as two) and reads and writes
// 6 bytes: at 1280x720 1.10 GFLOP,
// 16.4 us at 67 TFLOP/s, against 5.5 MB, 1.65 us at 3.35 TB/s.
//
// Design, a first version that is right: a block of 32 x 8 threads, one
// output pixel a thread, stages its tile with a `radius`-pixel halo
// (reflected at the image edge) in shared memory as bytes, with the
// 768-entry colour table and the taps' weights and offsets beside it; a
// thread then walks the taps in order, reading its neighbourhood and the
// table from shared memory. One launch a call.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kColours = 256 * 3;

__device__ __forceinline__ int reflect101(int p, int n) {
  if (n == 1) return 0;
  while ((unsigned)p >= (unsigned)n) p = p < 0 ? -p : 2 * (n - 1) - p;
  return p;
}

__global__ void bilateral_u8c3(const uint8_t* __restrict__ src,
                               uint8_t* __restrict__ dst, int H, int W,
                               const float* __restrict__ colour,
                               const int* __restrict__ offsets,
                               const float* __restrict__ space, int ntaps,
                               int radius) {
  extern __shared__ float smem[];
  float* s_colour = smem;                                  // kColours
  float* s_space = s_colour + kColours;                    // ntaps
  int* s_off = reinterpret_cast<int*>(s_space + ntaps);    // ntaps (dy, dx)
  uint8_t* s_tile = reinterpret_cast<uint8_t*>(s_off + 2 * ntaps);
  const int tw = kBX + 2 * radius, th = kBY + 2 * radius;

  const int tid = threadIdx.y * kBX + threadIdx.x;
  const int nthreads = kBX * kBY;
  for (int i = tid; i < kColours; i += nthreads) s_colour[i] = colour[i];
  for (int i = tid; i < ntaps; i += nthreads) {
    s_space[i] = space[i];
    s_off[2 * i] = offsets[2 * i];
    s_off[2 * i + 1] = offsets[2 * i + 1];
  }
  const int x0 = blockIdx.x * kBX - radius, y0 = blockIdx.y * kBY - radius;
  for (int i = tid; i < tw * th; i += nthreads) {
    const int ty = i / tw, tx = i - ty * tw;
    const int sy = reflect101(y0 + ty, H), sx = reflect101(x0 + tx, W);
    const uint8_t* p = src + ((size_t)sy * W + sx) * 3;
    s_tile[3 * i] = p[0];
    s_tile[3 * i + 1] = p[1];
    s_tile[3 * i + 2] = p[2];
  }
  __syncthreads();

  const int x = blockIdx.x * kBX + threadIdx.x;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x >= W || y >= H) return;
  const int cy = threadIdx.y + radius, cx = threadIdx.x + radius;
  const uint8_t* c = s_tile + 3 * (cy * tw + cx);
  const int b0 = c[0], g0 = c[1], r0 = c[2];
  float wsum = 0.f, sb = 0.f, sg = 0.f, sr = 0.f;
  for (int k = 0; k < ntaps; ++k) {
    const uint8_t* t = s_tile + 3 * ((cy + s_off[2 * k]) * tw + cx +
                                     s_off[2 * k + 1]);
    const int b = t[0], g = t[1], r = t[2];
    const float w = __fmul_rn(
        s_colour[abs(b - b0) + abs(g - g0) + abs(r - r0)], s_space[k]);
    wsum = __fadd_rn(wsum, w);
    sb = __fmaf_rn((float)b, w, sb);
    sg = __fmaf_rn((float)g, w, sg);
    sr = __fmaf_rn((float)r, w, sr);
  }
  uint8_t* o = dst + ((size_t)y * W + x) * 3;
  o[0] = (uint8_t)min(max(__float2int_rn(__fdiv_rn(sb, wsum)), 0), 255);
  o[1] = (uint8_t)min(max(__float2int_rn(__fdiv_rn(sg, wsum)), 0), 255);
  o[2] = (uint8_t)min(max(__float2int_rn(__fdiv_rn(sr, wsum)), 0), 255);
}

}  // namespace

// src, dst: [H, W, 3] uint8; colour: [768] float32; offsets: [ntaps, 2]
// int32 (dy, dx) within `radius`; space: [ntaps] float32.
extern "C" int cartseg_bilateral_u8(const uint8_t* src, uint8_t* dst, int H,
                                    int W, const float* colour,
                                    const int* offsets, const float* space,
                                    int ntaps, int radius, void* stream) {
  if (H <= 0 || W <= 0 || ntaps <= 0 || radius < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (kColours + ntaps) +
                      sizeof(int) * 2 * ntaps +
                      (size_t)3 * (kBX + 2 * radius) * (kBY + 2 * radius);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        bilateral_u8c3, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  bilateral_u8c3<<<grid, dim3(kBX, kBY), smem, (cudaStream_t)stream>>>(
      src, dst, H, W, colour, offsets, space, ntaps, radius);
  return (int)cudaGetLastError();
}
