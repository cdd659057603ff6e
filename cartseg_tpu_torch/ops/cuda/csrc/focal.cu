// Sigmoid focal loss and its gradient in one elementwise pass, on Hopper.
//
// Replaces the TPU kernel `_fused_kernel` (cartseg_tpu/ops/pallas/
// focal.py:40), the analog of the reference's focal_kernel.cu
// forward-backward op. Per element, with p = 1 / (1 + exp(-x)) and
// log p in its two-branch stable form (focal.py:25-37):
//   ce      = y a log p + (1 - y)(1 - a)(log p - x)
//   coeff   = -|y - p|^g,            loss = coeff ce
//   d_ce    = y a - p (1 - y - a + 2 y a)
//   d_coeff = g |y - p|^(g-1) p (1 - p), negated where y < p
//   grad    = d_coeff ce + coeff d_ce
// The backward of the loss is then one multiply by the upstream
// gradient (losses/region.py), as focal.py:86-97 does.
//
// Bound on this card: memory bandwidth. It reads x and y and writes loss
// and grad, 16 bytes an element: 25.2 MB at [6,512,512,1], 7.5 us at
// 3.35 TB/s; its ~50 operations an element take a tenth of that at the
// fp32 rate.
//
// Design: one thread per 4 consecutive elements, with 16-byte loads and
// stores when the wrapper says all four arrays are 16-byte aligned, else
// one element at a time; int64 offsets. The TPU tiled the flat arrays
// into (256, 128) blocks, padded; here the tail is masked instead. IEEE
// expf / log1pf / powf (no --use_fast_math). nvcc contracts a*b+c into
// FMAs where eager PyTorch rounds twice, so the kernel and the plain
// version agree to a few ulps, not bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void focal(float x, float y, float gamma,
                                      float alpha, float& loss,
                                      float& grad) {
  const float prob = 1.0f / (1.0f + expf(-x));
  const float log_p = x >= 0.0f ? -log1pf(expf(-x)) : x - log1pf(expf(x));
  const float ce =
      y * alpha * log_p + (1.0f - y) * (1.0f - alpha) * (log_p - x);
  const float a = fabsf(y - prob);
  const float coeff = -powf(a, gamma);
  loss = coeff * ce;
  const float d_ce = y * alpha - prob * (1.0f - y - alpha + 2.0f * y * alpha);
  float d_coeff = gamma * powf(a, gamma - 1.0f) * prob * (1.0f - prob);
  if (y < prob) d_coeff = -d_coeff;
  grad = d_coeff * ce + coeff * d_ce;
}

template <bool VEC>
__global__ void focal_fwd_bwd(const float* __restrict__ x,
                              const float* __restrict__ y,
                              float* __restrict__ loss,
                              float* __restrict__ grad, long long n,
                              float gamma, float alpha) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (VEC && i + 4 <= n) {
    const float4 xv = *reinterpret_cast<const float4*>(x + i);
    const float4 yv = *reinterpret_cast<const float4*>(y + i);
    float4 lv, gv;
    focal(xv.x, yv.x, gamma, alpha, lv.x, gv.x);
    focal(xv.y, yv.y, gamma, alpha, lv.y, gv.y);
    focal(xv.z, yv.z, gamma, alpha, lv.z, gv.z);
    focal(xv.w, yv.w, gamma, alpha, lv.w, gv.w);
    *reinterpret_cast<float4*>(loss + i) = lv;
    *reinterpret_cast<float4*>(grad + i) = gv;
  } else {
    for (long long j = i; j < i + 4 && j < n; ++j)
      focal(x[j], y[j], gamma, alpha, loss[j], grad[j]);
  }
}

}  // namespace

// x, y: [n] float32 logits and targets; loss, grad: [n] float32 out.
// vec = 1: every pointer is 16-byte aligned.
extern "C" int cartseg_focal(const float* x, const float* y, float* loss,
                             float* grad, long long n, float gamma,
                             float alpha, int vec, void* stream) {
  if (n > 0) {
    const unsigned grid = (unsigned)((n + 4LL * kThreads - 1) /
                                     (4LL * kThreads));
    cudaStream_t s = (cudaStream_t)stream;
    if (vec)
      focal_fwd_bwd<true><<<grid, kThreads, 0, s>>>(x, y, loss, grad, n,
                                                    gamma, alpha);
    else
      focal_fwd_bwd<false><<<grid, kThreads, 0, s>>>(x, y, loss, grad, n,
                                                     gamma, alpha);
  }
  return (int)cudaGetLastError();
}
