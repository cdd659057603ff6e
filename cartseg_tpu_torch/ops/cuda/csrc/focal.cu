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
// Bound on this card: memory bandwidth, once the arithmetic is lean. It
// reads x and y and writes loss and grad, 16 bytes an element: 25.2 MB
// at [6,512,512,1], 7.5 us at 3.35 TB/s. The first form was bound by
// issue instead: two IEEE powf with a runtime exponent, three expf and
// both branches of the log sigmoid's select came to 280 SASS
// instructions on an element's path (cuobjdump -sass,
// tools/focal_dice_timing.py), 13.2 us of issue at [6,512,512,1] on 132
// SMs of 4 schedulers at 1.98 GHz, against 17.0 us measured with the L2
// flushed. This form takes 88 at gamma 2 and 86 at gamma 1 (4.1 us of
// issue) and 11.5 us; the powf route keeps 242 (11.4 us of issue) and
// stays bound by it.
//
// Design:
//   * one exp an element: e = expf(-|x|), r = 1 / (1 + e); p = r where
//     x >= 0 and e r below; log p = -log1pf(e) where x >= 0 and
//     x - log1pf(e) below. log p is bit for bit the two-branch form's; p
//     moves by an ulp or so where x < 0. IEEE expf / log1pf / division
//     (no --use_fast_math): the saving is in doing each once;
//   * the exponent's route, a template picked by the wrapper: G = 2 (the
//     default gamma) takes a^g = a a and a^(g-1) = a, G = 1 takes a and
//     1, G = 0 (any other gamma) powf as the first form did. y == p gives
//     a = 0, so the loss and, for gamma > 1, the gradient are exact
//     zeros on every route;
//   * launch shape from the wrapper's plan (ops/cuda/focal.py `plan`):
//     at most one wave of kMinBlocks CTAs an SM, CTA b taking elements
//     [b L, (b + 1) L) (L a multiple of 4), so every CTA and SM has the
//     same work; a thread issues its kUnroll 16-byte loads of x and of y
//     (4 kUnroll scalar loads on the unaligned route) before its math,
//     and stores loss and grad 16 bytes at a time; the last partial
//     float4 of the array one element at a time.
// The TPU tiled the flat arrays into (256, 128) blocks, padded; here the
// ragged end is masked instead. int64 offsets. nvcc contracts a*b+c into
// FMAs where eager PyTorch rounds twice, so the kernel and the plain
// version agree to a few ulps, not bit for bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 16-byte loads of x (and of y) a thread issues before its math (ops/
// cuda/focal.py UNROLL)
constexpr int kUnroll = 2;
// CTAs an SM holds at once: the plan's one wave (ops/cuda/focal.py
// BLOCKS_PER_SM), so registers are capped at 64 a thread
constexpr int kMinBlocks = 4;

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

// G: 2 -> a^g = a a, a^(g-1) = a; 1 -> a, 1; 0 -> powf(a, g),
// powf(a, g - 1).
template <int G>
__device__ __forceinline__ void focal(float x, float y, float gamma,
                                      float alpha, float& loss,
                                      float& grad) {
  const float e = expf(-fabsf(x));
  const float r = 1.0f / (1.0f + e);
  const float l = log1pf(e);
  const bool pos = x >= 0.0f;
  const float prob = pos ? r : e * r;
  const float log_p = pos ? -l : x - l;
  const float ce =
      y * alpha * log_p + (1.0f - y) * (1.0f - alpha) * (log_p - x);
  const float a = fabsf(y - prob);
  float ag, ag1;
  if (G == 2) {
    ag = a * a;
    ag1 = a;
  } else if (G == 1) {
    ag = a;
    ag1 = 1.0f;
  } else {
    ag = powf(a, gamma);
    ag1 = powf(a, gamma - 1.0f);
  }
  const float coeff = -ag;
  loss = coeff * ce;
  const float d_ce = y * alpha - prob * (1.0f - y - alpha + 2.0f * y * alpha);
  float d_coeff = gamma * ag1 * prob * (1.0f - prob);
  if (y < prob) d_coeff = -d_coeff;
  grad = d_coeff * ce + coeff * d_ce;
}

// Grid (ctas). CTA b takes elements [b L, min((b + 1) L, n)); its thread
// t the V-element loads at b L + t V + k kThreads V, kLoads of them (of
// x and of y) issued before their math. V = 4: every pointer 16-byte
// aligned and L a multiple of 4.
template <int V, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
focal_fwd_bwd(const float* __restrict__ x, const float* __restrict__ y,
              float* __restrict__ loss, float* __restrict__ grad,
              long long n, long long L, float gamma, float alpha) {
  constexpr int kLoads = V == 4 ? kUnroll : 4 * kUnroll;
  constexpr long long kStep = (long long)kThreads * V;
  const long long j0 = (long long)blockIdx.x * L;
  const long long j1 = min(n, j0 + L);
  for (long long j = j0 + (long long)threadIdx.x * V; j < j1;
       j += kLoads * kStep) {
    Vec<V> xv[kLoads], yv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long i = j + u * kStep;
      if (i + V <= j1) {
        xv[u] = *reinterpret_cast<const Vec<V>*>(x + i);
        yv[u] = *reinterpret_cast<const Vec<V>*>(y + i);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const long long i = j + u * kStep;
      if (i + V <= j1) {
        Vec<V> lv, gv;
#pragma unroll
        for (int k = 0; k < V; ++k)
          focal<G>(xv[u].v[k], yv[u].v[k], gamma, alpha, lv.v[k],
                   gv.v[k]);
        *reinterpret_cast<Vec<V>*>(loss + i) = lv;
        *reinterpret_cast<Vec<V>*>(grad + i) = gv;
      } else if (V > 1 && i < j1) {
        // the array's last partial float4
        for (long long k = i; k < j1; ++k)
          focal<G>(x[k], y[k], gamma, alpha, loss[k], grad[k]);
      }
    }
  }
}

template <int V>
void launch(const float* x, const float* y, float* loss, float* grad,
            long long n, long long L, int ctas, float gamma, float alpha,
            int route, cudaStream_t s) {
  if (route == 2)
    focal_fwd_bwd<V, 2><<<ctas, kThreads, 0, s>>>(x, y, loss, grad, n, L,
                                                  gamma, alpha);
  else if (route == 1)
    focal_fwd_bwd<V, 1><<<ctas, kThreads, 0, s>>>(x, y, loss, grad, n, L,
                                                  gamma, alpha);
  else
    focal_fwd_bwd<V, 0><<<ctas, kThreads, 0, s>>>(x, y, loss, grad, n, L,
                                                  gamma, alpha);
}

}  // namespace

// x, y: [n] float32 logits and targets; loss, grad: [n] float32 out.
// vec = 4: every pointer is 16-byte aligned (else 1); route: 2 for gamma
// = 2, 1 for gamma = 1, 0 for any other; ctas CTAs of L elements each (L
// a multiple of 4, ctas L >= n). The wrapper (ops/cuda/focal.py `plan`,
// `route`) picks them.
extern "C" int cartseg_focal(const float* x, const float* y, float* loss,
                             float* grad, long long n, long long L, int ctas,
                             float gamma, float alpha, int vec, int route,
                             void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (ctas <= 0 || L <= 0 || L % 4 != 0 || (long long)ctas * L < n ||
      (vec != 1 && vec != 4) || route < 0 || route > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec == 4)
    launch<4>(x, y, loss, grad, n, L, ctas, gamma, alpha, route, s);
  else
    launch<1>(x, y, loss, grad, n, L, ctas, gamma, alpha, route, s);
  return (int)cudaGetLastError();
}
