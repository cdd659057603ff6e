// Label-smoothed softmax cross-entropy, forward and backward, on Hopper.
//
// Replaces the TPU kernels `_fwd_kernel` and `_bwd_kernel`
// (cartseg_tpu/ops/pallas/lsr.py:38 and :61), themselves the analog of
// the reference's lsr_kernel.cu. Per position i over C classes, with
// lb_pos = 1 - s and lb_neg = s / C:
//   forward   loss_i = -(lb_neg * sum_c logp_ic + (lb_pos - lb_neg) *
//                        logp_i[label_i]),  0 where label_i == ignore;
//   backward  grad_ic = g_i * (coeff * softmax_ic - oh_ic), with
//             coeff = (C - 1) * lb_neg + lb_pos and oh = lb_pos at the
//             label, lb_neg elsewhere; 0 on ignored rows.
// The backward recomputes the softmax from the logits: nothing is saved
// between the passes but the logits and labels themselves.
//
// Design: one thread per position, looping over the C classes (C = 8 on
// the ABL path) in registers; max, sum of exp and the two log-prob sums
// in fp32 with IEEE expf/logf. The TPU kernel transposed the logits to
// [C, N] to put positions on the lane axis; here a warp reads 32
// consecutive rows of C floats, one contiguous span, so the row-major
// [N, C] layout is read as it is and no transpose pass is needed.
//
// Bound on this card: memory bandwidth. At [6,512,512,8] the forward
// reads 50 MB of logits and 6 MB of labels and writes 6 MB; the
// backward reads the same plus g and writes 50 MB of gradient.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void lsr_fwd(const float* __restrict__ x,
                        const int* __restrict__ lab,
                        float* __restrict__ loss, long long n, int C,
                        float lb_pos, float lb_neg, int ignore) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int l = lab[i];
  if (l == ignore) {
    loss[i] = 0.0f;
    return;
  }
  const float* r = x + i * C;
  float m = r[0];
  for (int c = 1; c < C; ++c) m = fmaxf(m, r[c]);
  float s = 0.0f;
  for (int c = 0; c < C; ++c) s += expf(r[c] - m);
  float lse = logf(s);
  float sum_logp = 0.0f, logp_l = 0.0f;
  for (int c = 0; c < C; ++c) {
    float lp = (r[c] - m) - lse;
    sum_logp += lp;
    if (c == l) logp_l = lp;
  }
  loss[i] = -(lb_neg * sum_logp + (lb_pos - lb_neg) * logp_l);
}

__global__ void lsr_bwd(const float* __restrict__ x,
                        const int* __restrict__ lab,
                        const float* __restrict__ g,
                        float* __restrict__ grad, long long n, int C,
                        float lb_pos, float lb_neg, int ignore) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int l = lab[i];
  const float* r = x + i * C;
  float* o = grad + i * C;
  if (l == ignore) {
    for (int c = 0; c < C; ++c) o[c] = 0.0f;
    return;
  }
  float coeff = (float)(C - 1) * lb_neg + lb_pos;
  float m = r[0];
  for (int c = 1; c < C; ++c) m = fmaxf(m, r[c]);
  float s = 0.0f;
  for (int c = 0; c < C; ++c) s += expf(r[c] - m);
  float gi = g[i];
  for (int c = 0; c < C; ++c) {
    float p = expf(r[c] - m) / s;
    o[c] = (coeff * p - (c == l ? lb_pos : lb_neg)) * gi;
  }
}

}  // namespace

// x: [n, C] float32; lab: [n] int32; loss: [n] float32 out.
extern "C" int cartseg_lsr_fwd(const float* x, const int* lab, float* loss,
                               long long n, int C, float lb_pos,
                               float lb_neg, int ignore, void* stream) {
  if (n > 0) {
    unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    lsr_fwd<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, lab, loss, n, C, lb_pos, lb_neg, ignore);
  }
  return (int)cudaGetLastError();
}

// x: [n, C] float32; lab: [n] int32; g: [n] float32; grad: [n, C] out.
extern "C" int cartseg_lsr_bwd(const float* x, const int* lab,
                               const float* g, float* grad, long long n,
                               int C, float lb_pos, float lb_neg, int ignore,
                               void* stream) {
  if (n > 0) {
    unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    lsr_bwd<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        x, lab, g, grad, n, C, lb_pos, lb_neg, ignore);
  }
  return (int)cudaGetLastError();
}
