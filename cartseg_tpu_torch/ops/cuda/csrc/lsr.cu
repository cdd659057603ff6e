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
// Forward design, two routes, chosen by the wrapper (ops/cuda/lsr.py
// `route`) from C and alignment, as the backward's:
//   vector route (`lsr_fwd_vec`, C in {2, 4, 8, 16}, logits 16-byte
//     aligned, an even n at C = 2): each lane loads one float4, so a warp
//     instruction reads 512 contiguous bytes. The C / 4 lanes of a row
//     combine its max, its sum of exp, its sum of x - max and its x - max
//     at the label with __shfl_xor_sync; then sum_c logp = sum(x - max) -
//     C * lse and no second pass over the row is needed. At C = 2 a lane
//     holds two rows and stores both losses as one float2. IEEE expf and
//     logf;
//   general route (`lsr_fwd`): one thread a row, looping over a run-time C
//     in registers, for any other C or misaligned logits.
// The TPU kernel transposed the logits to [C, N] to put positions on the
// lane axis; both routes read the row-major [N, C] layout as it is.
//
// Backward design, two routes, chosen by the same `route`:
//   vector route (`lsr_bwd_vec`, C in {2, 4, 8, 16} a template parameter,
//     logits 16-byte aligned, an even n at C = 2): each lane loads and
//     stores one float4, so a warp instruction moves 512 contiguous bytes.
//     C / 4 neighbouring lanes share a row (two at C = 8) and combine its
//     max and its sum of exp with __shfl_xor_sync; at C = 2 a lane holds
//     two rows. One IEEE expf an element and one division a lane (the
//     reciprocal of the row's sum); ignored rows store zeros by the same
//     float4 stores;
//   general route (`lsr_bwd`): one thread a row, the loop over a run-time
//     C, for any other C or misaligned logits.
// Every kernel reads the labels as they arrive, int32 or int64 (a
// template parameter), so the wrapper converts nothing.
//
// Bound on this card: memory bandwidth. At [6,512,512,8] the forward
// reads 50 MB of logits and 12.6 MB of int64 labels and writes 6.3 MB of
// loss (69.2 MB, 0.0207 ms at 3.35 TB/s); the
// backward reads the logits, 12.6 MB of int64 labels and 6 MB of g and
// writes 50 MB of gradient (119.5 MB, 0.0357 ms at 3.35 TB/s).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

template <typename L>
__global__ void lsr_fwd(const float* __restrict__ x, const L* __restrict__ lab,
                        float* __restrict__ loss, long long n, int C,
                        float lb_pos, float lb_neg, long long ignore) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long l = (long long)lab[i];
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

// loss of a row from its C classes' lse, sum of (x - max) and, where the
// label names one of them (hit), its x - max
__device__ __forceinline__ float row_loss(float lse, float sum_z, float z_l,
                                          bool hit, int C, float lb_pos,
                                          float lb_neg) {
  const float sum_logp = sum_z - (float)C * lse;
  const float logp_l = hit ? z_l - lse : 0.0f;
  return -(lb_neg * sum_logp + (lb_pos - lb_neg) * logp_l);
}

// the C = 2 row (x0, x1) with label l
__device__ __forceinline__ float loss2(float x0, float x1, long long l,
                                       float lb_pos, float lb_neg,
                                       long long ignore) {
  const float m = fmaxf(x0, x1);
  const float z0 = x0 - m, z1 = x1 - m;
  const float lse = logf(expf(z0) + expf(z1));
  return l == ignore ? 0.0f
                     : row_loss(lse, z0 + z1, l == 0 ? z0 : z1,
                                l == 0 || l == 1, 2, lb_pos, lb_neg);
}

// one float4 of x a lane; nvec = n * C / 4 float4s
template <int C, typename L>
__global__ void __launch_bounds__(kThreads)
lsr_fwd_vec(const float4* __restrict__ x, const L* __restrict__ lab,
            float* __restrict__ loss, long long nvec, float lb_pos,
            float lb_neg, long long ignore) {
  static_assert(C == 2 || C == 4 || C == 8 || C == 16, "vector route C");
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // lanes past the end stay for their row-mates' shuffles (whole rows
  // lie past nvec, so no live lane reads them)
  const bool ok = v < nvec;
  const float4 a = ok ? x[v] : make_float4(0.f, 0.f, 0.f, 0.f);
  if constexpr (C == 2) {
    // rows 2v (a.x, a.y) and 2v + 1 (a.z, a.w)
    if (!ok) return;
    const long long l0 = (long long)lab[2 * v], l1 = (long long)lab[2 * v + 1];
    reinterpret_cast<float2*>(loss)[v] =
        make_float2(loss2(a.x, a.y, l0, lb_pos, lb_neg, ignore),
                    loss2(a.z, a.w, l1, lb_pos, lb_neg, ignore));
  } else {
    constexpr int kLanes = C / 4;          // lanes a row
    const long long row = v / kLanes;
    const int c0 = 4 * (int)(v % kLanes);
    float m = fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w));
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float4 z = make_float4(a.x - m, a.y - m, a.z - m, a.w - m);
    float s = (expf(z.x) + expf(z.y)) + (expf(z.z) + expf(z.w));
    float sum_z = (z.x + z.y) + (z.z + z.w);
    const long long l = ok ? (long long)lab[row] : ignore;
    const long long k = l - c0;            // the label's class in this lane
    float z_l = k == 0 ? z.x : k == 1 ? z.y : k == 2 ? z.z : k == 3 ? z.w
                                                                  : 0.0f;
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      sum_z += __shfl_xor_sync(0xffffffffu, sum_z, o);
      z_l += __shfl_xor_sync(0xffffffffu, z_l, o);
    }
    if (!ok || c0 != 0) return;
    loss[row] = l == ignore ? 0.0f
                            : row_loss(logf(s), sum_z, z_l, l >= 0 && l < C,
                                       C, lb_pos, lb_neg);
  }
}

template <typename L>
int launch_fwd(const float* x, const void* labv, float* loss, long long n,
               int C, float lb_pos, float lb_neg, long long ignore, int vec,
               cudaStream_t s) {
  const L* lab = static_cast<const L*>(labv);
  if (!vec) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    lsr_fwd<L><<<grid, kThreads, 0, s>>>(x, lab, loss, n, C, lb_pos, lb_neg,
                                         ignore);
    return (int)cudaGetLastError();
  }
  const long long nvec = n * C / 4;
  const unsigned grid = (unsigned)((nvec + kThreads - 1) / kThreads);
  const float4* xv = reinterpret_cast<const float4*>(x);
  switch (C) {
    case 2:
      lsr_fwd_vec<2, L><<<grid, kThreads, 0, s>>>(xv, lab, loss, nvec,
                                                  lb_pos, lb_neg, ignore);
      break;
    case 4:
      lsr_fwd_vec<4, L><<<grid, kThreads, 0, s>>>(xv, lab, loss, nvec,
                                                  lb_pos, lb_neg, ignore);
      break;
    case 8:
      lsr_fwd_vec<8, L><<<grid, kThreads, 0, s>>>(xv, lab, loss, nvec,
                                                  lb_pos, lb_neg, ignore);
      break;
    case 16:
      lsr_fwd_vec<16, L><<<grid, kThreads, 0, s>>>(xv, lab, loss, nvec,
                                                   lb_pos, lb_neg, ignore);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename L>
__global__ void lsr_bwd(const float* __restrict__ x, const L* __restrict__ lab,
                        const float* __restrict__ g,
                        float* __restrict__ grad, long long n, int C,
                        float lb_pos, float lb_neg, long long ignore) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long l = (long long)lab[i];
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

// grad of the 4 classes c0 .. c0 + 3 of a row with label l, given their
// e = expf(x - max) and r = 1 / sum of the row's e
__device__ __forceinline__ float4 grad4(float4 e, float r, int c0,
                                        long long l, float gi, float coeff,
                                        float lb_pos, float lb_neg) {
  float4 o;
  o.x = (coeff * (e.x * r) - (c0 == l ? lb_pos : lb_neg)) * gi;
  o.y = (coeff * (e.y * r) - (c0 + 1 == l ? lb_pos : lb_neg)) * gi;
  o.z = (coeff * (e.z * r) - (c0 + 2 == l ? lb_pos : lb_neg)) * gi;
  o.w = (coeff * (e.w * r) - (c0 + 3 == l ? lb_pos : lb_neg)) * gi;
  return o;
}

// one float4 of x a lane; nvec = n * C / 4 float4s
template <int C, typename L>
__global__ void __launch_bounds__(kThreads)
lsr_bwd_vec(const float4* __restrict__ x, const L* __restrict__ lab,
            const float* __restrict__ g, float4* __restrict__ grad,
            long long nvec, float lb_pos, float lb_neg, long long ignore) {
  static_assert(C == 2 || C == 4 || C == 8 || C == 16, "vector route C");
  const long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // lanes past the end stay for their row-mates' shuffles (whole rows
  // lie past nvec, so no live lane reads them)
  const bool ok = v < nvec;
  const float4 a = ok ? x[v] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float coeff = (float)(C - 1) * lb_neg + lb_pos;
  if constexpr (C == 2) {
    // rows 2v (a.x, a.y) and 2v + 1 (a.z, a.w)
    if (!ok) return;
    const long long l0 = (long long)lab[2 * v], l1 = (long long)lab[2 * v + 1];
    const float g0 = g[2 * v], g1 = g[2 * v + 1];
    const float m0 = fmaxf(a.x, a.y), m1 = fmaxf(a.z, a.w);
    float4 e = make_float4(expf(a.x - m0), expf(a.y - m0), expf(a.z - m1),
                           expf(a.w - m1));
    const float r0 = 1.0f / (e.x + e.y), r1 = 1.0f / (e.z + e.w);
    float4 o;
    o.x = (coeff * (e.x * r0) - (l0 == 0 ? lb_pos : lb_neg)) * g0;
    o.y = (coeff * (e.y * r0) - (l0 == 1 ? lb_pos : lb_neg)) * g0;
    o.z = (coeff * (e.z * r1) - (l1 == 0 ? lb_pos : lb_neg)) * g1;
    o.w = (coeff * (e.w * r1) - (l1 == 1 ? lb_pos : lb_neg)) * g1;
    if (l0 == ignore) o.x = o.y = 0.0f;
    if (l1 == ignore) o.z = o.w = 0.0f;
    grad[v] = o;
  } else {
    constexpr int kLanes = C / 4;          // lanes a row
    const long long row = v / kLanes;
    const int c0 = 4 * (int)(v % kLanes);
    float m = fmaxf(fmaxf(a.x, a.y), fmaxf(a.z, a.w));
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float4 e = make_float4(expf(a.x - m), expf(a.y - m),
                                 expf(a.z - m), expf(a.w - m));
    float s = (e.x + e.y) + (e.z + e.w);
#pragma unroll
    for (int o = 1; o < kLanes; o <<= 1)
      s += __shfl_xor_sync(0xffffffffu, s, o);
    if (!ok) return;
    const long long l = (long long)lab[row];
    grad[v] = l == ignore ? make_float4(0.f, 0.f, 0.f, 0.f)
                          : grad4(e, 1.0f / s, c0, l, g[row], coeff, lb_pos,
                                  lb_neg);
  }
}

template <typename L>
int launch_bwd(const float* x, const void* labv, const float* g,
               float* grad, long long n, int C, float lb_pos, float lb_neg,
               long long ignore, int vec, cudaStream_t s) {
  const L* lab = static_cast<const L*>(labv);
  if (!vec) {
    const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    lsr_bwd<L><<<grid, kThreads, 0, s>>>(x, lab, g, grad, n, C, lb_pos,
                                         lb_neg, ignore);
    return (int)cudaGetLastError();
  }
  const long long nvec = n * C / 4;
  const unsigned grid = (unsigned)((nvec + kThreads - 1) / kThreads);
  const float4* xv = reinterpret_cast<const float4*>(x);
  float4* gv = reinterpret_cast<float4*>(grad);
  switch (C) {
    case 2:
      lsr_bwd_vec<2, L><<<grid, kThreads, 0, s>>>(xv, lab, g, gv, nvec,
                                                  lb_pos, lb_neg, ignore);
      break;
    case 4:
      lsr_bwd_vec<4, L><<<grid, kThreads, 0, s>>>(xv, lab, g, gv, nvec,
                                                  lb_pos, lb_neg, ignore);
      break;
    case 8:
      lsr_bwd_vec<8, L><<<grid, kThreads, 0, s>>>(xv, lab, g, gv, nvec,
                                                  lb_pos, lb_neg, ignore);
      break;
    case 16:
      lsr_bwd_vec<16, L><<<grid, kThreads, 0, s>>>(xv, lab, g, gv, nvec,
                                                   lb_pos, lb_neg, ignore);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [n, C] float32; lab: [n] int32 (lab64 = 0) or int64 (lab64 = 1);
// loss: [n] float32 out. vec = 1: the vector route (C in {2, 4, 8, 16}, x
// 16-byte aligned, n even at C = 2).
extern "C" int cartseg_lsr_fwd(const float* x, const void* lab, float* loss,
                               long long n, int C, float lb_pos,
                               float lb_neg, long long ignore, int lab64,
                               int vec, void* stream) {
  if (C <= 0 || (vec && C == 2 && n % 2)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return lab64 ? launch_fwd<long long>(x, lab, loss, n, C, lb_pos, lb_neg,
                                       ignore, vec, s)
               : launch_fwd<int>(x, lab, loss, n, C, lb_pos, lb_neg, ignore,
                                 vec, s);
}

// x: [n, C] float32; lab: [n] int32 (lab64 = 0) or int64 (lab64 = 1); g:
// [n] float32; grad: [n, C] out. vec = 1: the vector route (C in {2, 4, 8,
// 16}, x and grad 16-byte aligned, n even at C = 2).
extern "C" int cartseg_lsr_bwd(const float* x, const void* lab,
                               const float* g, float* grad, long long n,
                               int C, float lb_pos, float lb_neg,
                               long long ignore, int lab64, int vec,
                               void* stream) {
  if (C <= 0 || (vec && C == 2 && n % 2)) return (int)cudaErrorInvalidValue;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  return lab64 ? launch_bwd<long long>(x, lab, g, grad, n, C, lb_pos, lb_neg,
                                       ignore, vec, s)
               : launch_bwd<int>(x, lab, g, grad, n, C, lb_pos, lb_neg,
                                 ignore, vec, s);
}
