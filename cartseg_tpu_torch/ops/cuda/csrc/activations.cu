// Mish, swish and hard-swish, forward and backward, on Hopper.
//
// Replaces the TPU kernels `_mish_fwd_kernel` / `_mish_bwd_kernel`,
// `_swish_fwd_kernel` / `_swish_bwd_kernel` and `_hswish_fwd_kernel` /
// `_hswish_bwd_kernel` (cartseg_tpu/ops/pallas/activations.py:77-110),
// the analogs of the reference's mish_kernel.cu and swish_kernel.cu.
//   mish    f = x tanh(sp(x)),  sp(x) = x if x > 20 else log1p(exp(min(x, 20)))
//           f' = tanh(sp) + x (1 - tanh(sp)^2) sigmoid(x)
//   swish   f = x / (1 + exp(-x)),  f' = s + x s (1 - s),  s = sigmoid(x)
//   hswish  f = x clip(x + 3, 0, 6) / 6,
//           f' = 0 if x <= -3, 1 if x >= 3, else (2x + 3) / 6
// The TPU's backward kernels wrote f'(x) and the custom VJP multiplied
// by g in another pass (activations.py:122-124); here the backward
// kernel takes g and writes g f'(x), which saves that pass.
//
// Bound on this card: memory bandwidth. The forward reads x and writes
// f, 8 bytes an element; the backward reads x and g and writes g f', 12
// bytes: at 25.2M elements (a [6,512,512,16] activation) 201 MB and
// 302 MB, 60 us and 90 us at 3.35 TB/s.
//
// Design: one thread per 4 consecutive elements, 16-byte loads and
// stores when the wrapper says the arrays are 16-byte aligned, else one
// element at a time; int64 offsets. Each (activation, direction) is its
// own __global__ instance of one template. IEEE expf / log1pf / tanhf
// and division (no --use_fast_math), but for mish's forward: there
// x tanh(log1p(exp(x))) compiles to about twice the SASS instructions of
// the one expf and __fdividef of the form below (376 against 184 for the
// kernel), enough to keep it ~2 % behind F.mish at [6,512,512,16]; the
// short form runs ahead of F.mish (cartseg_tpu_torch/tools/act_timing.py:
// alternating cold-L2 pairs, SASS beside ATen's).
// hswish is written in the plain version's operation order, and its
// results are bit-equal to it: its division by 6 is a multiplication by
// float32(1/6), which is how XLA compiles the Pallas kernel's `/ 6.0` and
// how PyTorch's CUDA division by a Python number runs. mish and swish
// differ from the plain version by a few ulps (mish's forward by its other
// form, the rest where nvcc contracts a*b+c into an FMA).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kSixth = 1.0f / 6.0f;

__device__ __forceinline__ float softplus20(float x) {
  return x > 20.0f ? x : log1pf(expf(fminf(x, 20.0f)));
}

struct Mish {
  // tanh(log1p(e)) = n / (n + 2) with e = exp(x), n = e (e + 2): one expf
  // and a fast division in place of expf, log1pf and tanhf. n + 2 lies in
  // [2, 2^58) wherever the guard does not return x, inside __fdividef's
  // range (2 ulps); above 20, fp32's tanh(softplus(x)) is 1 and f = x.
  static __device__ __forceinline__ float f(float x) {
    const float e = expf(x), n = e * (e + 2.0f);
    return x > 20.0f ? x : x * __fdividef(n, n + 2.0f);
  }
  static __device__ __forceinline__ float d(float x) {
    const float t = tanhf(softplus20(x));
    const float sig = 1.0f / (1.0f + expf(-x));
    return t + x * (1.0f - t * t) * sig;
  }
};

struct Swish {
  static __device__ __forceinline__ float f(float x) {
    return x / (1.0f + expf(-x));
  }
  static __device__ __forceinline__ float d(float x) {
    const float s = 1.0f / (1.0f + expf(-x));
    return s + x * s * (1.0f - s);
  }
};

struct HSwish {
  static __device__ __forceinline__ float f(float x) {
    float c = x + 3.0f;           // clip that keeps a NaN, as jnp.clip
    c = c < 0.0f ? 0.0f : c;
    c = c > 6.0f ? 6.0f : c;
    return x * c * kSixth;
  }
  static __device__ __forceinline__ float d(float x) {
    return x <= -3.0f ? 0.0f : (x >= 3.0f ? 1.0f : (2.0f * x + 3.0f) * kSixth);
  }
};

template <class Op, bool VEC>
__global__ void act_fwd(const float* __restrict__ x, float* __restrict__ out,
                        long long n) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (VEC && i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(Op::f(v.x), Op::f(v.y), Op::f(v.z), Op::f(v.w));
  } else {
    for (long long j = i; j < i + 4 && j < n; ++j) out[j] = Op::f(x[j]);
  }
}

template <class Op, bool VEC>
__global__ void act_bwd(const float* __restrict__ x,
                        const float* __restrict__ g, float* __restrict__ out,
                        long long n) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i >= n) return;
  if (VEC && i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(x + i);
    const float4 w = *reinterpret_cast<const float4*>(g + i);
    *reinterpret_cast<float4*>(out + i) =
        make_float4(w.x * Op::d(v.x), w.y * Op::d(v.y), w.z * Op::d(v.z),
                    w.w * Op::d(v.w));
  } else {
    for (long long j = i; j < i + 4 && j < n; ++j) out[j] = g[j] * Op::d(x[j]);
  }
}

unsigned grid_for(long long n) {
  return (unsigned)((n + 4LL * kThreads - 1) / (4LL * kThreads));
}

template <class Op>
void launch(const float* x, const float* g, float* out, long long n,
            int vec, cudaStream_t s) {
  const unsigned grid = grid_for(n);
  if (g == nullptr) {
    if (vec)
      act_fwd<Op, true><<<grid, kThreads, 0, s>>>(x, out, n);
    else
      act_fwd<Op, false><<<grid, kThreads, 0, s>>>(x, out, n);
  } else {
    if (vec)
      act_bwd<Op, true><<<grid, kThreads, 0, s>>>(x, g, out, n);
    else
      act_bwd<Op, false><<<grid, kThreads, 0, s>>>(x, g, out, n);
  }
}

}  // namespace

// kind: 0 mish, 1 swish, 2 hswish. x: [n] float32; g: [n] float32, or
// null for the forward; out: [n] float32, f(x) or g * f'(x). vec = 1:
// every pointer is 16-byte aligned.
extern "C" int cartseg_activation(int kind, const float* x, const float* g,
                                  float* out, long long n, int vec,
                                  void* stream) {
  if (kind < 0 || kind > 2) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (kind == 0)
      launch<Mish>(x, g, out, n, vec, s);
    else if (kind == 1)
      launch<Swish>(x, g, out, n, vec, s);
    else
      launch<HSwish>(x, g, out, n, vec, s);
  }
  return (int)cudaGetLastError();
}
