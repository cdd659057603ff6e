// Per-channel (sum a, sum a*b) over every axis but the channel axis, on
// Hopper: BatchNorm's statistic and gradient reductions.
//
// Replaces the TPU kernel `_sums_kernel` (cartseg_tpu/ops/pallas/
// channel_sums.py:39). For a, b [N, C, H, W] of one memory order, fp32
// or bf16 each:
//   out[0, c] = sum_{n,h,w} a[n,c,h,w]
//   out[1, c] = sum_{n,h,w} a[n,c,h,w] * b[n,c,h,w]
// in fp32. BatchNorm's forward calls it with b = a (`same`: b is not
// read), its backward with (dy, x).
//
// Bound on this card: memory bandwidth. One or two full reads of the
// inputs and a few FMAs an element; at resnet34-UNet's 512^2 bs6 a BN
// layer sees 4.7e6 (layer4) to 2.5e7 (stem, decoder top) elements.
//
// Design. The TPU re-viewed the batch as [B*H, W*C] to fill 128 lanes;
// here each memory order is read as it lies, 16 bytes a thread where
// the channel (NHWC) or spatial (NCHW) extent allows it:
//   * NHWC (channels_last): the rows [M = N*H*W, C]. A block takes a
//     range of rows; its threads are `tc` channel-group lanes times `R`
//     row lanes, each owning V consecutive channels (V = 8 bf16 or 4
//     fp32 in one vector load, else 1). The R row lanes are summed by a
//     fixed shared-memory tree.
//   * NCHW (contiguous): a block takes one channel and one range of its
//     N*H*W elements (`L` long, a multiple of V), each thread V
//     consecutive elements a step; warp shuffles and a fixed tree over
//     the warps finish the block.
// Both write fp32 partials [2, P, C]; a second launch sums each
// channel's P partials in a fixed order. No float atomics: the same
// inputs give the same bits on every run. Offsets are int64 (the 224^2
// bs128 stem holds 1.03e8 elements; a test holds 4.3e9).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ void load(const T* p, float (&out)[V]) {
  Vec<T, V> r = *reinterpret_cast<const Vec<T, V>*>(p);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(r.v[i]);
}

template <typename TA, typename TB, int V, bool SAME>
__device__ __forceinline__ void accumulate(const TA* a, const TB* b,
                                           long long off, float (&sa)[V],
                                           float (&sab)[V]) {
  float av[V];
  load<TA, V>(a + off, av);
  if (SAME) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sa[i] += av[i];
      sab[i] = fmaf(av[i], av[i], sab[i]);
    }
  } else {
    float bv[V];
    load<TB, V>(b + off, bv);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sa[i] += av[i];
      sab[i] = fmaf(av[i], bv[i], sab[i]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// a, b: [M, C] rows. Grid (P, ceil(G / tc)), G = C / V channel groups;
// block: tc lanes over groups x R lanes over rows (tc * R <= kThreads);
// dynamic shared memory 2 * R * tc * V floats.
template <typename TA, typename TB, int V, bool SAME>
__global__ void sums_nhwc(const TA* __restrict__ a, const TB* __restrict__ b,
                          float* __restrict__ part, long long M, int C,
                          int tc, int R, long long rows_per_block) {
  extern __shared__ float sh[];
  const int G = C / V;
  const int lane_c = threadIdx.x % tc, lane_r = threadIdx.x / tc;
  const int g = blockIdx.y * tc + lane_c;
  float sa[V], sab[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sa[i] = sab[i] = 0.0f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  if (lane_r < R && g < G) {
    for (long long r = r0 + lane_r; r < r1; r += R)
      accumulate<TA, TB, V, SAME>(a, b, r * C + (long long)g * V, sa, sab);
  }
  const int W = tc * V;
  float* sha = sh;
  float* shb = sh + R * W;
  const int base = lane_r * W + lane_c * V;
  if (lane_r < R) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sha[base + i] = sa[i];
      shb[base + i] = sab[i];
    }
  }
  __syncthreads();
  int span = 1;
  while (span < R) span <<= 1;
  for (int s = span >> 1; s > 0; s >>= 1) {
    if (lane_r < s && lane_r + s < R) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        sha[base + i] += sha[base + s * W + i];
        shb[base + i] += shb[base + s * W + i];
      }
    }
    __syncthreads();
  }
  if (lane_r == 0 && g < G) {
    const long long P = gridDim.x;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const int c = g * V + i;
      part[(long long)blockIdx.x * C + c] = sha[lane_c * V + i];
      part[(P + blockIdx.x) * C + c] = shb[lane_c * V + i];
    }
  }
}

// a, b: [N, C, HW]. Grid (P, C): block (p, c) sums channel c's elements
// j in [p*L, min((p+1)*L, N*HW)), j = n*HW + hw, V at a time (HW and L
// are multiples of V).
template <typename TA, typename TB, int V, bool SAME>
__global__ void sums_nchw(const TA* __restrict__ a, const TB* __restrict__ b,
                          float* __restrict__ part, long long HW,
                          long long NHW, int C, long long L) {
  const int c = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * L;
  const long long j1 = min(NHW, j0 + L);
  float sa[V], sab[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sa[i] = sab[i] = 0.0f;
  const long long step = (long long)blockDim.x * V;
  long long j = j0 + (long long)threadIdx.x * V;
  if (j < j1) {
    // (n, hw) of j, advanced by the step without a division per load
    long long n = j / HW, hw = j - n * HW;
    const long long dn = step / HW, dhw = step - dn * HW;
    for (; j < j1; j += step) {
      accumulate<TA, TB, V, SAME>(a, b, (n * C + c) * HW + hw, sa, sab);
      n += dn;
      hw += dhw;
      if (hw >= HW) {
        hw -= HW;
        ++n;
      }
    }
  }
  float ta = 0.0f, tb = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ta += sa[i];
    tb += sab[i];
  }
  __shared__ float sw[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ta = warp_sum(ta);
  tb = warp_sum(tb);
  if (lane == 0) {
    sw[0][warp] = ta;
    sw[1][warp] = tb;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    ta = lane < nw ? sw[0][lane] : 0.0f;
    tb = lane < nw ? sw[1][lane] : 0.0f;
    ta = warp_sum(ta);
    tb = warp_sum(tb);
    if (lane == 0) {
      const long long P = gridDim.x;
      part[(long long)blockIdx.x * C + c] = ta;
      part[(P + blockIdx.x) * C + c] = tb;
    }
  }
}

// part [2, P, C] -> out [2, C]. Grid (C, 2): block (c, k) sums the P
// partials of out[k, c], thread t those at p = t, t + kThreads, ...,
// then warp shuffles and a fixed tree over the warps.
__global__ void sums_finish(const float* __restrict__ part,
                            float* __restrict__ out, int P, int C) {
  const int c = blockIdx.x, k = blockIdx.y;
  const float* src = part + (long long)k * P * C + c;
  float s = 0.0f;
  for (int p = threadIdx.x; p < P; p += blockDim.x) s += src[(long long)p * C];
  __shared__ float sw[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s = warp_sum(s);
  if (lane == 0) sw[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < (int)(blockDim.x / 32) ? sw[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) out[k * C + c] = s;
  }
}

template <typename TA, typename TB, int V, bool SAME>
void launch(const void* a, const void* b, float* part, int nhwc,
            long long N, int C, long long HW, int P, int tc, int R,
            cudaStream_t s) {
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  if (nhwc) {
    const long long M = N * HW;
    const long long rows = (M + P - 1) / P;
    const int G = C / V;
    dim3 grid((unsigned)P, (unsigned)((G + tc - 1) / tc));
    const size_t smem = sizeof(float) * 2 * R * tc * V;
    sums_nhwc<TA, TB, V, SAME><<<grid, kThreads, smem, s>>>(
        pa, pb, part, M, C, tc, R, rows);
  } else {
    const long long NHW = N * HW;
    long long L = (NHW + P - 1) / P;
    L = (L + V - 1) / V * V;
    dim3 grid((unsigned)P, (unsigned)C);
    sums_nchw<TA, TB, V, SAME><<<grid, kThreads, 0, s>>>(pa, pb, part, HW,
                                                         NHW, C, L);
  }
}

template <typename TA, typename TB, int VEC>
int dispatch_same(const void* a, const void* b, float* part, int same,
                  int nhwc, long long N, int C, long long HW, int P, int tc,
                  int R, cudaStream_t s) {
  if (same)
    launch<TA, TB, VEC, true>(a, b, part, nhwc, N, C, HW, P, tc, R, s);
  else
    launch<TA, TB, VEC, false>(a, b, part, nhwc, N, C, HW, P, tc, R, s);
  return 0;
}

template <typename TA, typename TB, int WIDE>
int dispatch_vec(const void* a, const void* b, float* part, int same,
                 int nhwc, long long N, int C, long long HW, int vec, int P,
                 int tc, int R, cudaStream_t s) {
  if (vec == WIDE)
    return dispatch_same<TA, TB, WIDE>(a, b, part, same, nhwc, N, C, HW, P,
                                       tc, R, s);
  if (vec == 1)
    return dispatch_same<TA, TB, 1>(a, b, part, same, nhwc, N, C, HW, P, tc,
                                    R, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, b: [N, C, H, W] fp32 (0) or bf16 (1) each, both NHWC (nhwc = 1) or
// both NCHW; same = 1: b is a and is not read. part: [2, P, C] fp32
// scratch; out: [2, C] fp32. vec: elements a thread loads at once (1, 4
// when a type is fp32, 8 when both are bf16); tc, R: the NHWC block's
// channel-group and row lanes (tc * R <= 256). The wrapper
// (ops/cuda/channel_sums.py `plan`) picks vec, P, tc and R.
extern "C" int cartseg_channel_sums(const void* a, const void* b,
                                    float* part, float* out, int a_bf16,
                                    int b_bf16, int same, int nhwc,
                                    long long N, int C, long long HW,
                                    int vec, int P, int tc, int R,
                                    void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0) return (int)cudaGetLastError();
  if (P <= 0 || tc <= 0 || R <= 0 || tc * R > kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (!a_bf16 && !b_bf16)
    rc = dispatch_vec<float, float, 4>(a, b, part, same, nhwc, N, C, HW, vec,
                                       P, tc, R, s);
  else if (a_bf16 && b_bf16)
    rc = dispatch_vec<__nv_bfloat16, __nv_bfloat16, 8>(
        a, b, part, same, nhwc, N, C, HW, vec, P, tc, R, s);
  else if (a_bf16)
    rc = dispatch_vec<__nv_bfloat16, float, 4>(a, b, part, 0, nhwc, N, C, HW,
                                               vec, P, tc, R, s);
  else
    rc = dispatch_vec<float, __nv_bfloat16, 4>(a, b, part, 0, nhwc, N, C, HW,
                                               vec, P, tc, R, s);
  if (rc != 0) return rc;
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  sums_finish<<<dim3((unsigned)C, 2), kThreads, 0, s>>>(part, out, P, C);
  return (int)cudaGetLastError();
}
