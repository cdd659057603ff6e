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
// layer sees 7.9e5 (layer4) to 2.5e7 (stem, decoder top) elements, so
// most of a step's 92 calls last a few microseconds and the launch, the
// first load's latency and the finish weigh as much as the bytes.
//
// Design: one launch a call. The TPU re-viewed the batch as [B*H, W*C]
// to fill 128 lanes; here each memory order is read as it lies, 16 bytes
// a load where the channel (NHWC) or spatial (NCHW) extent allows it,
// kUnroll independent loads in flight a thread:
//   * NHWC (channels_last): the rows [M = N*H*W, C]. Grid (P, gy): CTA
//     (p, y) takes rows [p*ceil(M/P), ...) of column y, tc channel
//     groups of V channels (V = 8 bf16 or 4 fp32 in one 16-byte load,
//     else 1; tc a power of two). Its threads are tc group lanes times
//     R = 256 / tc row lanes; a row lane walks its rows R apart. The row
//     lanes of one warp (tc < 32) are summed by shuffles, the rest
//     (warps, or R row lanes when tc >= 32) in order through shared
//     memory.
//   * NCHW (contiguous): grid (P, C). CTA (p, c) takes one range of
//     channel c's N*H*W elements (a multiple of V long); shuffles and
//     the 8 warps in order finish the block.
// Each CTA writes its fp32 partial row and counts itself in on an
// arrival counter of its column (NHWC) or channel (NCHW) by one
// acquire-release increment (`arrived_last`, csrc/arrival.cuh); the
// CTA that arrives last reads the P partial rows from L2 and sums them
// in p order. The increment wraps the counter back to 0 on that last
// arrival, so the next call on the stream finds it zero: no memset, no
// second launch.
// No float atomics: the same inputs and plan give the same bits on every
// run. The counters belong to one stream (the wrapper keeps one set a
// stream), since two calls in flight at once must not share them.
// Offsets are int64 (the 224^2 bs128 stem holds 1.03e8 elements; a test
// holds 4.3e9).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "arrival.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// independent loads a thread issues before it adds them (ops/cuda/
// channel_sums.py UNROLL)
constexpr int kUnroll = 4;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// U loads of V elements of a (and of b unless SAME) at the offsets, all
// issued before the first add; then added in offset order
template <typename TA, typename TB, int V, bool SAME, int U>
__device__ __forceinline__ void accumulate(const TA* __restrict__ a,
                                           const TB* __restrict__ b,
                                           const long long (&off)[U],
                                           float (&sa)[V], float (&sab)[V]) {
  Vec<TA, V> ra[U];
  Vec<TB, V> rb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    ra[u] = *reinterpret_cast<const Vec<TA, V>*>(a + off[u]);
    if (!SAME) rb[u] = *reinterpret_cast<const Vec<TB, V>*>(b + off[u]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float x = to_f(ra[u].v[i]);
      const float y = SAME ? x : to_f(rb[u].v[i]);
      sa[i] += x;
      sab[i] = fmaf(x, y, sab[i]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// a, b: [M, C] rows. Grid (P, gy); block kThreads = tc group lanes x R
// row lanes; part: [gy][P][K] fp32, K = 2 W, W = tc * V (even), entry
// k = s * W + w of a row holding sum s (0: a, 1: a*b) of channel
// y * W + w (0 past C); count: gy counters.
template <typename TA, typename TB, int V, bool SAME>
__global__ void __launch_bounds__(kThreads)
sums_nhwc(const TA* __restrict__ a, const TB* __restrict__ b,
          float* __restrict__ part, unsigned* __restrict__ count,
          float* __restrict__ out, long long M, int C, int tc,
          long long rows_per_block) {
  // the row lanes' sums, then the finish's float4 lanes (256 float4s)
  __shared__ __align__(16) float red[2 * kThreads * (V < 2 ? 2 : V)];
  const int G = C / V, R = kThreads / tc, W = tc * V, K = 2 * W;
  const int lane_c = threadIdx.x % tc, lane_r = threadIdx.x / tc;
  const int g = blockIdx.y * tc + lane_c;
  float sa[V], sab[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sa[i] = sab[i] = 0.0f;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min(M, r0 + rows_per_block);
  if (g < G) {
    const long long col = (long long)g * V;
    long long r = r0 + lane_r;
    for (; r + (kUnroll - 1) * (long long)R < r1; r += kUnroll * R) {
      long long off[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) off[u] = (r + u * R) * C + col;
      accumulate<TA, TB, V, SAME, kUnroll>(a, b, off, sa, sab);
    }
    for (; r < r1; r += R) {
      const long long off[1] = {r * C + col};
      accumulate<TA, TB, V, SAME, 1>(a, b, off, sa, sab);
    }
  }
  // the row lanes of a warp by shuffles (tc < 32: lanes l and l + tc hold
  // one group), leaving one row lane a warp; red[s][lane][W]
  int lanes = R, lane = lane_r;
  if (tc < 32) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      for (int o = 16; o >= tc; o >>= 1) {
        sa[i] += __shfl_down_sync(0xffffffffu, sa[i], o);
        sab[i] += __shfl_down_sync(0xffffffffu, sab[i], o);
      }
    }
    lanes = kWarps;
    lane = threadIdx.x / 32;
  }
  if (tc >= 32 || threadIdx.x % 32 < tc) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[lane * W + lane_c * V + i] = sa[i];
      red[(lanes + lane) * W + lane_c * V + i] = sab[i];
    }
  }
  __syncthreads();
  // the lanes left, in lane order: the CTA's partial row
  float* row = part + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * K;
  for (int k = threadIdx.x; k < K; k += kThreads) {
    const int s = k / W, w = k - s * W;
    const float* src = red + s * lanes * W + w;
    float t = 0.0f;
    for (int l = 0; l < lanes; ++l) t += src[l * W];
    row[k] = t;
  }
  if (!arrived_last(count + blockIdx.y, gridDim.x)) return;

  // the last CTA of column y: the P rows' float4 column q summed in p
  // order, by J = kThreads / Q lanes each taking every J-th row, the lanes
  // then in order (Q = K / 4 float4s a row)
  const int P = gridDim.x, Q = K / 4;
  const float4* rows4 = reinterpret_cast<const float4*>(
      part + (long long)blockIdx.y * P * K);
  float4* red4 = reinterpret_cast<float4*>(red);
  const int c0 = blockIdx.y * W;
  for (int q0 = 0; q0 < Q; q0 += kThreads) {
    const int J = Q - q0 >= kThreads ? 1 : kThreads / (Q - q0);
    const int span = min(Q - q0, kThreads);
    const int q = q0 + threadIdx.x % span, j = threadIdx.x / span;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int p = j; p < P; p += J) {
      const float4 v = __ldcg(rows4 + (long long)p * Q + q);
      t.x += v.x;
      t.y += v.y;
      t.z += v.z;
      t.w += v.w;
    }
    if (J > 1) {
      __syncthreads();
      red4[j * span + (q - q0)] = t;
      __syncthreads();
      if (threadIdx.x >= span) continue;
      t = red4[threadIdx.x];
      for (int l = 1; l < J; ++l) {
        const float4 v = red4[l * span + threadIdx.x];
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
    }
    const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * q + e;
      const int s = k / W, c = c0 + k - s * W;
      if (c < C) out[s * C + c] = tv[e];
    }
  }
}

// Channel c's element j in [p*L, min((p+1)*L, N*HW)), j = n*HW + hw, lies
// at (n*C + c)*HW + hw; `Walk` steps a thread's j by `step` (HW and the
// step are multiples of V) without a division a load.
struct Walk {
  long long n, hw;
  __device__ __forceinline__ void advance(long long HW, long long dn,
                                          long long dhw) {
    n += dn;
    hw += dhw;
    if (hw >= HW) {
      hw -= HW;
      ++n;
    }
  }
};

// a, b: [N, C, HW]. Grid (P, C); part: [C][P][2] fp32; count: C counters.
template <typename TA, typename TB, int V, bool SAME>
__global__ void __launch_bounds__(kThreads)
sums_nchw(const TA* __restrict__ a, const TB* __restrict__ b,
          float* __restrict__ part, unsigned* __restrict__ count,
          float* __restrict__ out, long long HW, long long NHW, int C,
          long long L) {
  const int c = blockIdx.y;
  const long long j0 = (long long)blockIdx.x * L;
  const long long j1 = min(NHW, j0 + L);
  float sa[V], sab[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sa[i] = sab[i] = 0.0f;
  const long long step = (long long)kThreads * V;
  const long long dn = step / HW, dhw = step - dn * HW;
  long long j = j0 + (long long)threadIdx.x * V;
  if (j < j1) {
    Walk at{j / HW, j % HW};
    for (; j + (kUnroll - 1) * step < j1; j += kUnroll * step) {
      long long off[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        off[u] = (at.n * C + c) * HW + at.hw;
        at.advance(HW, dn, dhw);
      }
      accumulate<TA, TB, V, SAME, kUnroll>(a, b, off, sa, sab);
    }
    for (; j < j1; j += step) {
      const long long off[1] = {(at.n * C + c) * HW + at.hw};
      at.advance(HW, dn, dhw);
      accumulate<TA, TB, V, SAME, 1>(a, b, off, sa, sab);
    }
  }
  float ta = 0.0f, tb = 0.0f;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    ta += sa[i];
    tb += sab[i];
  }
  __shared__ float sw[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  ta = warp_sum(ta);
  tb = warp_sum(tb);
  if (lane == 0) {
    sw[0][warp] = ta;
    sw[1][warp] = tb;
  }
  __syncthreads();
  const long long P = gridDim.x;
  float2* rows = reinterpret_cast<float2*>(part) + (long long)c * P;
  if (threadIdx.x == 0) {
    ta = tb = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      ta += sw[0][w];
      tb += sw[1][w];
    }
    rows[blockIdx.x] = make_float2(ta, tb);
  }
  if (!arrived_last(count + c, gridDim.x)) return;

  // the last CTA of channel c: thread t sums rows t, t + 256, ... in
  // order, then shuffles and the warps in order
  ta = tb = 0.0f;
#pragma unroll 4
  for (long long p = threadIdx.x; p < P; p += kThreads) {
    const float2 v = __ldcg(rows + p);
    ta += v.x;
    tb += v.y;
  }
  ta = warp_sum(ta);
  tb = warp_sum(tb);
  if (lane == 0) {
    sw[0][warp] = ta;
    sw[1][warp] = tb;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    ta = tb = 0.0f;
    for (int w = 0; w < kWarps; ++w) {
      ta += sw[0][w];
      tb += sw[1][w];
    }
    out[c] = ta;
    out[C + c] = tb;
  }
}

template <typename TA, typename TB, int V, bool SAME>
void launch(const void* a, const void* b, float* part, unsigned* count,
            float* out, int nhwc, long long N, int C, long long HW, int P,
            int tc, cudaStream_t s) {
  const TA* pa = static_cast<const TA*>(a);
  const TB* pb = static_cast<const TB*>(b);
  if (nhwc) {
    const long long M = N * HW;
    const long long rows = (M + P - 1) / P;
    const int G = C / V;
    dim3 grid((unsigned)P, (unsigned)((G + tc - 1) / tc));
    sums_nhwc<TA, TB, V, SAME><<<grid, kThreads, 0, s>>>(
        pa, pb, part, count, out, M, C, tc, rows);
  } else {
    const long long NHW = N * HW;
    long long L = (NHW + P - 1) / P;
    L = (L + V - 1) / V * V;
    dim3 grid((unsigned)P, (unsigned)C);
    sums_nchw<TA, TB, V, SAME><<<grid, kThreads, 0, s>>>(
        pa, pb, part, count, out, HW, NHW, C, L);
  }
}

template <typename TA, typename TB, int VEC>
int dispatch_same(const void* a, const void* b, float* part,
                  unsigned* count, float* out, int same, int nhwc,
                  long long N, int C, long long HW, int P, int tc,
                  cudaStream_t s) {
  if (same)
    launch<TA, TB, VEC, true>(a, b, part, count, out, nhwc, N, C, HW, P, tc,
                              s);
  else
    launch<TA, TB, VEC, false>(a, b, part, count, out, nhwc, N, C, HW, P,
                               tc, s);
  return 0;
}

template <typename TA, typename TB, int WIDE>
int dispatch_vec(const void* a, const void* b, float* part, unsigned* count,
                 float* out, int same, int nhwc, long long N, int C,
                 long long HW, int vec, int P, int tc, cudaStream_t s) {
  if (vec == WIDE)
    return dispatch_same<TA, TB, WIDE>(a, b, part, count, out, same, nhwc, N,
                                       C, HW, P, tc, s);
  if (vec == 1)
    return dispatch_same<TA, TB, 1>(a, b, part, count, out, same, nhwc, N, C,
                                    HW, P, tc, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// a, b: [N, C, H, W] fp32 (0) or bf16 (1) each, both NHWC (nhwc = 1) or
// both NCHW; same = 1: b is a and is not read. out: [2, C] fp32. vec:
// elements a thread loads at once (1, 4 when a type is fp32, 8 when both
// are bf16); P: CTAs a column (NHWC) or channel (NCHW); tc: the NHWC
// block's channel-group lanes (a power of two up to 256, tc * vec even).
// part: fp32 scratch, NHWC [ceil(C / vec / tc)][P][2 tc vec] (16-byte
// aligned), NCHW [C][P][2]; count: one zeroed unsigned counter a column
// or channel, private to the stream, and zero again when the call ends.
// The wrapper (ops/cuda/channel_sums.py `plan`) picks vec, P and tc.
extern "C" int cartseg_channel_sums(const void* a, const void* b,
                                    float* part, unsigned* count, float* out,
                                    int a_bf16, int b_bf16, int same,
                                    int nhwc, long long N, int C,
                                    long long HW, int vec, int P, int tc,
                                    void* stream) {
  if (N <= 0 || C <= 0 || HW <= 0) return (int)cudaGetLastError();
  if (P <= 0 || tc <= 0 || tc > kThreads || (tc & (tc - 1)) ||
      (nhwc && tc * vec < 2))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (!a_bf16 && !b_bf16)
    rc = dispatch_vec<float, float, 4>(a, b, part, count, out, same, nhwc, N,
                                       C, HW, vec, P, tc, s);
  else if (a_bf16 && b_bf16)
    rc = dispatch_vec<__nv_bfloat16, __nv_bfloat16, 8>(
        a, b, part, count, out, same, nhwc, N, C, HW, vec, P, tc, s);
  else if (a_bf16)
    rc = dispatch_vec<__nv_bfloat16, float, 4>(a, b, part, count, out, 0,
                                               nhwc, N, C, HW, vec, P, tc, s);
  else
    rc = dispatch_vec<float, __nv_bfloat16, 4>(a, b, part, count, out, 0,
                                               nhwc, N, C, HW, vec, P, tc, s);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
