// Per-sample soft-Dice sums on Hopper.
//
// Replaces the TPU kernel `_reduce_kernel` (cartseg_tpu/ops/pallas/
// soft_dice.py:27), the analog of the reference's soft_dice_kernel_v2.cu
// forward. For logits x and labels y [B, M] float32, with
// p_i = 1 / (1 + exp(-x_i)):
//   numer[b] = sum_i 2 p_i y_i
//   denor[b] = sum_i (p_i^pexp + y_i)
// The loss 1 - (numer + s) / (denor + s) and its analytic backward are
// plain PyTorch (losses/region.py), as they were plain jnp on the TPU,
// which had no backward kernel.
//
// Bound on this card: memory bandwidth. It reads x and y once, 8 bytes
// an element, and writes 2B floats: 12.6 MB at [6,512,512,1], 3.8 us at
// 3.35 TB/s. At that size the launch, the loads' latency and the finish
// weigh as much as the bytes: with the L2 flushed a call takes 9.2 us
// (the two-launch form 9.9; ATen's sum over the same 12.6 MB 11.9), with
// the inputs in L2 5.0 us (tools/focal_dice_timing.py).
//
// Design. The TPU walked the samples' rows in a sequential grid and
// carried the sums in VMEM from step to step (soft_dice.py:43-49);
// Hopper's CTAs run in no order and carry nothing. One launch a call:
// grid (P, B), CTA (q, b) sums elements [q L, min((q + 1) L, M)) of
// sample b (L a multiple of 4; the wrapper's `plan` sizes P from the
// bytes, one wave at most). Thread t takes the loads at q L + t V +
// k 256 V, V = 4 (16-byte loads, when the arrays are aligned and M is a
// multiple of 4) or 1, and issues kLoads of them, of x and of y, before
// it adds them in k order into its two sums; warp shuffles and then the
// 8 warps in order give the CTA's partial (numer, denor), which it
// stores and counts in on sample b's arrival counter (`arrived_last`,
// csrc/arrival.cuh: an acquire-release increment that wraps to 0). The
// CTA that arrives last reads the sample's P partials from L2, thread t
// those at t, t + 256, ... in order, then shuffles and the warps in
// order, and writes out[0, b] and out[1, b]. No second launch, no
// memset, no float atomics: the same inputs and plan give the same bits
// on every run. pexp = 1 and 2 take p and p * p; other exponents powf.
// The adds are written as fmaf / __fadd_rn so that nvcc contracts
// nothing: sn = fma(2p, y, sn), sd = sd + (p^pexp + y). Offsets are
// int64.

#include <cstdint>
#include <cuda_runtime.h>

#include "arrival.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// 16-byte loads of x (and of y) a thread issues before it adds them
// (ops/cuda/soft_dice.py UNROLL)
constexpr int kUnroll = 1;
// CTAs an SM holds at once in the plan's one wave (ops/cuda/soft_dice.py
// BLOCKS_PER_SM)
constexpr int kMinBlocks = 6;

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's two sums by shuffles and then the warps in order, in
// thread 0 (all threads call it).
__device__ __forceinline__ float2 block_sum(float sn, float sd) {
  __shared__ float sw[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sn = warp_sum(sn);
  sd = warp_sum(sd);
  if (lane == 0) {
    sw[0][warp] = sn;
    sw[1][warp] = sd;
  }
  __syncthreads();
  float2 t = make_float2(0.0f, 0.0f);
  if (threadIdx.x == 0) {
    for (int w = 0; w < kWarps; ++w) {
      t.x += sw[0][w];
      t.y += sw[1][w];
    }
  }
  return t;
}

// PK: 1 -> p, 2 -> p * p, 0 -> powf(p, pexp).
template <int PK>
__device__ __forceinline__ void add(float x, float y, float pexp, float& sn,
                                    float& sd) {
  const float prob = 1.0f / (1.0f + expf(-x));
  const float pp = PK == 1   ? prob
                   : PK == 2 ? __fmul_rn(prob, prob)
                             : powf(prob, pexp);
  sn = fmaf(2.0f * prob, y, sn);
  sd = __fadd_rn(sd, __fadd_rn(pp, y));
}

// Grid (P, B); part: [B][P] (numer, denor) partials; count: B counters;
// out: [2, B].
template <int V, int PK>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dice_sums(const float* __restrict__ x, const float* __restrict__ y,
          float2* __restrict__ part, unsigned* __restrict__ count,
          float* __restrict__ out, long long M, long long L, float pexp) {
  constexpr int kLoads = V == 4 ? kUnroll : 4 * kUnroll;
  constexpr long long kStep = (long long)kThreads * V;
  const int q = blockIdx.x, b = blockIdx.y, P = gridDim.x;
  const float* xs = x + (long long)b * M;
  const float* ys = y + (long long)b * M;
  const long long j1 = min(M, (long long)q * L + L);
  float sn = 0.0f, sd = 0.0f;
  for (long long j = (long long)q * L + (long long)threadIdx.x * V; j < j1;
       j += kLoads * kStep) {
    Vec<V> xv[kLoads], yv[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (j + u * kStep < j1) {
        xv[u] = *reinterpret_cast<const Vec<V>*>(xs + j + u * kStep);
        yv[u] = *reinterpret_cast<const Vec<V>*>(ys + j + u * kStep);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (j + u * kStep < j1) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          add<PK>(xv[u].v[k], yv[u].v[k], pexp, sn, sd);
      }
    }
  }
  float2 t = block_sum(sn, sd);
  float2* rows = part + (long long)b * P;
  if (threadIdx.x == 0) rows[q] = t;
  if (!arrived_last(count + b, P)) return;

  // the last CTA of sample b: thread t the partials t, t + 256, ... in
  // order, then shuffles and the warps in order
  sn = sd = 0.0f;
  for (int p = threadIdx.x; p < P; p += kThreads) {
    const float2 v = __ldcg(rows + p);
    sn += v.x;
    sd += v.y;
  }
  t = block_sum(sn, sd);
  if (threadIdx.x == 0) {
    out[b] = t.x;
    out[gridDim.y + b] = t.y;
  }
}

template <int V>
void launch(const float* x, const float* y, float2* part, unsigned* count,
            float* out, int Bn, long long M, long long L, int P, float pexp,
            cudaStream_t s) {
  dim3 grid((unsigned)P, (unsigned)Bn);
  if (pexp == 1.0f)
    dice_sums<V, 1><<<grid, kThreads, 0, s>>>(x, y, part, count, out, M, L,
                                              pexp);
  else if (pexp == 2.0f)
    dice_sums<V, 2><<<grid, kThreads, 0, s>>>(x, y, part, count, out, M, L,
                                              pexp);
  else
    dice_sums<V, 0><<<grid, kThreads, 0, s>>>(x, y, part, count, out, M, L,
                                              pexp);
}

}  // namespace

// x, y: [B, M] float32; part: [B, P] float2 scratch; count: B zeroed
// unsigned counters private to the stream, zero again when the call
// ends; out: [2, B] float32 (numer, denor). vec = 4: M is a multiple of 4
// and both pointers are 16-byte aligned; else 1. P CTAs a sample of L
// elements each (L a multiple of 4, (P - 1) L < M <= P L). The wrapper
// (ops/cuda/soft_dice.py `plan`) picks vec, P and L.
extern "C" int cartseg_soft_dice(const float* x, const float* y, float* part,
                                 unsigned* count, float* out, int Bn,
                                 long long M, int P, long long L, int vec,
                                 float pexp, void* stream) {
  if (Bn <= 0 || M <= 0) return (int)cudaGetLastError();
  if (P <= 0 || Bn > 65535 || L <= 0 || L % 4 != 0 ||
      (long long)(P - 1) * L >= M || (long long)P * L < M ||
      (vec != 1 && vec != 4) || M % vec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float2* rows = reinterpret_cast<float2*>(part);
  if (vec == 4)
    launch<4>(x, y, rows, count, out, Bn, M, L, P, pexp, s);
  else
    launch<1>(x, y, rows, count, out, Bn, M, L, P, pexp, s);
  return (int)cudaGetLastError();
}
