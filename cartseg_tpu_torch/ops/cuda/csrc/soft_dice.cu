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
// 3.35 TB/s.
//
// Design. The TPU walked the samples' rows in a sequential grid and
// carried the sums in VMEM from step to step (soft_dice.py:43-49);
// Hopper's blocks run in no order and carry nothing. So a first launch
// has block (q, b) sum the q-th of P ranges of sample b (L elements, a
// multiple of 4; 16-byte loads when the wrapper says the arrays are
// aligned and M is a multiple of 4) into fp32 partials [2, B, P], by a
// serial sum in each thread, warp shuffles and a fixed tree over the
// warps. A second launch folds each sample's P partials in a fixed
// order. No float atomics: the same inputs give the same bits on every
// run. pexp = 1 and 2 take p and p*p; other exponents powf. Offsets are
// int64.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// The block's two sums into part[0][b][q] and part[1][b][q] (all threads
// call it).
__device__ __forceinline__ void block_store(float sn, float sd, float* part,
                                            long long slot, long long plane) {
  __shared__ float sw[2][kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  sn = warp_sum(sn);
  sd = warp_sum(sd);
  if (lane == 0) {
    sw[0][warp] = sn;
    sw[1][warp] = sd;
  }
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x / 32;
    sn = lane < nw ? sw[0][lane] : 0.0f;
    sd = lane < nw ? sw[1][lane] : 0.0f;
    sn = warp_sum(sn);
    sd = warp_sum(sd);
    if (lane == 0) {
      part[slot] = sn;
      part[plane + slot] = sd;
    }
  }
}

// PK: 1 -> p, 2 -> p * p, 0 -> powf(p, pexp).
template <int PK>
__device__ __forceinline__ void add(float x, float y, float pexp, float& sn,
                                    float& sd) {
  const float prob = 1.0f / (1.0f + expf(-x));
  const float pp = PK == 1 ? prob : (PK == 2 ? prob * prob : powf(prob, pexp));
  sn += 2.0f * prob * y;
  sd += pp + y;
}

// Grid (P, B). Block (q, b) sums elements [q L, min((q + 1) L, M)) of
// sample b, V at a time.
template <int V, int PK>
__global__ void dice_partials(const float* __restrict__ x,
                              const float* __restrict__ y,
                              float* __restrict__ part, long long M,
                              long long L, float pexp) {
  const int q = blockIdx.x, b = blockIdx.y;
  const long long base = (long long)b * M;
  const long long j0 = (long long)q * L;
  const long long j1 = min(M, j0 + L);
  float sn = 0.0f, sd = 0.0f;
  for (long long j = j0 + (long long)threadIdx.x * V; j < j1;
       j += (long long)blockDim.x * V) {
    if (V == 4) {
      const float4 xv = *reinterpret_cast<const float4*>(x + base + j);
      const float4 yv = *reinterpret_cast<const float4*>(y + base + j);
      add<PK>(xv.x, yv.x, pexp, sn, sd);
      add<PK>(xv.y, yv.y, pexp, sn, sd);
      add<PK>(xv.z, yv.z, pexp, sn, sd);
      add<PK>(xv.w, yv.w, pexp, sn, sd);
    } else {
      add<PK>(x[base + j], y[base + j], pexp, sn, sd);
    }
  }
  const long long P = gridDim.x, Bn = gridDim.y;
  block_store(sn, sd, part, (long long)b * P + q, Bn * P);
}

// part [2, B, P] -> out [2, B]. Grid (B, 2): block (b, k) folds the P
// partials of out[k, b], thread t those at q = t, t + kThreads, ...
__global__ void dice_finish(const float* __restrict__ part,
                            float* __restrict__ out, int P) {
  const int b = blockIdx.x, k = blockIdx.y, Bn = gridDim.x;
  const float* src = part + ((long long)k * Bn + b) * P;
  float s = 0.0f;
  for (int q = threadIdx.x; q < P; q += blockDim.x) s += src[q];
  __shared__ float sw[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s = warp_sum(s);
  if (lane == 0) sw[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < (int)(blockDim.x / 32) ? sw[lane] : 0.0f;
    s = warp_sum(s);
    if (lane == 0) out[k * Bn + b] = s;
  }
}

template <int V>
void launch(const float* x, const float* y, float* part, int Bn,
            long long M, long long L, int P, float pexp, cudaStream_t s) {
  dim3 grid((unsigned)P, (unsigned)Bn);
  if (pexp == 1.0f)
    dice_partials<V, 1><<<grid, kThreads, 0, s>>>(x, y, part, M, L, pexp);
  else if (pexp == 2.0f)
    dice_partials<V, 2><<<grid, kThreads, 0, s>>>(x, y, part, M, L, pexp);
  else
    dice_partials<V, 0><<<grid, kThreads, 0, s>>>(x, y, part, M, L, pexp);
}

}  // namespace

// x, y: [B, M] float32; part: [2, B, P] float32 scratch; out: [2, B]
// float32 (numer, denor). vec = 4: M is a multiple of 4 and both
// pointers are 16-byte aligned; else 1. The wrapper (ops/cuda/
// soft_dice.py) picks P.
extern "C" int cartseg_soft_dice(const float* x, const float* y, float* part,
                                 float* out, int Bn, long long M, int P,
                                 int vec, float pexp, void* stream) {
  if (Bn <= 0 || M <= 0) return (int)cudaGetLastError();
  if (P <= 0 || Bn > 65535 || (vec != 1 && vec != 4) || M % vec != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  long long L = (M + P - 1) / P;
  L = (L + vec - 1) / vec * vec;
  if (vec == 4)
    launch<4>(x, y, part, Bn, M, L, P, pexp, s);
  else
    launch<1>(x, y, part, Bn, M, L, P, pexp, s);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  dice_finish<<<dim3((unsigned)Bn, 2), kThreads, 0, s>>>(part, out, P);
  return (int)cudaGetLastError();
}
