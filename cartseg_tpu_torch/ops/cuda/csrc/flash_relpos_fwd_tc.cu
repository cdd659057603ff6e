// Flash attention with SAM's decomposed relative-position bias, forward,
// bfloat16, on Hopper's tensor cores.
//
// Replaces the TPU kernel `_kernel` (cartseg_tpu/ops/pallas/
// flash_attention.py:88, pallas_call at :162) for bfloat16 inputs;
// flash_relpos.cu keeps the float32 route on the CUDA cores and hands every
// bf16 call to the C entry point at the end of this file. For one
// (batch*head) slice of S = g*g tokens on a g x g grid:
//   out[i] = sum_j p_ij v_j,
//   p_ij   = softmax_j(scale * (q_i . k_j) + rel_h[i, j / g] + rel_w[i, j % g])
// with an fp32 online softmax (running max from -1e30), the output in
// bf16. Given a non-null lse (the training forward) it also writes each
// row's fp32 logsumexp m + log(l) in natural-log units, which the backward
// (flash_relpos_bwd_tc.cu) multiplies by log2(e) and recomputes P from.
// Neither the (S, S) logits nor P is written to device memory.
//
// Design
// - One warpgroup (128 threads) a block, which owns one 64-row query tile.
//   The Q tile stays resident in shared memory; 64-key tiles of K and V
//   stream through a 2-stage ring of cp.async copies (tile t + 1 is copied
//   while tile t is multiplied). Tiles are bf16 [64][HD] rows in wgmma's
//   128-byte (HD 64) or 64-byte (HD 32) swizzle (flash_tc_common.cuh).
// - The first product S = Q K^T is wgmma m64n64k16, both operands K-major
//   from shared memory, HD/16 k-steps. The second, O += P V, takes P from
//   registers (the accumulator packed to bf16 in place, `to_a`) and V
//   MN-major by the transpose bit, m64nHD, 4 k-steps. The P V of tile t is
//   waited for after the Q K^T of tile t + 1 is issued, so the tensor
//   cores run them back to back while the softmax waits.
// - The softmax is fp32 in the accumulator's fragment layout: a thread
//   holds 2 rows x 16 keys of a tile, and a row's max and sum take two
//   quad shuffles. exp is exp2f with log2(e) folded into the scale and the
//   bias: x = s * scale*log2e + bias*log2e, P = 2^(x - m), O and l
//   rescaled by 2^(m_old - m_new).
// - The bias: at g = 64 (SAM at 1024^2, S = 4096, no ragged edge) a 64-key
//   tile is exactly grid row kh, so rel_h is one scalar a row and tile and
//   rel_w * log2e sits in registers for the whole block. Any other g looks
//   both terms up in the block's [64, g] rows in shared memory; keys past
//   S get x = -inf, so P = 0 there (their K and V rows are zeros).
// - Rounding points, as FlashAttention-2/3 and SDPA: P is rounded to bf16
//   once, as the A operand of P V; l sums the fp32 P; O accumulates in fp32
//   and is divided by l and rounded to bf16 once.
// Every output has one writer and there are no atomics: a second run gives
// the same bits. ptxas reports that it serialises this kernel's wgmmas
// (C7514: non-wgmma instructions read an accumulator within a pipeline
// stage). Dropping the in-place rescale of O (which breaks the function)
// silences it; a variant that kept P V in a fresh accumulator and folded
// it into O after the wait drew the same report, ran no faster and took
// 31 more registers.
//
// Bound on this card: operations. At [12,4096,64] the two products are
// 2 * 2*12*4096^2*64 = 51.5 GFLOP: 0.052 ms at 989 TFLOP/s dense bf16
// (chip_smoke.flash_bound), against ~0.02 ms of device-memory traffic.
// Beside the tensor cores, every logit takes one exp2 on the SFUs (2.0e8
// at that shape, 16 a clock on an SM: about as long as the products) and
// the bias and max work on the FP32 pipes.

#include "flash_tc_common.cuh"

namespace {

using namespace flash_tc;

constexpr float kLn2 = 0.6931471805599453f;
constexpr float kNegInit = -1e30f;

// shared memory: Q, 2 stages of K and V, the block's rel_h and rel_w rows
template <int HD>
__host__ __device__ __forceinline__ uint32_t fwd_smem_bytes(int g) {
  return 5 * Tile<HD>::kBytes + 2 * rel_bytes(g) + 1024;
}

template <int HD, bool G64>
__global__ void __launch_bounds__(kWG, 2)
flash_fwd_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ rel_h,
             const bf16* __restrict__ rel_w, bf16* __restrict__ out,
             float* __restrict__ lse, int S, int g, float scale) {
  constexpr uint32_t T = Tile<HD>::kBytes;
  constexpr int ND = HD / 2;  // O accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s0 = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (s0 - raw);
  const uint32_t o_rh = 5 * T, o_rw = o_rh + rel_bytes(g);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ra = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int q0 = blockIdx.x * kR, hh = blockIdx.y;
  const size_t base = (size_t)hh * S * HD;
  const size_t rel0 = ((size_t)hh * S + q0) * g;
  const size_t rel_total = (size_t)gridDim.y * S * g;
  const int rsh = span_shift<2>(rel0);
  const bf16* rhs = reinterpret_cast<const bf16*>(sm + o_rh) + rsh;
  const bf16* rws = reinterpret_cast<const bf16*>(sm + o_rw) + rsh;

  load_tile<HD>(s0, q + base, q0, S);
  load_span<2>(s0 + o_rh, rel_h, rel0, kR * g, rel_total);
  load_span<2>(s0 + o_rw, rel_w, rel0, kR * g, rel_total);
  load_tile<HD>(s0 + T, k + base, 0, S);
  load_tile<HD>(s0 + 3 * T, v + base, 0, S);
  cp_commit();

  const float sl2 = scale * kLog2e;
  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f};
  float o[ND], bw[32];
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i] = 0.f;

  cp_wait_all();
  __syncthreads();
  if (G64) {
    // the tile's columns are kw: rel_w * log2e, fixed for the block
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          bw[4 * n + 2 * hf + e] =
              __bfloat162float(rws[(ra + 8 * hf) * 64 + 8 * n + cq + e]) *
              kLog2e;
  }
  uint32_t a[4][4] = {};  // P as the A operand of O += P V

  const int n_tiles = (S + kR - 1) / kR;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * kR;
    const uint32_t ks = s0 + (1 + st) * T, vs = s0 + (3 + st) * T;
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile kt has landed

    float s[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<HD>(s0, kk), desc_k<HD>(ks, kk), kk);
    wg_commit();
    // O += P V of tile kt - 1 is done with its stage, which the copy of
    // tile kt + 1 takes over
    wg_wait<1>();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      load_tile<HD>(s0 + (1 + (st ^ 1)) * T, k + base, k0 + kR, S);
      load_tile<HD>(s0 + (3 + (st ^ 1)) * T, v + base, k0 + kR, S);
      cp_commit();
    }
    // every product is done: its registers (P's A fragments, O, S) are
    // touched only from here on
    wg_wait<0>();
    fence_regs(a);
    fence_regs(o);
    fence_regs(s);

    // the logits in log2 units, in place of s
    if (G64) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const float rh2 =
            __bfloat162float(rhs[(ra + 8 * hf) * 64 + kt]) * kLog2e;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n + 2 * hf + e;
            s[i] = fmaf(s[i], sl2, bw[i] + rh2);
          }
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * n + cq + e;
          const bool kok = key < S;
          const int kh = kok ? key / g : 0, kw = kok ? key - kh * g : 0;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 4 * n + 2 * hf + e, r = ra + 8 * hf;
            const float bias = __bfloat162float(rhs[r * g + kh]) +
                               __bfloat162float(rws[r * g + kw]);
            s[i] = kok ? fmaf(s[i], sl2, bias * kLog2e)
                       : __int_as_float(0xff800000u);  // -inf
          }
        }
    }

    // online softmax: P in place of s; O and l rescaled
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float mx = kNegInit;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[4 * n + 2 * hf + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hf], mx);
      const float alpha = exp2f(m[hf] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * hf + e;
          s[i] = exp2f(s[i] - m_new);
          sum += s[i];
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[hf] = l[hf] * alpha + sum;
      m[hf] = m_new;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n) {
        o[4 * n + 2 * hf] *= alpha;
        o[4 * n + 2 * hf + 1] *= alpha;
      }
    }

    // O += P V, waited for in the next iteration; the rescaled O and the
    // packed P are pinned before the fence
    to_a(s, a);
    fence_regs(a);
    fence_regs(o);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn<HD>(o, a[kk], desc_mn<HD>(vs, kk));
    wg_commit();
  }
  wg_wait<0>();
  fence_regs(o);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + ra + 8 * hf;
    if (r >= S) continue;
    bf16* w = out + base + (size_t)r * HD + cq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(w + 8 * n, o[4 * n + 2 * hf] / l[hf],
             o[4 * n + 2 * hf + 1] / l[hf]);
    if (lse != nullptr && (lane & 3) == 0)
      lse[(size_t)hh * S + r] = m[hf] * kLn2 + logf(l[hf]);
  }
}

template <int HD, bool G64>
int launch(const void* q, const void* k, const void* v, const void* rel_h,
           const void* rel_w, void* out, float* lse, int bnh, int S, int g,
           float scale, cudaStream_t stream) {
  auto kern = flash_fwd_tc<HD, G64>;
  const size_t smem = fwd_smem_bytes<HD>(g);
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<dim3((S + kR - 1) / kR, bnh), kWG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<bf16*>(out), lse, S, g,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, out [bnh, S, hd] and rel_h, rel_w [bnh, S, g], all
// contiguous and 16-byte aligned, S == g*g, hd 32 or 64. lse: null
// (inference: nothing written) or fp32 [bnh, S].
extern "C" int cartseg_flash_relpos_fwd_tc(const void* q, const void* k,
                                           const void* v, const void* rel_h,
                                           const void* rel_w, void* out,
                                           void* lse, int bnh, int S, int g,
                                           int hd, float scale,
                                           void* stream) {
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
#define CARTSEG_FWD_ARGS q, k, v, rel_h, rel_w, out, l, bnh, S, g, scale, st
  if (hd == 64 && g == 64) return launch<64, true>(CARTSEG_FWD_ARGS);
  if (hd == 64) return launch<64, false>(CARTSEG_FWD_ARGS);
  if (hd == 32 && g == 64) return launch<32, true>(CARTSEG_FWD_ARGS);
  if (hd == 32) return launch<32, false>(CARTSEG_FWD_ARGS);
#undef CARTSEG_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
