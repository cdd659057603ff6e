// Flash attention with SAM's decomposed relative-position bias, forward,
// on Hopper.
//
// Replaces the TPU kernel `_kernel` (cartseg_tpu/ops/pallas/
// flash_attention.py:88, pallas_call at :162). For one (batch*head) slice
// of S = g*g tokens on a g x g grid:
//   out[i] = sum_j p_ij v_j,
//   p_ij   = softmax_j(scale * (q_i . k_j) + rel_h[i, j / g] + rel_w[i, j % g])
// with an fp32 online softmax (running max from -1e30), for float32 inputs
// and output (bfloat16 takes flash_relpos_fwd_tc.cu). The (S, S) logits and
// bias are never written to device memory: a block rebuilds each 64x64
// tile of them in registers from Q, K and the two [S, g] factors, which is
// what the TPU kernel kept out of HBM too. Given a non-null lse (the
// training forward) it also writes each row's fp32 logsumexp m + log(l)
// for the backward (flash_relpos_bwd.cu), as the TPU kernel's lse_ref
// (:129-130); the inference call passes null and writes nothing.
//
// Route: `flash_fwd_tf32x3`, both products on the tensor cores as split
// TF32 (flash_tf32x3_common.cuh): each fp32 operand cut into hi = tf32(x)
// and lo = tf32(x - hi), a product hi lo + lo hi + hi hi on mma.sync
// m16n8k8 tf32, the softmax and every sum in fp32. That holds fp32's
// tolerance against the plain version (1e-5 of max |plain|; tests/
// test_torch_flash_fwd_tf32x3.py emulates the arithmetic on the CPU).
// cartseg_tpu_torch.device.set_fp32_policy turns TF32 off for PyTorch's
// own matmuls and convolutions; it does not govern this kernel, which
// keeps fp32's accuracy by the split and not by fp32 FMAs.
//
// Design: flash_relpos_bwd.cu's dq kernel without dP and with an online
// softmax.
// - 128 threads (4 warps) a block of 64 query rows, warp w its rows
//   16w..16w+15; a loop streams 64-key tiles of K and V through a 2-stage
//   ring of cp.async copies into swizzled fp32 tiles (tile t + 1 is copied
//   while tile t is multiplied): 72 KB at head_dim 64, two blocks an SM.
// - S = Q K^T over head_dim: Q is the same for every key tile, so its hi
//   and lo A fragments are split once a block and stay in registers (64 at
//   head_dim 64); K's B fragments are split where each warp reads them.
//   (A pass that splits K and V once a tile into hi / lo shared tiles
//   issues a fifth fewer instructions but needs a second barrier a tile
//   and ran 11 % slower on the card.)
// - The online softmax works in the accumulators' fragment layout, in the
//   log2 domain (exp2 of scale log2(e) s + bias log2(e)): the row max by
//   two quad shuffles, the rescale alpha = exp2(m - m_new), each thread's
//   part of the row sum l carried in registers and joined by two quad
//   shuffles at the end. At g = 64 (SAM at 1024^2) a 64-key tile is one
//   grid row kh: rel_w[i, kw] of the thread's columns is the same for
//   every tile and stays in registers (loaded once a block), rel_h[i, kh]
//   is one value a row and tile. Any other g reads both factors from L1 /
//   L2 for each logit and gives keys past S -inf.
// - acc = alpha acc + P V: P's accumulator is the A operand of the second
//   product as it lies (the k index t read as column 2t), V the B operand.
//   The tile's product is summed from zero and joins acc in one FP32 FMA
//   with the rescale: the tensor cores truncate their fp32 sums, and a
//   chain over all S keys would carry that bias (the backward kernels
//   measured 3.6e-5 of max |plain| that way against 5.2e-6).
// - out = acc / l and lse = m ln 2 + log(l) from registers. Every output
//   element has one writer and there are no atomics: a second run gives
//   the same bits.
//
// Bound on this card: operations. At the ViT-B global block [12,4096,64]
// the two products are 2 * 2*12*4096^2*64 = 51.5 GFLOP, against 75.5 MB
// of fp32 inputs and output. As 3 TF32 products each at 495 TFLOP/s dense
// TF32: 0.3124 ms (chip_smoke.flash_bound); the fp32 FMAs of the CUDA cores
// at 67 TFLOP/s could not beat 0.769 ms. Beside the tensor cores the
// kernel spends two roundings and a subtract for every K and V value each
// warp reads (the splits), and an exp2 for every logit.

#include <math_constants.h>

#include "flash_tf32x3_common.cuh"

namespace {

using namespace flash_tf32x3;

constexpr float kNegInit = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

// shared memory: 2 stages of a K and a V tile
template <int HD>
constexpr size_t smem_bytes() {
  return 4 * 4 * (size_t)Tile<HD>::kFloats;
}

template <int HD, bool G64>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ rel_h,
                 const float* __restrict__ rel_w, float* __restrict__ out,
                 float* __restrict__ lse, int S, int g, float scale) {
  constexpr int T = Tile<HD>::kFloats, NC = HD / 8;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);  // stage st: K, V at 2 st T

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 16 * warp + gq;  // the thread's rows ra and ra + 8
  const int q0 = blockIdx.x * kR, hh = blockIdx.y;
  const size_t base = (size_t)hh * S * HD;
  const size_t rel0 = ((size_t)hh * S + q0) * g;

  load_tile<HD>(sm, k + base, 0, S);
  load_tile<HD>(sm + T, v + base, 0, S);
  cp_commit();

  bool rok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) rok[hf] = q0 + ra + 8 * hf < S;
  // Q's A fragments, split once: rows ra and ra + 8, columns (d, d + 1)
  FragA qa[NC];
#pragma unroll
  for (int kc = 0; kc < NC; ++kc) {
    float2 u[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      u[hf] = rok[hf] ? __ldg(reinterpret_cast<const float2*>(
                            q + base + (size_t)(q0 + ra + 8 * hf) * HD +
                            8 * kc + 2 * tq))
                      : make_float2(0.f, 0.f);
    qa[kc] = split_a(u[0].x, u[1].x, u[0].y, u[1].y);
  }
  const float sl2 = scale * kLog2e;
  float bw[8][4];  // g = 64: rel_w log2(e) of the thread's columns
  if (G64)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* w = rel_w + rel0 + (size_t)(ra + 8 * hf) * 64 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(w + 8 * j));
        bw[j][2 * hf] = u.x * kLog2e;
        bw[j][2 * hf + 1] = u.y * kLog2e;
      }
    }

  float m[2] = {kNegInit, kNegInit}, l[2] = {0.f, 0.f}, acc[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;

  const int n_tiles = (S + kR - 1) / kR;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * kR;
    const float* ks = sm + 2 * st * T;
    const float* vs = ks + T;
    cp_wait_all();
    __syncthreads();  // tile kt has landed; tile kt - 1's stage is free
    if (kt + 1 < n_tiles) {
      load_tile<HD>(sm + 2 * (st ^ 1) * T, k + base, k0 + kR, S);
      load_tile<HD>(sm + 2 * (st ^ 1) * T + T, v + base, k0 + kR, S);
      cp_commit();
    }
    float rh2[2] = {0.f, 0.f};
    if (G64)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        rh2[hf] = __ldg(rel_h + rel0 + (size_t)(ra + 8 * hf) * 64 + kt) *
                  kLog2e;

    // S = Q K^T (n-tile j: keys k0 + 8j .. k0 + 8j + 7)
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NC; ++kc)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mma3(s[j], qa[kc], b_row<HD>(ks, 8 * j + gq, 8 * kc + 2 * tq));

    // the logits in the log2 domain; -inf past S
    float mx[2] = {kNegInit, kNegInit};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hf = i >> 1;
        float t;
        if (G64) {
          t = fmaf(s[j][i], sl2, bw[j][i] + rh2[hf]);
        } else {
          const int key = k0 + 8 * j + 2 * tq + (i & 1);
          t = -CUDART_INF_F;
          if (key < S && rok[hf]) {
            const int kh = key / g, kw = key - kh * g;
            const size_t row = rel0 + (size_t)(ra + 8 * hf) * g;
            const float bias =
                __ldg(rel_h + row + kh) + __ldg(rel_w + row + kw);
            t = fmaf(s[j][i], sl2, bias * kLog2e);
          }
        }
        s[j][i] = t;
        mx[hf] = fmaxf(mx[hf], t);
      }
    float alpha[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 1));
      mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(kFull, mx[hf], 2));
      const float m_new = fmaxf(m[hf], mx[hf]);
      alpha[hf] = exp2f(m[hf] - m_new);
      m[hf] = m_new;
    }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = exp2f(s[j][i] - m[i >> 1]);
        s[j][i] = p;
        sum[i >> 1] += p;
      }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l[hf] = fmaf(l[hf], alpha[hf], sum[hf]);

    // acc = alpha acc + P V, the tile's product summed from zero
    float pv[NC][4];
    tile_product<HD>(pv, s, vs, gq, tq);
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[n][i] = fmaf(acc[n][i], alpha[i >> 1], pv[n][i]);
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    float lr = l[hf];  // the row's sum: the quad's four parts
    lr += __shfl_xor_sync(kFull, lr, 1);
    lr += __shfl_xor_sync(kFull, lr, 2);
    if (!rok[hf]) continue;
    const int r = q0 + ra + 8 * hf;
    float* o = out + base + (size_t)r * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * hf] / lr, acc[n][2 * hf + 1] / lr);
    // the training forward's natural logsumexp, m ln 2 + log(l)
    if (lse != nullptr && tq == 0)
      lse[(size_t)hh * S + r] = fmaf(m[hf], kLn2, logf(lr));
  }
}

template <int HD, bool G64>
int launch(const void* q, const void* k, const void* v, const void* rh,
           const void* rw, void* out, float* lse, int bnh, int S, int g,
           float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  auto kern = flash_fwd_tf32x3<HD, G64>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kR - 1) / kR, bnh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rh),
      static_cast<const float*>(rw), static_cast<float*>(out), lse, S, g,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// the bfloat16 route: the tensor-core kernel, flash_relpos_fwd_tc.cu
extern "C" int cartseg_flash_relpos_fwd_tc(const void* q, const void* k,
                                           const void* v, const void* rel_h,
                                           const void* rel_w, void* out,
                                           void* lse, int bnh, int S, int g,
                                           int hd, float scale, void* stream);

// q, k, v, out: [bnh, S, hd]; rel_h, rel_w: [bnh, S, g]; all contiguous and
// 16-byte aligned, of one type: float32 (bf16 == 0, this file's split-TF32
// kernel) or bfloat16 (bf16 == 1: flash_relpos_fwd_tc.cu). S == g*g.
// lse: null (inference: nothing written) or fp32 [bnh, S], the rows'
// logsumexp for the backward.
extern "C" int cartseg_flash_relpos_fwd(const void* q, const void* k,
                                        const void* v, const void* rel_h,
                                        const void* rel_w, void* out,
                                        void* lse, int bnh, int S, int g,
                                        int hd, int bf16, float scale,
                                        void* stream) {
  if (bf16)
    return cartseg_flash_relpos_fwd_tc(q, k, v, rel_h, rel_w, out, lse, bnh,
                                       S, g, hd, scale, stream);
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  cudaStream_t st = (cudaStream_t)stream;
  float* l = static_cast<float*>(lse);
#define CARTSEG_FWD_ARGS q, k, v, rel_h, rel_w, out, l, bnh, S, g, scale, st
  if (hd == 64 && g == 64) return launch<64, true>(CARTSEG_FWD_ARGS);
  if (hd == 64) return launch<64, false>(CARTSEG_FWD_ARGS);
  if (hd == 32 && g == 64) return launch<32, true>(CARTSEG_FWD_ARGS);
  if (hd == 32) return launch<32, false>(CARTSEG_FWD_ARGS);
#undef CARTSEG_FWD_ARGS
  return (int)cudaErrorInvalidValue;
}
