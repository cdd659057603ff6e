// Flash attention with SAM's decomposed relative-position bias, backward,
// bfloat16, on Hopper's tensor cores.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (cartseg_tpu/ops/pallas/flash_attention.py:179 and :232, pallas_calls at
// :290 and :318) for bfloat16 inputs; flash_relpos_bwd.cu keeps the
// float32 route on the CUDA cores and hands every bf16 call to the C entry
// points at the end of this file. The function is the same (Dao et al.'s
// recompute form, with lse from the forward and D = rowsum(dO * O)):
//   P  = exp(scale * q k^T + bias - lse),  dS = P * (dO v^T - D)
//   flash_bwd_dq_tc:  dq = scale * dS K,
//                     drel_h[i, kh] = sum_kw dS[i, kh*g+kw],
//                     drel_w[i, kw] = sum_kh dS[i, kh*g+kw]
//   flash_bwd_dkv_tc: dv = P^T dO,  dk = scale * dS^T Q
// Neither P nor dS is written to device memory.
//
// Design
// - One warpgroup (128 threads) a block, which owns one 64-row tile: the
//   block's 64 query rows in dq, its 64 keys in dkv. The products are
//   wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate:
//     first products, both operands K-major from shared memory (m64n64,
//     HD/16 k-steps): dq S = Q K^T and dP = dO V^T; dkv S^T = K Q^T and
//     dP^T = V dO^T;
//     second products, A from registers (the first products' accumulators
//     turned into fp32 P and dS in place, then packed to bf16), B MN-major
//     (the transpose bit) from shared memory (m64nHD, 4 k-steps): dq
//     dQ += dS K; dkv dV += P^T dO and dK += dS^T Q.
//   The second products of tile t are waited for after the first products
//   of tile t + 1 are issued, so the tensor cores run them back to back.
//   The block's resident operands stay in shared memory: as register A
//   fragments of the first products they were no faster, and at HD 64 the
//   compiler gave the second products' A fragments the same registers.
// - Tiles stay bf16 in shared memory as [64][HD] rows, their 16-byte
//   chunks in wgmma's 128-byte (HD 64) or 64-byte (HD 32) swizzle, so one
//   tile is a K-major operand of the first products and an MN-major one of
//   the second. What a block streams (K and V in dq; Q, dO, the rows' bias
//   factors, lse and D in dkv) goes through a 2-stage ring of cp.async
//   copies: tile t + 1 is copied while tile t is multiplied.
// - P, dS and the rest of the elementwise work are fp32 in registers, in
//   the accumulators' fragment layout. exp is exp2f with log2(e) folded
//   into the scale, the bias and lse: P = 2^(s*scale*log2e + bias*log2e -
//   lse*log2e). Rounding the three terms instead of their sum moves P by
//   about (|scale s| + |bias| + |lse|) * 2^-24 relative: a few fp32 ulps
//   at SAM's logits, against the 2^-9 of the bf16 rounding that follows.
// - Rounding points, as FlashAttention-2/3 and SDPA's bf16 backward: P and
//   dS are rounded to bf16 once each, as the second products' A operands;
//   every sum stays fp32; each output is rounded to bf16 once. drel_h and
//   drel_w are summed from the fp32 dS.
// - drel in dq: at g = 64 (SAM at 1024^2, S = 4096, no ragged edge) a
//   64-key tile is exactly grid row kh, so its drel_h[:, kh] is a row sum
//   of dS (the thread's 16 columns, then two quad shuffles) and drel_w is
//   dS itself, summed over the tiles in registers. Any other g stages each
//   tile's fp32 dS in shared memory and sums it as flash_relpos_bwd.cu
//   does: one owner per accumulator, a fixed order of additions.
// Every output element has one writer and there are no atomics, so a
// second run gives the same bits. Keys and queries past S give P = 0.
//
// Bound on this card: operations. At [12,4096,64] one product is
// 2*12*4096^2*64 = 25.8 GFLOP; dq does 3 and dkv 4: 0.078 and 0.104 ms at
// 989 TFLOP/s dense bf16 (chip_smoke.bwd_bound), against ~0.02 ms of
// device-memory traffic. Beside the tensor cores, each kernel does for
// every logit one exp2 on the SFUs (2.0e8 a kernel at that shape, 16 a
// clock on an SM), the bias lookup and adds, the dS multiply and the bf16
// packing on the FP32 pipes, and dq the drel sums.
// Resources at SAM's shape (HD 64, g 64), ptxas -v on sm_90a: dq 212
// registers and 82 KB of shared memory a block (Q, dO, 2 stages of K and
// V, the block's rel_h and rel_w rows, the drel_h sums), dkv 194 and 83
// KB (K, V, 2 stages of Q, dO, the rows' rel_h and rel_w, lse and D); no
// spills. Both fit 2 blocks (8 warps) an SM, which overlap one block's
// elementwise work with the other's products. At g = 128 (MAX_GRID) dq
// takes 164 KB and dkv 115 KB: one block an SM.

#include "flash_tc_common.cuh"

namespace {

using namespace flash_tc;

constexpr int kDst = kR + 4;  // row stride of the staged fp32 dS tile

// row stride of the fp32 [64, g] drel accumulators
__host__ __device__ __forceinline__ int acc_stride(int g) {
  return g + (12 - g % 8) % 8;
}
constexpr uint32_t kRowVecBytes = kR * 4 + 16;  // a span of 64 lse or D

// -------------------------------------------------------------------- dq

// shared memory: Q, dO, 2 stages of K and V, the block's rel_h and rel_w
// rows, the drel_h sums, and for g != 64 the drel_w sums and the staged dS
template <int HD>
__host__ __device__ __forceinline__ uint32_t dq_smem_bytes(int g, bool g64) {
  const uint32_t acc = 64u * acc_stride(g) * 4;
  return 6 * Tile<HD>::kBytes + 2 * rel_bytes(g) + acc +
         (g64 ? 0 : acc + kR * kDst * 4) + 1024;
}

template <int HD, bool G64>
__global__ void __launch_bounds__(kWG, 2)
flash_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const bf16* __restrict__ rel_h,
                const bf16* __restrict__ rel_w, const bf16* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq,
                bf16* __restrict__ drel_h, bf16* __restrict__ drel_w, int S,
                int g, float scale) {
  constexpr uint32_t T = Tile<HD>::kBytes;
  constexpr int ND = HD / 2;  // dQ accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s0 = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (s0 - raw);
  const int AST = acc_stride(g);
  const uint32_t o_rh = 6 * T, o_rw = o_rh + rel_bytes(g);
  const uint32_t o_gh = o_rw + rel_bytes(g), o_gw = o_gh + 64 * AST * 4;
  const uint32_t o_ds = o_gw + 64 * AST * 4;
  float* ghs = reinterpret_cast<float*>(sm + o_gh);
  float* gws = reinterpret_cast<float*>(sm + o_gw);
  float* dss = reinterpret_cast<float*>(sm + o_ds);

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
  load_tile<HD>(s0 + T, dout + base, q0, S);
  load_span<2>(s0 + o_rh, rel_h, rel0, kR * g, rel_total);
  load_span<2>(s0 + o_rw, rel_w, rel0, kR * g, rel_total);
  load_tile<HD>(s0 + 2 * T, k + base, 0, S);
  load_tile<HD>(s0 + 4 * T, v + base, 0, S);
  cp_commit();
  if (!G64)
    for (int e = tid; e < kR * AST; e += kWG) ghs[e] = gws[e] = 0.f;

  float lse2[2], dd[2];
  bool rok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = q0 + ra + 8 * hf;
    rok[hf] = r < S;
    lse2[hf] = rok[hf] ? lse[(size_t)hh * S + r] * kLog2e : 0.f;
    dd[hf] = rok[hf] ? delta[(size_t)hh * S + r] : 0.f;
  }
  const float sl2 = scale * kLog2e;
  float acc[ND], bw[32], gw[32];
#pragma unroll
  for (int i = 0; i < ND; ++i) acc[i] = 0.f;

  cp_wait_all();
  __syncthreads();
  uint32_t a[4][4] = {};  // dS as the A operand of dQ += dS K
  if (G64) {
    // the tile's columns are kw: rel_w*log2e - lse, fixed for the block
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * hf + e;
          bw[i] = __bfloat162float(rws[(ra + 8 * hf) * 64 + 8 * n + cq + e])
                  * kLog2e - lse2[hf];
          gw[i] = 0.f;
        }
  }

  const int n_tiles = (S + kR - 1) / kR;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * kR;
    const uint32_t ks = s0 + (2 + st) * T, vs = s0 + (4 + st) * T;
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile kt has landed

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<HD>(s0, kk), desc_k<HD>(ks, kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<HD>(s0 + T, kk), desc_k<HD>(vs, kk), kk);
    wg_commit();
    // dQ += dS K of tile kt - 1 is done with its registers and its stage,
    // which the copy of tile kt + 1 takes over
    wg_wait<1>();
    fence_regs(a);
    __syncthreads();
    if (kt + 1 < n_tiles) {
      load_tile<HD>(s0 + (2 + (st ^ 1)) * T, k + base, k0 + kR, S);
      load_tile<HD>(s0 + (4 + (st ^ 1)) * T, v + base, k0 + kR, S);
      cp_commit();
    }
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P and dS, in place of s
    if (G64) {
      float rh2[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        rh2[hf] = __bfloat162float(rhs[(ra + 8 * hf) * 64 + kt]) * kLog2e;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n + 2 * hf + e;
            const float p = exp2f(fmaf(s[i], sl2, bw[i] + rh2[hf]));
            s[i] = p * (dp[i] - dd[hf]);
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
            const float x = fmaf(s[i], sl2, fmaf(bias, kLog2e, -lse2[hf]));
            const float p = (kok && rok[hf]) ? exp2f(x) : 0.f;
            s[i] = p * (dp[i] - dd[hf]);
          }
        }
    }

    // dQ += dS K, issued before the drel sums, which it overlaps
    to_a(s, a);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn<HD>(acc, a[kk], desc_mn<HD>(ks, kk));
    wg_commit();  // waited for in the next iteration

    if (G64) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * n + 2 * hf + e;
            sum += s[i];
            gw[i] += s[i];
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        if ((lane & 3) == 0) ghs[(ra + 8 * hf) * AST + kt] = sum;
      }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            dss[(ra + 8 * hf) * kDst + 8 * n + cq + e] = s[4 * n + 2 * hf + e];
      __syncthreads();
      // thread (row dr, part): drel_h[dr, kh] += the run of the tile's keys
      // on grid row kh, split over the row's 2 threads and joined by a
      // shuffle; drel_w[dr, w] += the tile's keys j with (k0 + j) % g == w
      // for the thread's w = part, part + 2, ...
      const int dr = tid >> 1, part = tid & 1;
      const int nk = min(kR, S - k0);
      const int kh_lo = k0 / g, kh_hi = (k0 + nk - 1) / g;
      for (int h = kh_lo; h <= kh_hi; ++h) {
        const int j_lo = max(h * g - k0, 0), j_hi = min((h + 1) * g - k0, nk);
        float sum = 0.f;
        for (int j = j_lo + part; j < j_hi; j += 2) sum += dss[dr * kDst + j];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        if (part == 0) ghs[dr * AST + h] += sum;
      }
      int j0 = ((part - k0) % g + g) % g;
      for (int w = part; w < g; w += 2) {
        float sum = 0.f;
        for (int j = j0; j < nk; j += g) sum += dss[dr * kDst + j];
        gws[dr * AST + w] += sum;
        j0 += 2;
        if (j0 >= g) j0 -= g;
      }
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  __syncthreads();  // every drel_h sum is in shared memory

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = ra + 8 * hf;
    if (!rok[hf]) continue;
    bf16* o = dq + base + (size_t)(q0 + r) * HD + cq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      store2(o + 8 * n, acc[4 * n + 2 * hf] * scale,
             acc[4 * n + 2 * hf + 1] * scale);
    if (G64) {
      bf16* w = drel_w + rel0 + (size_t)r * 64 + cq;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        store2(w + 8 * n, gw[4 * n + 2 * hf], gw[4 * n + 2 * hf + 1]);
    }
  }
  for (int e = tid; e < kR * g; e += kWG) {
    const int r = e / g, c = e - r * g;
    if (q0 + r >= S) continue;
    drel_h[rel0 + e] = __float2bfloat16(ghs[r * AST + c]);
    if (!G64) drel_w[rel0 + e] = __float2bfloat16(gws[r * AST + c]);
  }
}

// ------------------------------------------------------------------- dkv

// shared memory: K, V, then 2 stages of Q, dO, the tile rows' rel_h and
// rel_w, lse and D, each stage 1024-byte aligned
template <int HD>
__host__ __device__ __forceinline__ uint32_t dkv_stage_bytes(int g) {
  return (2 * Tile<HD>::kBytes + 2 * rel_bytes(g) + 2 * kRowVecBytes + 1023)
         & ~1023u;
}
template <int HD>
__host__ __device__ __forceinline__ uint32_t dkv_smem_bytes(int g) {
  return 2 * Tile<HD>::kBytes + 2 * dkv_stage_bytes<HD>(g) + 1024;
}

// one stage of dkv's stream: the query tile q0's Q and dO rows, their
// rel_h and rel_w rows, lse and D
template <int HD, bool G64>
__device__ __forceinline__ void dkv_load_stage(
    uint32_t st, const bf16* q, const bf16* dout, const bf16* rel_h,
    const bf16* rel_w, const float* lse, const float* delta, int hh, int q0,
    int S, int g, int bnh) {
  constexpr uint32_t T = Tile<HD>::kBytes;
  const size_t base = (size_t)hh * S * HD;
  const size_t rel0 = ((size_t)hh * S + q0) * g;
  const size_t row0 = (size_t)hh * S + q0;
  load_tile<HD>(st, q + base, q0, S);
  load_tile<HD>(st + T, dout + base, q0, S);
  if (G64) {
    // S = 4096: every span is whole and 16-byte aligned
    load_chunks<kR * 64 * 2 / 16>(st + 2 * T, rel_h + rel0);
    load_chunks<kR * 64 * 2 / 16>(st + 2 * T + rel_bytes(64), rel_w + rel0);
    load_chunks<kR * 4 / 16>(st + 2 * T + 2 * rel_bytes(64), lse + row0);
    load_chunks<kR * 4 / 16>(st + 2 * T + 2 * rel_bytes(64) + kRowVecBytes,
                             delta + row0);
    return;
  }
  load_span<2>(st + 2 * T, rel_h, rel0, kR * g, (size_t)bnh * S * g);
  load_span<2>(st + 2 * T + rel_bytes(g), rel_w, rel0, kR * g,
               (size_t)bnh * S * g);
  load_span<4>(st + 2 * T + 2 * rel_bytes(g), lse, row0, kR,
               (size_t)bnh * S);
  load_span<4>(st + 2 * T + 2 * rel_bytes(g) + kRowVecBytes, delta, row0,
               kR, (size_t)bnh * S);
}

template <int HD, bool G64>
__global__ void __launch_bounds__(kWG, 2)
flash_bwd_dkv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ rel_h,
                 const bf16* __restrict__ rel_w,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk,
                 bf16* __restrict__ dv, int S, int g, float scale) {
  constexpr uint32_t T = Tile<HD>::kBytes;
  constexpr int ND = HD / 2;  // dK and dV accumulators a thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t s0 = (raw + 1023) & ~1023u;
  unsigned char* sm = smem_raw + (s0 - raw);
  const uint32_t stb = dkv_stage_bytes<HD>(g);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ra = 16 * warp + (lane >> 2), cq = 2 * (lane & 3);
  const int k0 = blockIdx.x * kR, hh = blockIdx.y, bnh = gridDim.y;
  const size_t base = (size_t)hh * S * HD;

  load_tile<HD>(s0, k + base, k0, S);
  load_tile<HD>(s0 + T, v + base, k0, S);
  dkv_load_stage<HD, G64>(s0 + 2 * T, q, dout, rel_h, rel_w, lse, delta, hh,
                          0, S, g, bnh);
  cp_commit();

  // the thread's keys k0 + ra + 8 hf: grid row and column, and < S
  int kh[2], kw[2];
  bool kok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int key = k0 + ra + 8 * hf;
    kok[hf] = key < S;
    kh[hf] = kok[hf] ? key / g : 0;
    kw[hf] = kok[hf] ? key - kh[hf] * g : 0;
  }
  const float sl2 = scale * kLog2e;
  float gk[ND], gv[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) gk[i] = gv[i] = 0.f;

  uint32_t pa[4][4] = {}, da[4][4] = {};  // P^T and dS^T as A operands

  const int n_tiles = (S + kR - 1) / kR;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int st = qt & 1, q0 = qt * kR;
    const uint32_t qs = s0 + 2 * T + st * stb, dos = qs + T;
    cp_wait_all();
    fence_async_smem();
    __syncthreads();  // tile qt has landed

    float s[32], dp[32];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(s, desc_k<HD>(s0, kk), desc_k<HD>(qs, kk), kk);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss_n64(dp, desc_k<HD>(s0 + T, kk), desc_k<HD>(dos, kk), kk);
    wg_commit();
    // dV and dK of tile qt - 1 are done with their registers and its
    // stage, which the copy of tile qt + 1 takes over
    wg_wait<1>();
    fence_regs(pa);
    fence_regs(da);
    __syncthreads();
    if (qt + 1 < n_tiles) {
      dkv_load_stage<HD, G64>(s0 + 2 * T + (st ^ 1) * stb, q, dout, rel_h,
                              rel_w, lse, delta, hh, q0 + kR, S, g, bnh);
      cp_commit();
    }
    const unsigned char* sp = sm + 2 * T + st * stb;
    const int rsh = span_shift<2>(((size_t)hh * S + q0) * g);
    const int lsh = span_shift<4>((size_t)hh * S + q0);
    const bf16* rhs = reinterpret_cast<const bf16*>(sp + 2 * T) + rsh;
    const bf16* rws =
        reinterpret_cast<const bf16*>(sp + 2 * T + rel_bytes(g)) + rsh;
    const float* lses =
        reinterpret_cast<const float*>(sp + 2 * T + 2 * rel_bytes(g)) + lsh;
    const float* dds = reinterpret_cast<const float*>(
                           sp + 2 * T + 2 * rel_bytes(g) + kRowVecBytes) + lsh;
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T in place of s, dS^T in place of dp
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + cq + e;
        const float d = dds[c];
        if (G64) {
          // the block's keys share grid row kh: rel_h joins lse
          const float l2 = (lses[c] - __bfloat162float(rhs[c * 64 + kh[0]]))
                           * kLog2e;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 4 * n + 2 * hf + e;
            const float rw = __bfloat162float(rws[c * 64 + kw[hf]]);
            const float p = exp2f(fmaf(s[i], sl2, fmaf(rw, kLog2e, -l2)));
            s[i] = p;
            dp[i] = p * (dp[i] - d);
          }
        } else {
          const bool qok = q0 + c < S;
          const float l2 = lses[c] * kLog2e;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 4 * n + 2 * hf + e;
            const float bias = __bfloat162float(rhs[c * g + kh[hf]]) +
                               __bfloat162float(rws[c * g + kw[hf]]);
            const float x = fmaf(s[i], sl2, fmaf(bias, kLog2e, -l2));
            const float p = (qok && kok[hf]) ? exp2f(x) : 0.f;
            s[i] = p;
            dp[i] = p * (dp[i] - d);
          }
        }
      }

    to_a(s, pa);
    to_a(dp, da);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn<HD>(gv, pa[kk], desc_mn<HD>(dos, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_mn<HD>(gk, da[kk], desc_mn<HD>(qs, kk));
    wg_commit();  // waited for in the next iteration
  }
  wg_wait<0>();
  fence_regs(gv);
  fence_regs(gk);

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!kok[hf]) continue;
    const size_t off = base + (size_t)(k0 + ra + 8 * hf) * HD + cq;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int i = 4 * n + 2 * hf;
      store2(dk + off + 8 * n, gk[i] * scale, gk[i + 1] * scale);
      store2(dv + off + 8 * n, gv[i], gv[i + 1]);
    }
  }
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int HD, bool G64>
int launch_dq(const void* q, const void* k, const void* v, const void* rel_h,
              const void* rel_w, const void* dout, const void* lse,
              const void* delta, void* dq, void* drel_h, void* drel_w,
              int bnh, int S, int g, float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dq_tc<HD, G64>;
  const size_t smem = dq_smem_bytes<HD>(g, G64);
  const int err = set_smem(kern, smem);
  if (err) return err;
  kern<<<dim3((S + kR - 1) / kR, bnh), kWG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<bf16*>(drel_h),
      static_cast<bf16*>(drel_w), S, g, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool G64>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bnh, int S, int g, float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_tc<HD, G64>;
  const size_t smem = dkv_smem_bytes<HD>(g);
  const int err = set_smem(kern, smem);
  if (err) return err;
  kern<<<dim3((S + kR - 1) / kR, bnh), kWG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(rel_h),
      static_cast<const bf16*>(rel_w), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// bfloat16 q, k, v, dout [bnh, S, hd] and rel_h, rel_w [bnh, S, g], all
// contiguous and 16-byte aligned, S == g*g, hd 32 or 64; fp32 lse, delta
// [bnh, S]. Writes dq [bnh, S, hd] and drel_h, drel_w [bnh, S, g] in bf16.
extern "C" int cartseg_flash_relpos_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dq, void* drel_h, void* drel_w, int bnh, int S, int g, int hd,
    float scale, void* stream) {
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
#define CARTSEG_DQ_ARGS                                                    \
  q, k, v, rel_h, rel_w, dout, lse, delta, dq, drel_h, drel_w, bnh, S, g, \
      scale, st
  if (hd == 64 && g == 64) return launch_dq<64, true>(CARTSEG_DQ_ARGS);
  if (hd == 64) return launch_dq<64, false>(CARTSEG_DQ_ARGS);
  if (hd == 32 && g == 64) return launch_dq<32, true>(CARTSEG_DQ_ARGS);
  if (hd == 32) return launch_dq<32, false>(CARTSEG_DQ_ARGS);
#undef CARTSEG_DQ_ARGS
  return (int)cudaErrorInvalidValue;
}

// The same inputs; writes dk and dv [bnh, S, hd] in bf16.
extern "C" int cartseg_flash_relpos_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, int bnh, int S, int g, int hd, float scale,
    void* stream) {
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
#define CARTSEG_DKV_ARGS \
  q, k, v, rel_h, rel_w, dout, lse, delta, dk, dv, bnh, S, g, scale, st
  if (hd == 64 && g == 64) return launch_dkv<64, true>(CARTSEG_DKV_ARGS);
  if (hd == 64) return launch_dkv<64, false>(CARTSEG_DKV_ARGS);
  if (hd == 32 && g == 64) return launch_dkv<32, true>(CARTSEG_DKV_ARGS);
  if (hd == 32) return launch_dkv<32, false>(CARTSEG_DKV_ARGS);
#undef CARTSEG_DKV_ARGS
  return (int)cudaErrorInvalidValue;
}
