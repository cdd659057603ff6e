// Flash attention with SAM's decomposed relative-position bias, backward,
// on Hopper.
//
// Replaces the TPU kernels `_bwd_dq_kernel` and `_bwd_dkv_kernel`
// (cartseg_tpu/ops/pallas/flash_attention.py:179 and :232, pallas_calls at
// :290 and :318), in Dao et al.'s recompute form. With lse the forward's
// per-row logsumexp (flash_relpos.cu) and D = rowsum(dO * O), which the
// wrapper computes:
//   P  = exp(scale * q k^T + bias - lse),  bias[i, kh*g+kw] = rel_h[i,kh]
//                                                            + rel_w[i,kw]
//   dS = P * (dO v^T - D)
//   flash_bwd_dq:  dq = scale * dS K,
//                  drel_h[i, kh] = sum_kw dS[i, kh*g+kw],
//                  drel_w[i, kw] = sum_kh dS[i, kh*g+kw]
//   flash_bwd_dkv: dv = P^T dO,  dk = scale * dS^T Q
// Neither P nor dS ((S, S) each) is written to device memory: each kernel
// rebuilds its 64x64 tiles of them from Q, K, V, dO and the bias factors.
//
// Two routes, chosen by the inputs' type in the C entry points below:
// - float32, this file: the exactness lane, on the tensor cores as split
//   TF32 ("3xTF32") products (`flash_bwd_dq_tf32x3`,
//   `flash_bwd_dkv_tf32x3`); P, dS, the softmax and every sum in fp32,
//   outputs in fp32.
// - bfloat16: flash_relpos_bwd_tc.cu, wgmma on the tensor cores, P and dS
//   rounded to bf16 as the second products' operands.
//
// Split TF32 (flash_tf32x3_common.cuh, shared with the forward): one TF32
// product keeps 10 of fp32's 23 mantissa bits and would move the gradients
// ~1e-3 from the plain version, so each fp32 operand x is cut into hi =
// tf32(x) and lo = tf32(x - hi) and a product is hi lo + lo hi + hi hi on
// mma.sync m16n8k8 tf32 (CUTLASS's OpMultiplyAddFastF32, which PyTorch's
// fp32 memory-efficient attention runs too).
// tests/test_torch_flash_bwd_tf32x3.py emulates this arithmetic on the CPU
// against the plain version and JAX.
//
// Design
// - 128 threads (4 warps) a block; the block owns one 64-row tile (its
//   query rows in dq, its keys in dkv), and warp w its rows 16w..16w+15.
//   Every product is the warp's m16n8k8 tiles: the first products over
//   head_dim (dq: S = Q K^T, dP = dO V^T; dkv: S^T = K Q^T, dP^T = V dO^T)
//   give each warp 16 rows x 64 columns in the accumulators' fragment
//   layout, where P and dS are made in place in fp32; the second products
//   (dq: dQ += dS K; dkv: dV += P^T dO, dK += dS^T Q) take those
//   accumulators as their A operands without moving them between
//   threads: the k index of an m16n8k8 A fragment is read as columns
//   (2t, 2t + 1), the accumulator's pair, and B is gathered with the same
//   order. The first products read head_dim in the same pairs, so every
//   fragment read of the first products is one 8-byte load.
// - Tiles stay fp32 in shared memory ([64][HD + 8], column blocks of 8
//   swapped in rows with bit 2 set), free of bank conflicts both ways they
//   are read; operands are split into hi and lo in registers where they
//   are read. What a block streams (K and V in dq; Q, dO and the rows'
//   lse, D and rel_h in dkv) goes through a 2-stage ring of cp.async
//   copies: tile t + 1 is copied while tile t is multiplied.
// - Two blocks (8 warps) an SM at SAM's shape: dq's Q, dO and two stages
//   of K and V take 108 KB, dkv's K, V and two stages of Q, dO and the
//   rows 110 KB. Where a stage of the [64, g] bias factors would not fit
//   beside that, the factors come from device memory (L1 and L2) into
//   registers: in dq at g = 64 the block's rel_w columns once (with -lse,
//   fixed for the block) and one rel_h value a row and tile; in dkv at
//   g = 64 each tile's rel_w[query, kw], loaded at the top of the tile,
//   ahead of the products that hide its latency. Any other g reads both
//   factors there for each logit.
// - drel in dq: at g = 64 (SAM at 1024^2, S = 4096, no ragged edge) a
//   64-key tile is exactly grid row kh, so its drel_h[:, kh] is a row sum
//   of dS (the thread's 16 columns, then two quad shuffles), written by one
//   lane, and drel_w is dS itself, summed over the tiles in registers of
//   the fragment's layout. Any other g stages each tile's dS in shared
//   memory and sums it into [64, g] accumulators there: one owner per
//   accumulator, a fixed order of additions.
// Every output element has one writer and there are no atomics, so a
// second run gives the same bits. Keys and queries past S give P = 0.
//
// Bound on this card: operations. At [12,4096,64] one product is
// 2*12*4096^2*64 = 25.8 GFLOP; dq does 3 and dkv 4. Each takes 3 TF32
// products: 0.4685 and 0.6247 ms at 495 TFLOP/s dense TF32
// (chip_smoke.bwd_bound); one fp32 product each at the 67 TFLOP/s CUDA-core
// peak would take 1.15 and 1.54 ms. Beside the tensor cores each kernel
// spends, for every operand value it reads, two roundings and a subtract
// on the integer and FP32 pipes, and for every logit an exp2 on the SFUs.

#include <stdint.h>

#include "flash_tf32x3_common.cuh"

namespace {

using namespace flash_tf32x3;

constexpr int kDst = kR + 4;   // row stride of the staged fp32 dS tile

// row stride of the fp32 [64, g] drel accumulators
__host__ __device__ __forceinline__ int acc_stride(int g) {
  return g + (12 - g % 8) % 8;
}

// one float to shared memory, or a zero
__device__ __forceinline__ void cp4(uint32_t dst, const float* src,
                                    bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// The first products over head_dim: s = A B^T and p = C D^T for the
// warp's rows ra, ra + 8 of the resident tiles A and C and the 64 rows of
// the streamed tiles B and D (n-tile j: rows 8j + g).
template <int HD>
__device__ __forceinline__ void first_products(float (&s)[8][4],
                                               float (&p)[8][4],
                                               const float* a,
                                               const float* b,
                                               const float* c,
                                               const float* d, int ra,
                                               int gq, int tq) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) s[j][i] = p[j][i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < HD / 8; ++kc) {
    const int col = 8 * kc + 2 * tq;
    const FragA fa = a_rows<HD>(a, ra, col), fc = a_rows<HD>(c, ra, col);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mma3(s[j], fa, b_row<HD>(b, 8 * j + gq, col));
      mma3(p[j], fc, b_row<HD>(d, 8 * j + gq, col));
    }
  }
}

// A second product: acc (the warp's 16 rows x HD) += x (its 16 x 64
// accumulator tile) . y (a [64][HD] tile), the tile's product summed from
// zero and added on the FP32 pipes
template <int HD>
__device__ __forceinline__ void second_product(float (&acc)[HD / 8][4],
                                               const float (&x)[8][4],
                                               const float* y, int gq,
                                               int tq) {
  float t[HD / 8][4];
  tile_product<HD>(t, x, y, gq, tq);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] += t[n][i];
}

// -------------------------------------------------------------------- dq

// shared memory: Q, dO, 2 stages of K and V; for g != 64 also the drel_h
// and drel_w sums and the staged dS
template <int HD>
size_t dq_smem_bytes(int g, bool g64) {
  size_t f = 6 * (size_t)Tile<HD>::kFloats;
  if (!g64) f += 2 * (size_t)kR * acc_stride(g) + (size_t)kR * kDst;
  return 4 * f;
}

template <int HD, bool G64>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ rel_h,
                    const float* __restrict__ rel_w,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    float* __restrict__ drel_h, float* __restrict__ drel_w,
                    int S, int g, float scale) {
  constexpr int T = Tile<HD>::kFloats, NC = HD / 8;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float* qs = sm;        // the block's query rows
  const float* dos = sm + T;   // their dO rows
  const int AST = acc_stride(g);
  float* ghs = sm + 6 * T;     // g != 64: [64][AST] drel_h sums
  float* gws = ghs + kR * AST;  //          [64][AST] drel_w sums
  float* dss = gws + kR * AST;  //          [64][kDst] a tile's dS

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 16 * warp + gq;  // the thread's rows ra and ra + 8
  const int q0 = blockIdx.x * kR, hh = blockIdx.y;
  const size_t base = (size_t)hh * S * HD;
  const size_t rel0 = ((size_t)hh * S + q0) * g;

  load_tile<HD>(sm, q + base, q0, S);
  load_tile<HD>(sm + T, dout + base, q0, S);
  load_tile<HD>(sm + 2 * T, k + base, 0, S);
  load_tile<HD>(sm + 4 * T, v + base, 0, S);
  cp_commit();
  if (!G64)
    for (int e = tid; e < kR * AST; e += kThreads) ghs[e] = gws[e] = 0.f;

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
  float acc[NC][4], bw[8][4], gw[8][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  if (G64) {
    // a tile's columns are kw: rel_w log2e - lse log2e, fixed for the block
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float* w = rel_w + rel0 + (size_t)(ra + 8 * hf) * 64 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 u = __ldg(reinterpret_cast<const float2*>(w + 8 * j));
        bw[j][2 * hf] = u.x * kLog2e - lse2[hf];
        bw[j][2 * hf + 1] = u.y * kLog2e - lse2[hf];
        gw[j][2 * hf] = gw[j][2 * hf + 1] = 0.f;
      }
    }
  }

  const int n_tiles = (S + kR - 1) / kR;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int st = kt & 1, k0 = kt * kR;
    const float* ks = sm + (2 + st) * T;
    const float* vs = sm + (4 + st) * T;
    cp_wait_all();
    __syncthreads();  // tile kt has landed; tile kt - 1's stage is free
    if (kt + 1 < n_tiles) {
      load_tile<HD>(sm + (2 + (st ^ 1)) * T, k + base, k0 + kR, S);
      load_tile<HD>(sm + (4 + (st ^ 1)) * T, v + base, k0 + kR, S);
      cp_commit();
    }
    float rh2[2] = {0.f, 0.f};
    if (G64)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        rh2[hf] = __ldg(rel_h + rel0 + (size_t)(ra + 8 * hf) * 64 + kt) *
                  kLog2e;

    float s[8][4], dp[8][4];
    first_products<HD>(s, dp, qs, ks, dos, vs, ra, gq, tq);

    // P and dS, in place of s; 0 past S
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hf = i >> 1;
        float p;
        if (G64) {
          p = exp2f(fmaf(s[j][i], sl2, bw[j][i] + rh2[hf]));
        } else {
          const int key = k0 + 8 * j + 2 * tq + (i & 1);
          p = 0.f;
          if (key < S && rok[hf]) {
            const int kh = key / g, kw = key - kh * g;
            const size_t row = rel0 + (size_t)(ra + 8 * hf) * g;
            const float bias =
                __ldg(rel_h + row + kh) + __ldg(rel_w + row + kw);
            p = exp2f(fmaf(s[j][i], sl2, fmaf(bias, kLog2e, -lse2[hf])));
          }
        }
        s[j][i] = p * (dp[j][i] - dd[hf]);
      }

    second_product<HD>(acc, s, ks, gq, tq);  // dQ += dS K

    if (G64) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sum += s[j][2 * hf + e];
            gw[j][2 * hf + e] += s[j][2 * hf + e];
          }
        sum += __shfl_xor_sync(kFull, sum, 1);
        sum += __shfl_xor_sync(kFull, sum, 2);
        if (tq == 0) drel_h[rel0 + (size_t)(ra + 8 * hf) * 64 + kt] = sum;
      }
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          dss[(ra + 8 * (i >> 1)) * kDst + 8 * j + 2 * tq + (i & 1)] =
              s[j][i];
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
        sum += __shfl_xor_sync(kFull, sum, 1);
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
  if (!G64) __syncthreads();  // every drel sum is in shared memory

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!rok[hf]) continue;
    const int r = ra + 8 * hf;
    float* o = dq + base + (size_t)(q0 + r) * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < NC; ++n)
      *reinterpret_cast<float2*>(o + 8 * n) =
          make_float2(acc[n][2 * hf] * scale, acc[n][2 * hf + 1] * scale);
    if (G64) {
      float* w = drel_w + rel0 + (size_t)r * 64 + 2 * tq;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        *reinterpret_cast<float2*>(w + 8 * j) =
            make_float2(gw[j][2 * hf], gw[j][2 * hf + 1]);
    }
  }
  if (!G64)
    for (int e = tid; e < kR * g; e += kThreads) {
      const int r = e / g, c = e - r * g;
      if (q0 + r >= S) continue;
      drel_h[rel0 + e] = ghs[r * AST + c];
      drel_w[rel0 + e] = gws[r * AST + c];
    }
}

// ------------------------------------------------------------------- dkv

// shared memory: K, V, then 2 stages of Q, dO and the tile rows' lse, D
// and (g = 64) rel_h[row, kh] of the block's grid row kh
template <int HD>
__host__ __device__ constexpr int dkv_stage_floats() {
  return 2 * Tile<HD>::kFloats + 3 * kR;
}
template <int HD>
size_t dkv_smem_bytes() {
  return 4 * (2 * (size_t)Tile<HD>::kFloats + 2 * dkv_stage_floats<HD>());
}

template <int HD, bool G64>
__device__ __forceinline__ void dkv_load_stage(
    float* st, const float* q, const float* dout, const float* rel_h,
    const float* lse, const float* delta, int hh, int q0, int S, int kh) {
  constexpr int T = Tile<HD>::kFloats;
  const size_t base = (size_t)hh * S * HD, row0 = (size_t)hh * S + q0;
  load_tile<HD>(st, q + base, q0, S);
  load_tile<HD>(st + T, dout + base, q0, S);
  const uint32_t rows = smem_u32(st + 2 * T);
  for (int e = threadIdx.x; e < 3 * kR; e += kThreads) {
    const int which = e / kR, c = e - which * kR;
    const bool ok = q0 + c < S && (which < 2 || G64);
    const float* src = which == 0   ? lse + row0 + c
                       : which == 1 ? delta + row0 + c
                                    : rel_h + (row0 + c) * 64 + kh;
    cp4(rows + 4 * e, ok ? src : lse, ok);
  }
}

template <int HD, bool G64>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dkv_tf32x3(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ rel_h,
                     const float* __restrict__ rel_w,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int S, int g, float scale) {
  constexpr int T = Tile<HD>::kFloats, NC = HD / 8;
  constexpr int SF = dkv_stage_floats<HD>();
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const float* ks = sm;      // the block's key rows
  const float* vs = sm + T;  // their value rows

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int ra = 16 * warp + gq;  // the thread's keys k0 + ra, k0 + ra + 8
  // at g = 64 the block's 64 keys are grid row kh0, and kw is ra (+ 8)
  const int k0 = blockIdx.x * kR, hh = blockIdx.y, kh0 = blockIdx.x;
  const size_t base = (size_t)hh * S * HD;

  load_tile<HD>(sm, k + base, k0, S);
  load_tile<HD>(sm + T, v + base, k0, S);
  dkv_load_stage<HD, G64>(sm + 2 * T, q, dout, rel_h, lse, delta, hh, 0, S,
                          kh0);
  cp_commit();

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
  float gk[NC][4], gv[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) gk[n][i] = gv[n][i] = 0.f;

  const int n_tiles = (S + kR - 1) / kR;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int st = qt & 1, q0 = qt * kR;
    const float* qs = sm + 2 * T + st * SF;
    const float* dos = qs + T;
    const float* lses = qs + 2 * T;
    const float* dds = lses + kR;
    const float* rhs = dds + kR;
    cp_wait_all();
    __syncthreads();  // tile qt has landed; tile qt - 1's stage is free
    if (qt + 1 < n_tiles) {
      dkv_load_stage<HD, G64>(sm + 2 * T + (st ^ 1) * SF, q, dout, rel_h,
                              lse, delta, hh, q0 + kR, S, kh0);
      cp_commit();
    }
    // g = 64: rel_w[query, kw] of the thread's queries and keys, read
    // ahead of the first products
    float rw[8][4];
    if (G64)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          rw[j][i] = __ldg(rel_w +
                           ((size_t)hh * S + q0 + 8 * j + 2 * tq + (i & 1)) *
                               64 + kw[i >> 1]);

    float s[8][4], dp[8][4];
    first_products<HD>(s, dp, ks, qs, vs, dos, ra, gq, tq);

    // P^T in place of s, dS^T in place of dp; 0 past S
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * tq + e;
        const float d = dds[c];
        if (G64) {
          // the block's keys share grid row kh0: rel_h joins lse
          const float l2 = (lses[c] - rhs[c]) * kLog2e;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 2 * hf + e;
            const float p =
                exp2f(fmaf(s[j][i], sl2, fmaf(rw[j][i], kLog2e, -l2)));
            s[j][i] = p;
            dp[j][i] = p * (dp[j][i] - d);
          }
        } else {
          const bool qok = q0 + c < S;
          const float l2 = lses[c] * kLog2e;
          const size_t row = ((size_t)hh * S + q0 + c) * g;
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int i = 2 * hf + e;
            float p = 0.f;
            if (qok && kok[hf]) {
              const float bias =
                  __ldg(rel_h + row + kh[hf]) + __ldg(rel_w + row + kw[hf]);
              p = exp2f(fmaf(s[j][i], sl2, fmaf(bias, kLog2e, -l2)));
            }
            s[j][i] = p;
            dp[j][i] = p * (dp[j][i] - d);
          }
        }
      }

    second_product<HD>(gv, s, dos, gq, tq);  // dV += P^T dO
    second_product<HD>(gk, dp, qs, gq, tq);  // dK += dS^T Q
  }

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!kok[hf]) continue;
    const size_t off = base + (size_t)(k0 + ra + 8 * hf) * HD + 2 * tq;
#pragma unroll
    for (int n = 0; n < NC; ++n) {
      *reinterpret_cast<float2*>(dk + off + 8 * n) =
          make_float2(gk[n][2 * hf] * scale, gk[n][2 * hf + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + 8 * n) =
          make_float2(gv[n][2 * hf], gv[n][2 * hf + 1]);
    }
  }
}

// -------------------------------------------------------------- launches

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
  auto kern = flash_bwd_dq_tf32x3<HD, G64>;
  const size_t smem = dq_smem_bytes<HD>(g, G64);
  const int err = set_smem(kern, smem);
  if (err) return err;
  kern<<<dim3((S + kR - 1) / kR, bnh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq), static_cast<float*>(drel_h),
      static_cast<float*>(drel_w), S, g, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool G64>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* rel_h, const void* rel_w, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               int bnh, int S, int g, float scale, cudaStream_t stream) {
  auto kern = flash_bwd_dkv_tf32x3<HD, G64>;
  const size_t smem = dkv_smem_bytes<HD>();
  const int err = set_smem(kern, smem);
  if (err) return err;
  kern<<<dim3((S + kR - 1) / kR, bnh), kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(rel_h),
      static_cast<const float*>(rel_w), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), S, g, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// the bfloat16 route: tensor-core kernels, flash_relpos_bwd_tc.cu
extern "C" int cartseg_flash_relpos_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dq, void* drel_h, void* drel_w, int bnh, int S, int g, int hd,
    float scale, void* stream);
extern "C" int cartseg_flash_relpos_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, int bnh, int S, int g, int hd, float scale,
    void* stream);

// q, k, v, dout: [bnh, S, hd]; rel_h, rel_w: [bnh, S, g]; all contiguous
// and 16-byte aligned, of one type: float32 (bf16 == 0) or bfloat16
// (bf16 == 1). S == g*g, hd 32 or 64. lse, delta: fp32 [bnh, S] (the
// forward's logsumexp and rowsum(dO * O)). Writes dq [bnh, S, hd] and
// drel_h, drel_w [bnh, S, g] in the inputs' type.
extern "C" int cartseg_flash_relpos_bwd_dq(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dq, void* drel_h, void* drel_w, int bnh, int S, int g, int hd,
    int bf16, float scale, void* stream) {
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  if (bf16)
    return cartseg_flash_relpos_bwd_dq_tc(q, k, v, rel_h, rel_w, dout, lse,
                                          delta, dq, drel_h, drel_w, bnh, S,
                                          g, hd, scale, stream);
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

// The same inputs; writes dk and dv [bnh, S, hd] in the inputs' type.
extern "C" int cartseg_flash_relpos_bwd_dkv(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, int bnh, int S, int g, int hd, int bf16, float scale,
    void* stream) {
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  if (bf16)
    return cartseg_flash_relpos_bwd_dkv_tc(q, k, v, rel_h, rel_w, dout, lse,
                                           delta, dk, dv, bnh, S, g, hd,
                                           scale, stream);
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
