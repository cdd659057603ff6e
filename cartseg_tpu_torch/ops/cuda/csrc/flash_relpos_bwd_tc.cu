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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kR = 64;     // rows of a tile: queries (dq), keys (dkv)
constexpr int kWG = 128;   // threads of a block: one warpgroup
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDst = kR + 4;  // row stride of the staged fp32 dS tile

// a [64][HD] bf16 tile in shared memory, 16-byte chunks swizzled as
// wgmma's 128-byte (HD 64) or 64-byte (HD 32) layout; 1024-byte aligned
template <int HD>
struct Tile {
  static constexpr uint32_t kRowBytes = HD * 2;
  static constexpr uint32_t kBytes = kR * kRowBytes;
  static constexpr uint32_t kGroup = 8 * kRowBytes;     // 8 rows: the SBO
  static constexpr uint32_t kSwz = HD == 64 ? 7 : 3;    // chunk bits XORed
  static constexpr uint64_t kLayout = HD == 64 ? 1 : 2;  // B128, B64
};

// byte offset of a 16-byte chunk in the tile: Swizzle<3,4,3> (HD 64) or
// Swizzle<2,4,3> (HD 32), the layouts wgmma's descriptors name
template <int HD>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & Tile<HD>::kSwz) << 4);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- copies

// 16 bytes to shared memory, of which the first `bytes` come from src and
// the rest are zeros
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// the copies' writes, made by the generic proxy, visible to wgmma's reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// rows [r0, r0 + 64) of a [S, HD] slice into a swizzled tile, zeros past
// S. Thread t copies chunk t % C of rows t / C + j * (128 / C): a step of
// 16 or 32 rows keeps the swizzle, so one offset serves all its chunks.
template <int HD>
__device__ __forceinline__ void load_tile(uint32_t dst, const bf16* src,
                                          int r0, int S) {
  constexpr int C = HD / 8, RS = kWG / C;
  const int c = threadIdx.x % C, r = threadIdx.x / C;
  const uint32_t d = dst + swizzle<HD>(r * Tile<HD>::kRowBytes + c * 16);
  const bf16* p = src + (size_t)(r0 + r) * HD + c * 8;
#pragma unroll
  for (int j = 0; j < kR / RS; ++j) {
    const bool ok = r0 + r + j * RS < S;
    cp16(d + j * RS * Tile<HD>::kRowBytes, ok ? p + j * RS * HD : src,
         ok ? 16 : 0);
  }
}

// N 16-byte chunks from a 16-byte aligned src that holds them all
template <int N>
__device__ __forceinline__ void load_chunks(uint32_t dst, const void* src) {
#pragma unroll
  for (int j = 0; j < (N + kWG - 1) / kWG; ++j) {
    const int e = threadIdx.x + j * kWG;
    if (N % kWG == 0 || e < N)
      cp16(dst + 16 * e, static_cast<const char*>(src) + 16 * e, 16);
  }
}

// where element `off` of a flat array of ES-byte elements lands in a span
// copied by load_span: the span starts on the 16-byte boundary below it
template <int ES>
__device__ __forceinline__ int span_shift(size_t off) {
  return (int)(off % (16 / ES));
}

// elements [off, off + n) of a flat array of `total` ES-byte elements
// into shared memory, from element off - span_shift(off) on, so that every
// copy is 16 bytes from a 16-byte boundary; zeros past the array's end.
// dst must hold n * ES + 16 bytes.
template <int ES>
__device__ __forceinline__ void load_span(uint32_t dst, const void* src,
                                          size_t off, int n, size_t total) {
  const int sh = span_shift<ES>(off);
  const size_t b0 = (off - sh) * ES, end = total * ES;
  const int nb = ((sh + n) * ES + 15) & ~15;
  for (int e = threadIdx.x * 16; e < nb; e += kWG * 16) {
    const size_t b = b0 + e;
    const int left = b < end ? (int)(end - b < 16 ? end - b : 16) : 0;
    cp16(dst + e, static_cast<const char*>(src) + (left ? b : 0), left);
  }
}

// ------------------------------------------------------------------ wgmma

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (the stride is one 8-row group of the tile), swizzle mode
template <int HD>
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(Tile<HD>::kGroup >> 4) << 32) |
         (Tile<HD>::kLayout << 62);
}
// the tile as a K-major operand (its rows the M or N index, HD the K
// index): k-step kk starts 32 bytes on; the leading offset is unused
template <int HD>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc<HD>(tile + 32 * kk, 16);
}
// the tile as an MN-major B operand (its rows the K index, HD the N
// index, one swizzle atom wide): k-step kk starts 16 rows on
template <int HD>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc<HD>(tile + 16 * kk * Tile<HD>::kRowBytes,
                       Tile<HD>::kBytes);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this thread's wgmma groups are pending
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps the compiler from moving reads of accumulators above the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// keeps A fragments in their registers up to here, so that the compiler
// gives no other value the registers that a pending wgmma still reads
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D (64 x 64, fp32) (+)= A (64 x 16, smem) . B (64 x 16, smem), both K-major
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 registers) . B (16 x 64, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 registers) . B (16 x 32, smem,
// MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// the second products: D += A . B, B the MN-major tile, N = HD
template <int HD>
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[HD / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (HD == 64) {
    wgmma_rs_n64(d, a, db);
  } else {
    wgmma_rs_n32(d, a, db);
  }
}

// Accumulator fragment of an m64nN product: thread t (warp w, lane l) holds
// rows 16w + l/4 (hf = 0) and that + 8 (hf = 1) of columns 8n + 2(l%4) + e,
// at index 4n + 2hf + e. The A fragment of an m64k16 product from
// registers holds the same rows and columns 16kk..16kk+15 as
// {pack(x[8kk], x[8kk+1]), pack(x[8kk+2], x[8kk+3]), pack(x[8kk+4],
// x[8kk+5]), pack(x[8kk+6], x[8kk+7])}: an accumulator becomes an A operand
// without moving between threads.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t r;
  memcpy(&r, &v, 4);
  return r;
}
__device__ __forceinline__ void to_a(const float (&x)[32],
                                     uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int m = 0; m < 4; ++m)
      a[kk][m] = pack_bf16(x[8 * kk + 2 * m], x[8 * kk + 2 * m + 1]);
}
__device__ __forceinline__ void store2(bf16* p, float lo, float hi) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(lo, hi);
}

// row stride of the fp32 [64, g] drel accumulators
__host__ __device__ __forceinline__ int acc_stride(int g) {
  return g + (12 - g % 8) % 8;
}
// bytes of a span of 64 rows of a [S, g] bias factor
__host__ __device__ __forceinline__ uint32_t rel_bytes(int g) {
  return 128u * g + 16u;
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
