// Shared pieces of the bfloat16 flash-attention kernels on Hopper's tensor
// cores (flash_relpos_fwd_tc.cu, the forward; flash_relpos_bwd_tc.cu, the
// backward): the swizzled [64][HD] tiles, the cp.async copies that fill
// them, wgmma's shared-memory descriptors, the wgmma calls (both operands
// from shared memory, or A from registers), and the packing of an fp32
// accumulator into a bf16 A fragment.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace flash_tc {

using bf16 = __nv_bfloat16;

constexpr int kR = 64;     // rows of a tile: queries (fwd, dq), keys (dkv)
constexpr int kWG = 128;   // threads of a block: one warpgroup
constexpr float kLog2e = 1.4426950408889634f;

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

// bytes of a span of 64 rows of a [S, g] bias factor
__host__ __device__ __forceinline__ uint32_t rel_bytes(int g) {
  return 128u * g + 16u;
}

}  // namespace flash_tc
