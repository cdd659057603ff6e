// Jump-flood Euclidean distance transform (1+JFA) on Hopper.
//
// Replaces the TPU kernel `_edt_kernel` (cartseg_tpu/ops/pallas/edt.py:82),
// which kept one image's state in VMEM for the whole flood. It computes
// exactly the function of the JAX XLA lane, `edt` (cartseg_tpu/ops/edt.py:
// 34-86), bit for bit:
//   * steps k = 2^floor(log2(max(H,W)-1)) ... 1, then 1 again (`_jfa_steps`);
//   * per step the 8 candidates (dy, dx) in dy-outer, dx-inner order over
//     (-k, 0, k), skipping (0, 0), applied ONE AFTER ANOTHER: candidate j
//     reads the state that candidate j-1 left;
//   * pixel (y, x) takes the seed of (y - dy, x - dx) only when that pixel
//     is in the image, has a seed, and is strictly closer;
//   * a pixel of a sample with no seed ends at sqrtf(1e12f) = 1e6; the
//     others at the IEEE sqrtf of the exact integer d^2.
//
// Design. An SM has at most 227 KB of shared memory and a 512^2 int32
// state is 1 MB, but the flood has structure that lets a block keep its
// part of it in shared memory anyway: step k pairs only pixels that are
// congruent mod k in both axes, so each residue class mod k evolves on its
// own, and for k' <= k a class mod k' is a union of classes mod k. The
// host's planner (`plan` in ops/cuda/edt.py, whose results the entry point
// takes) picks the split k', the smallest power of two whose classes fit a
// block, and the schedule has two launches:
//   edt_classes: one block per (image, class mod k'), B k'^2 blocks (96 at
//     [6,512,512], k' = 4). The block gathers its class of the seed map and
//     runs every step k >= k' in shared memory, the class neighbour at
//     (dy/k', dx/k') standing in for (dy, dx). When k' = 1 this is the
//     whole flood, one block an image, and it writes the distances.
//   edt_tiles: the steps below k' (2, 1, 1 at 512^2), on 2-D tiles that
//     load tile + halo of the stage-A state. A step reaches 3k pixels
//     (three of its candidates move the same way on an axis), so a halo of
//     3 * (sum of those k) makes the tile's own pixels exact; the halo's
//     pixels are recomputed and dropped. The tile writes its distances.
// Launches a call: 1 (k' = 1) or 2.
//
// State. A pixel holds the offset to its seed, (ox, oy) as a half2, in
// shared memory (what its neighbours read) and in the owning thread's
// registers beside its squared distance in fp32. A candidate is then one
// load and one half2 add (the neighbour's offset plus (dx, dy)), its d^2
// by a multiply and an FMA, and a compare: the FP pipes, which issue
// twice the int32 rate. It is exact: an offset to a seed is an integer of
// at most 2047 (fp16 holds every integer to 2048, and a sum whose exact
// value it holds is exact), and d^2 < 2^23 is exact in fp32, so the
// decisions are the float compares of the reference. "No seed" is the
// offset (0, 16384): a candidate built from it is at least ~13000 away in
// oy (its rounding in fp16 moves it by at most 16 an add), so it never
// beats a seed, and what it does among seedless pixels is never seen;
// d^2 >= 2^24 reads as "no seed" at the end. A candidate outside the image
// (outside the class or the tile's region, which are clipped to the image)
// reads "no seed" too.
//
// Threads. 1024 a block; thread t owns column t % Wr of the block's Hr x
// Wr region and rows t / Wr + r R, R = min(1024 / Wr, Hr), r < nr <= 16,
// so a warp reads 32 consecutive words (no bank conflicts). Rows past Hr
// up to nr R are padding: they hold "no seed", are never read as a
// candidate, and are never written out. Each candidate reads one buffer
// and writes the other, one __syncthreads() apart: no atomics, the same
// bits on every run. A thread loads 4 neighbours before it stores any of
// its cells: the compiler cannot move a shared load past a store to the
// other buffer.
//
// Bound on this card: operations. 1+JFA does 8 * (log2 N + 1) dependent
// candidates a pixel (80 at 512^2), and a candidate needs 5 operations:
// the offset add, d^2 as a multiply and an FMA, the compare and the select
// (chip_smoke.EDT_OPS), at an SM's 4 warp instructions a clock. This
// kernel spends 12 beside a shared load and store (the neighbour's row,
// its bounds, the address and a select on the int32 pipe; the add, two
// conversions, the multiply and FMA, the compare and a select on the FP
// pipes; chip_smoke.EDT_KERNEL_OPS): the bounds, the address and the
// conversions are the price of the fp16-offset state and the clipped
// regions. The bytes (the uint8 seeds in, the float distances out) are 5
// bytes a pixel. A
// block holds its region alone, so stage A's 96 blocks leave 36 of the
// 132 SMs idle; a second, unchecked copy of the candidate loop for the
// interior was slower (a larger unrolled body), so every cell is checked.

#include <cstdint>
#include <cstring>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;  // a block, both stages
constexpr int kCells = 16;      // region cells a thread at most
constexpr int kBatch = 4;       // neighbours a thread loads before it stores
constexpr int kMaxSteps = 16;
constexpr uint32_t kNoSeed = 0x74000000u;  // half2 (ox, oy) = (0, 16384)
constexpr float kNoSeedD2 = 16777216.f;    // d^2 at or above: no seed

struct Steps {
  int n;
  int k[kMaxSteps];
};

__device__ __forceinline__ __half2 as_h2(uint32_t u) {
  __half2 h;
  memcpy(&h, &u, 4);
  return h;
}
__device__ __forceinline__ uint32_t as_u32(__half2 h) {
  uint32_t u;
  memcpy(&u, &h, 4);
  return u;
}

// oy^2 + ox^2 in fp32: exact for every offset to a seed (< 2^23)
__device__ __forceinline__ float d2_of(__half2 o) {
  const float2 f = __half22float2(o);
  return fmaf(f.x, f.x, f.y * f.y);
}

__device__ __forceinline__ float finish(float d2) {
  return sqrtf(d2 >= kNoSeedD2 ? 1e12f : d2);
}

// The block's flood: steps `st` on an Hr x Wr region whose cells are
// 2^sh pixels apart, the state in `cur` (and in p, d2 for the thread's
// cells i0 + r R, r < nr, of column j). Per candidate, each batch of
// kBatch neighbours is loaded before any of the thread's stores, which the
// compiler could not otherwise move the loads past. A neighbour outside
// the region reads "no seed".
__device__ __forceinline__ void flood(uint32_t* cur, uint32_t* nxt,
                                      uint32_t (&p)[kCells],
                                      float (&d2)[kCells], const Steps& st,
                                      int sh, int Hr, int Wr, int R, int nr,
                                      int i0, int j, bool active) {
  const int stride = R * Wr;
  for (int si = 0; si < st.n; ++si) {
    const int k = st.k[si];
    for (int dy = -k; dy <= k; dy += k) {
      for (int dx = -k; dx <= k; dx += k) {
        if (dy == 0 && dx == 0) continue;
        const int a = dy >> sh, b = dx >> sh;  // cells: k is a multiple
        const __half2 delta = __floats2half2_rn((float)dx, (float)dy);
        const bool col = active && (unsigned)(j - b) < (unsigned)Wr;
        const int lo = i0 - a;  // the neighbour row of cell 0
        const uint32_t* src = cur + lo * Wr + j - b;
        uint32_t* dst = nxt + i0 * Wr + j;
#pragma unroll
        for (int r0 = 0; r0 < kCells; r0 += kBatch) {
          if (r0 >= nr) break;
          uint32_t c[kBatch];
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int r = r0 + u;
            const bool ok = col && r < nr &&
                            (unsigned)(lo + r * R) < (unsigned)Hr;
            c[u] = ok ? src[r * stride] : kNoSeed;
          }
#pragma unroll
          for (int u = 0; u < kBatch; ++u) {
            const int r = r0 + u;
            const __half2 cand = __hadd2(as_h2(c[u]), delta);
            const float nd = d2_of(cand);
            if (nd < d2[r]) {
              p[r] = as_u32(cand);
              d2[r] = nd;
            }
            if (active && r < nr) dst[r * stride] = p[r];
          }
        }
        __syncthreads();
        uint32_t* t = cur;
        cur = nxt;
        nxt = t;
      }
    }
  }
}

// Stage A: one block per (image, residue class (ry, rx) mod kp). The class
// is the cells (ry + i kp, rx + j kp) of the image; `cells` ints a buffer.
// final: the whole flood ran here, write distances; else the state.
__global__ void __launch_bounds__(kThreads, 1)
edt_classes(const uint8_t* __restrict__ seeds, uint32_t* __restrict__ state,
            float* __restrict__ dist, int H, int W, int kp, int cells,
            Steps st, int final_) {
  extern __shared__ uint32_t sm[];
  const int n_cls = kp * kp;
  const int img = blockIdx.x / n_cls, cls = blockIdx.x - img * n_cls;
  const int ry = cls / kp, rx = cls - ry * kp;
  const int Hr = (H - ry + kp - 1) / kp, Wr = (W - rx + kp - 1) / kp;
  if (Hr <= 0 || Wr <= 0) return;  // the whole block: before any barrier
  const int R = min(kThreads / Wr, Hr), nr = (Hr + R - 1) / R;
  const int t = threadIdx.x, j = t % Wr, i0 = t / Wr;
  const bool active = i0 < R;
  const size_t base = (size_t)img * H * W;

  uint32_t p[kCells];
  float d2[kCells];
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    p[r] = kNoSeed;
    if (r < nr && active) {
      const int i = i0 + r * R;
      if (i < Hr && seeds[base + (size_t)(ry + i * kp) * W + rx + j * kp])
        p[r] = 0u;  // the offset (0, 0)
      sm[i * Wr + j] = p[r];
    }
    d2[r] = d2_of(as_h2(p[r]));
  }
  __syncthreads();
  flood(sm, sm + cells, p, d2, st, __ffs(kp) - 1, Hr, Wr, R, nr, i0, j,
        active);
  if (!active) return;
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    const int i = i0 + r * R;
    if (r >= nr || i >= Hr) break;
    const size_t o = base + (size_t)(ry + i * kp) * W + rx + j * kp;
    if (final_)
      dist[o] = finish(d2[r]);
    else
      state[o] = p[r];
  }
}

// Stage B: one block per (image, tile of T x T pixels); the region is the
// tile and `halo` pixels around it, clipped to the image.
__global__ void __launch_bounds__(kThreads)
edt_tiles(const uint32_t* __restrict__ state, float* __restrict__ dist, int H,
          int W, int T, int halo, int cells, Steps st) {
  extern __shared__ uint32_t sm[];
  const int nty = (H + T - 1) / T, ntx = (W + T - 1) / T;
  const int img = blockIdx.x / (nty * ntx);
  const int tt = blockIdx.x - img * nty * ntx;
  const int ty0 = (tt / ntx) * T, tx0 = (tt % ntx) * T;
  const int y0 = max(ty0 - halo, 0), x0 = max(tx0 - halo, 0);
  const int Hr = min(ty0 + T + halo, H) - y0;
  const int Wr = min(tx0 + T + halo, W) - x0;
  const int R = min(kThreads / Wr, Hr), nr = (Hr + R - 1) / R;
  const int t = threadIdx.x, j = t % Wr, i0 = t / Wr;
  const bool active = i0 < R;
  const size_t base = (size_t)img * H * W;

  uint32_t p[kCells];
  float d2[kCells];
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    p[r] = kNoSeed;
    if (r < nr && active) {
      const int i = i0 + r * R;
      if (i < Hr) p[r] = state[base + (size_t)(y0 + i) * W + x0 + j];
      sm[i * Wr + j] = p[r];
    }
    d2[r] = d2_of(as_h2(p[r]));
  }
  __syncthreads();
  flood(sm, sm + cells, p, d2, st, 0, Hr, Wr, R, nr, i0, j, active);
  const int x = x0 + j;
  if (!active || x < tx0 || x >= tx0 + T) return;
#pragma unroll
  for (int r = 0; r < kCells; ++r) {
    const int y = y0 + i0 + r * R;
    if (r >= nr || y >= y0 + Hr) break;
    if (y >= ty0 && y < ty0 + T) dist[base + (size_t)y * W + x] = finish(d2[r]);
  }
}

int set_smem(const void* kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// seeds: [B,H,W] uint8 (0/1); state: [B,H,W] int32 scratch (unused when
// n_b == 0); dist: [B,H,W] float32 out. The schedule is `plan(H, W)` of
// ops/cuda/edt.py: split k', steps[0 .. n_a) (the steps >= k', stage A),
// steps[n_a .. n_a + n_b) (the steps below k', stage B, on tiles of
// tile x tile pixels with `halo` around), and the int32 cells of one
// shared-memory buffer of each stage (two buffers a block).
extern "C" int cartseg_edt(const uint8_t* seeds, uint32_t* state,
                           float* dist,
                           int B, int H, int W, int split, const int* steps,
                           int n_a, int n_b, int cells_a, int tile, int halo,
                           int cells_b, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  const size_t max_smem = 232448;
  if (split < 1 || (split & (split - 1)) || n_a < 0 || n_b < 0 ||
      n_a > kMaxSteps ||
      n_b > kMaxSteps || cells_a < 1 || 8 * (size_t)cells_a > max_smem ||
      (n_b > 0 && (tile < 1 || halo < 0 || cells_b < 1 ||
                   8 * (size_t)cells_b > max_smem)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  Steps a{n_a, {}}, b{n_b, {}};
  for (int i = 0; i < n_a; ++i) a.k[i] = steps[i];
  for (int i = 0; i < n_b; ++i) b.k[i] = steps[n_a + i];

  const size_t smem_a = 8 * (size_t)cells_a;
  int err = set_smem((const void*)edt_classes, smem_a);
  if (err) return err;
  edt_classes<<<(unsigned)(B * split * split), kThreads, smem_a, s>>>(
      seeds, state, dist, H, W, split, cells_a, a, n_b == 0);
  if (n_b == 0) return (int)cudaGetLastError();
  err = (int)cudaGetLastError();
  if (err) return err;
  const size_t smem_b = 8 * (size_t)cells_b;
  err = set_smem((const void*)edt_tiles, smem_b);
  if (err) return err;
  const unsigned tiles =
      (unsigned)(B * ((H + tile - 1) / tile) * ((W + tile - 1) / tile));
  edt_tiles<<<tiles, kThreads, smem_b, s>>>(state, dist, H, W, tile, halo,
                                            cells_b, b);
  return (int)cudaGetLastError();
}
