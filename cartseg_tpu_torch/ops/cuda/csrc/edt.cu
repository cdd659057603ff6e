// Jump-flood Euclidean distance transform (1+JFA) on Hopper.
//
// Replaces the TPU kernel `_edt_kernel` (cartseg_tpu/ops/pallas/edt.py:82),
// which kept one image's by/bx/d2 planes in VMEM for the whole flood. It
// computes exactly the function of the JAX XLA lane, `edt`
// (cartseg_tpu/ops/edt.py:34-86), bit for bit:
//   * steps k = 2^floor(log2(max(H,W)-1)) ... 1, then 1 again (`_jfa_steps`);
//   * per step the 8 candidates (dy, dx) in dy-outer, dx-inner order over
//     (-k, 0, k), skipping (0, 0), applied ONE AFTER ANOTHER: candidate j
//     reads the state that candidate j-1 left. The textbook JFA, which
//     compares all 8 against the step's starting state, is another
//     function and differs on real pixels;
//   * pixel (y, x) takes its candidate from (y - dy, x - dx) (the shift
//     fills from the leading side, connected_components._shift_fill),
//     and only on a strict `<` of the squared distance;
//   * a pixel of a sample with no seed ends at sqrtf(1e12f) = 1e6.
//
// Design: the state is one int32 per pixel, the image-local flat index of
// the current nearest seed (-1 for none); the squared distance is
// recomputed from it in int32 and converted to float, which is exact
// below 2^24 (JAX computes the same integers and converts, edt.py:58-62).
// An SM has at most 227 KB of shared memory and a 512^2 state is 1 MB, so
// the state lives in global memory, and since every candidate depends on
// the whole plane after the previous one, each candidate is one launch
// over [B,H,W] with ping-pong buffers: 8 * 10 + 2 launches at 512^2.
//
// Bound on this card: memory traffic and launch latency. A pass reads the
// state twice (own and shifted, both coalesced) and writes it once: 19 MB
// at [6,512,512]; the 80 passes mostly hit the 50 MB L2.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInf = 1e12f;

__device__ __forceinline__ float seed_d2(int s, int y, int x, int W) {
  if (s < 0) return kInf;
  int sy = s / W;
  int dy = y - sy, dx = x - (s - sy * W);
  return (float)(dy * dy + dx * dx);
}

__global__ void edt_init(const uint8_t* __restrict__ seeds,
                         int* __restrict__ idx, long long n, int hw) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  idx[p] = seeds[p] ? (int)(p % hw) : -1;
}

__global__ void edt_candidate(const int* __restrict__ in,
                              int* __restrict__ out, long long n, int H,
                              int W, int dy, int dx) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int hw = H * W;
  int q = (int)(p % hw);
  int y = q / W, x = q - y * W;
  int cur = in[p];
  int sy = y - dy, sx = x - dx;
  if (sy >= 0 && sy < H && sx >= 0 && sx < W) {
    int c = in[p - q + sy * W + sx];
    if (c >= 0 && seed_d2(c, y, x, W) < seed_d2(cur, y, x, W)) cur = c;
  }
  out[p] = cur;
}

__global__ void edt_finish(const int* __restrict__ idx,
                           float* __restrict__ dist, long long n, int H,
                           int W) {
  long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int q = (int)(p % (H * W));
  int y = q / W;
  dist[p] = sqrtf(seed_d2(idx[p], y, q - y * W, W));
}

}  // namespace

// seeds: [B,H,W] uint8 (0/1); a, b: [B,H,W] int32 scratch; dist: [B,H,W]
// float32 out.
extern "C" int cartseg_edt(const uint8_t* seeds, int* a, int* b,
                           float* dist, int B, int H, int W, void* stream) {
  long long n = (long long)B * H * W;
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
    edt_init<<<grid, kThreads, 0, s>>>(seeds, a, n, H * W);
    // _jfa_steps: k0, k0/2, ..., 1, then the "+1" pass of 1+JFA at k = 1
    int m = H > W ? H : W;
    int k0 = 1;
    while (k0 * 2 < m) k0 *= 2;
    int steps[34];
    int ns = 0;
    for (int k = k0; k >= 1; k /= 2) steps[ns++] = k;
    steps[ns++] = 1;
    for (int i = 0; i < ns; ++i) {
      int k = steps[i];
      for (int dy = -k; dy <= k; dy += k) {
        for (int dx = -k; dx <= k; dx += k) {
          if (dy == 0 && dx == 0) continue;
          edt_candidate<<<grid, kThreads, 0, s>>>(a, b, n, H, W, dy, dx);
          int* t = a;
          a = b;
          b = t;
        }
      }
    }
    edt_finish<<<grid, kThreads, 0, s>>>(a, dist, n, H, W);
  }
  return (int)cudaGetLastError();
}
