// Exact per-row median of non-negative floats on Hopper.
//
// Replaces the TPU kernel `_median_kernel`
// (cartseg_tpu/ops/pallas/median.py:38), which held one whole row in VMEM
// and bisected 31 times on the int32 bit patterns, re-reading the row for
// every rank count. For non-negative IEEE-754 floats the bit order equals
// the float order (median.py:8-17), so an order statistic can be found on
// the bits: radix select, 8 bits a pass, 4 passes, tracking both middle
// order statistics k_lo = (N-1)/2 and k_hi = N/2 at once. After the last
// pass each prefix is the exact bit pattern of its order statistic, and
// the result is 0.5f * (v_lo + v_hi) in fp32, as at median.py:90-92.
//
// Bound on this card: memory bandwidth, the [B,N] rows read once (64 MB at
// [64,262144], 19 us at 3.35 TB/s).
//
// Two routes, chosen by the wrapper's `plan` (ops/cuda/median.py) from N:
//
// Cluster route, one launch, each row read from device memory once. The
// TPU kernel kept a row in VMEM; a 1 MB row does not fit one SM's 227 KB
// but does fit the distributed shared memory of a thread-block cluster.
// Grid (cluster, B): the cluster's CTAs split one row into `slice`-element
// slices (8 x 32768 at N = 262144, one CTA an SM). Each CTA
//   - loads its slice into shared memory by TMA bulk copies
//     (cp.async.bulk, kChunks chunks, one mbarrier each; the < 4 elements
//     before the first 16-byte boundary and after the last are plain
//     loads kept in registers), and counts the first digit of each chunk
//     as it lands, so that pass hides under the load;
//   - counts, in each pass, the digit of the elements whose higher bits
//     match a target's prefix, keys [target][digit]. While the two
//     prefixes agree (nearly always) one test and one key serve both.
//     The counts go to per-lane histograms: each lane owns a bank, a
//     column of 16-bit counters packed two keys a word, so a warp's
//     red.shared never collide however skewed the digits are (on the
//     path's |p - 0.5| * 2 in [0, 1] the first digit, sign and 7 exponent
//     bits, sends almost every element to one or two bins; one shared
//     histogram with atomics, or __match_any_sync grouping, measured
//     slower on the H100);
//   - sums the columns into its histogram and stores it into every CTA
//     of the cluster by st.async (DSMEM), which completes the receiver's
//     mbarrier for the pass; each CTA sums the CS histograms it received,
//     and two warps pick each target's digit and remaining rank with a
//     warp prefix scan. Every CTA computes the same choice: no global
//     state, no memset, no global atomics, and no cluster-wide barrier a
//     pass (cluster.sync() and DSMEM reads measured slower).
// The receive buffers are double-buffered: a CTA can be at most one pass
// ahead of another. One cluster barrier after the barriers' init, one at
// the end. CTA rank 0 writes the result.
// What bounds it: the rows do not fit the card's shared memory at once
// (64 MB against 132 x 227 KB), so the clusters run in 4 waves of 16 rows,
// and a CTA's load cannot overlap the previous wave's passes; within a
// wave, the passes' per-element instructions and the waits for the
// cluster's histograms. On the H100 an L2 prefetch of the next wave's rows
// measured no gain, and a cluster of 16 with 64 KB slices (two CTAs an SM)
// and gathering the candidates of the last two passes into one CTA
// measured slower.
//
// A slice holds at most kMaxSlice elements, the build's
// -DCARTSEG_MEDIAN_MAX_SLICE (ops/cuda/build.py, which `plan` reads too);
// a static_assert below checks that it fits beside the rest of the CTA's
// shared memory.
//
// Stream route, for rows past what a cluster can hold (N above 8 x
// kMaxSlice elements): the first design, kept as it was. For each of 4
// passes a memset, a histogram kernel over 8192-element chunks (global
// atomics into [B,2,256]) and a select kernel, one thread a row; 13
// kernels and 4 memsets a call, each pass reading the rows from device
// memory.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kBits = 8;
constexpr int kBins = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNone = 0xffffffffu;    // key of an element not counted

// ------------------------------------------------------------ cluster route

constexpr int kClusterThreads = 1024;
constexpr int kChunks = 8;                 // TMA copies a slice
constexpr int kMaxClusterSmem = 232448;    // an H100 block's shared memory
constexpr int kKeys = 2 * kBins;           // [target][digit]
// per-lane histograms: 16-bit counters of two neighbouring keys packed in
// a word, a column of kKeys / 2 words for each of the 32 lanes
constexpr int kLaneWords = kKeys / 2 * 32;

struct ClusterShared {
  unsigned long long bar[kChunks];
  unsigned long long rbar[2];    // completes when a pass's recv is full
  unsigned recv[2][8][kKeys];    // double-buffered: [rank][target][digit]
  unsigned tot[kKeys];           // the cluster's sum of this pass
  unsigned prefix[2];            // bits chosen so far, lo and hi target
  unsigned rank[2];              // rank left within the prefix
};

#ifndef CARTSEG_MEDIAN_MAX_SLICE
#error "build with -DCARTSEG_MEDIAN_MAX_SLICE=<elements> (ops/cuda/build.py)"
#endif
constexpr int kMaxSlice = CARTSEG_MEDIAN_MAX_SLICE;
static_assert(kMaxSlice > 0 &&
                  sizeof(ClusterShared) + 16 * ((kMaxSlice + 3) / 4) +
                          4 * kLaneWords <=
                      kMaxClusterSmem,
              "a slice of kMaxSlice elements does not fit a CTA's shared "
              "memory");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// this CTA's shared address `a` in the CTA of cluster rank r
__device__ __forceinline__ unsigned map_rank(unsigned a, unsigned r) {
  unsigned d;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(a), "r"(r));
  return d;
}

__device__ __forceinline__ bool bar_try_wait(unsigned bar, unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

struct Pass {
  unsigned mask, p0, p1;
  int shift;
  // target * kBins + digit, or kNone for an element under neither prefix
  __device__ __forceinline__ unsigned key(unsigned v) const {
    const unsigned d = (v >> shift) & (kBins - 1);
    const unsigned hi = v & mask;
    return hi == p0 ? d : (hi == p1 ? kBins + d : kNone);
  }
};

// Count one key into this lane's column of the per-lane histograms at
// shared address `lane_col` (this lane's word of key pair 0): a lane only
// ever adds to its own bank, so a warp's reductions never collide, however
// skewed the digits (red.shared orders the warps that share a column).
__device__ __forceinline__ void count_key(unsigned key, unsigned lane_col) {
  asm volatile("red.shared.add.u32 [%0], %1;\n" ::"r"(lane_col +
                                                      ((key >> 1) << 7)),
               "r"(1u << ((key & 1) << 4))
               : "memory");
}

__device__ __forceinline__ uint4 load_group(unsigned addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Count the digits at bit SHIFT of the 16-byte groups [a, b) of the body
// at shared address `body`, for the elements under the lo prefix p0 or
// the hi prefix p1 (the bits above the digit). The instruction count is
// what bounds the passes, so each pass has its own code: the first digit
// needs no prefix test, and while the prefixes agree one test serves both.
template <int SHIFT>
__device__ __forceinline__ void count_groups(unsigned body, int a, int b,
                                             unsigned p0, unsigned p1,
                                             unsigned lane_col) {
  constexpr int kTop = SHIFT + kBits;
  const int step = kClusterThreads;
  if constexpr (kTop == 32) {
    for (int i = a + (int)threadIdx.x; i < b; i += step) {
      const uint4 v = load_group(body + 16u * (unsigned)i);
      const unsigned e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) count_key(e[j] >> SHIFT, lane_col);
    }
  } else if (p0 == p1) {
    for (int i = a + (int)threadIdx.x; i < b; i += step) {
      const uint4 v = load_group(body + 16u * (unsigned)i);
      const unsigned e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (((e[j] ^ p0) >> kTop) == 0u)
          count_key((e[j] >> SHIFT) & (kBins - 1), lane_col);
    }
  } else {
    for (int i = a + (int)threadIdx.x; i < b; i += step) {
      const uint4 v = load_group(body + 16u * (unsigned)i);
      const unsigned e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned d = (e[j] >> SHIFT) & (kBins - 1);
        if (((e[j] ^ p0) >> kTop) == 0u)
          count_key(d, lane_col);
        else if (((e[j] ^ p1) >> kTop) == 0u)
          count_key(kBins + d, lane_col);
      }
    }
  }
}

__device__ __forceinline__ void count_range(int pass, unsigned body, int a,
                                            int b, unsigned p0, unsigned p1,
                                            unsigned lane_col) {
  switch (pass) {
    case 0: count_groups<24>(body, a, b, p0, p1, lane_col); break;
    case 1: count_groups<16>(body, a, b, p0, p1, lane_col); break;
    case 2: count_groups<8>(body, a, b, p0, p1, lane_col); break;
    default: count_groups<0>(body, a, b, p0, p1, lane_col); break;
  }
}

// Warp-parallel choice of target t's digit from the cluster's histogram
// `h` (kBins bins): lane l holds bins [8l, 8l + 8).
__device__ __forceinline__ void choose_digit(ClusterShared& sh, int t,
                                             const unsigned* h, unsigned p,
                                             int shift) {
  const int lane = threadIdx.x & 31;
  constexpr int kPer = kBins / 32;
  unsigned c[kPer], sum = 0u;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    c[j] = h[lane * kPer + j];
    sum += c[j];
  }
  unsigned incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned u = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += u;
  }
  const unsigned k = sh.rank[t];
  // the rank lies inside the counted elements, so some lane holds it
  const unsigned owner = __ffs(__ballot_sync(kFull, k < incl)) - 1;
  if ((unsigned)lane == owner) {
    unsigned cum = incl - sum;
    int d = lane * kPer;
#pragma unroll
    for (int j = 0; j < kPer - 1; ++j) {
      if (k < cum + c[j]) break;
      cum += c[j];
      ++d;
    }
    sh.prefix[t] = p | ((unsigned)d << shift);
    sh.rank[t] = k - cum;
  }
}

template <int CS>
__global__ void __launch_bounds__(kClusterThreads)
median_cluster(const float* __restrict__ x, float* __restrict__ out, int n,
               int slice) {
  // dynamic: the body's 16-byte groups, then the per-lane histograms
  extern __shared__ __align__(16) unsigned data[];
  __shared__ ClusterShared sh;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  // this CTA's slice of row blockIdx.y: up to 3 head elements before the
  // first 16-byte boundary, `groups` 16-byte groups (the body, copied to
  // `data`), up to 3 tail elements; head and tail stay in warp 0's
  // registers
  const long long begin = (long long)rank * slice;
  const int len = (int)max(0LL, min((long long)slice, (long long)n - begin));
  const float* src = x + (long long)blockIdx.y * n + begin;
  const int head =
      min(len, (int)((16u - ((unsigned)(uintptr_t)src & 15u)) & 15u) >> 2);
  const int groups = (len - head) >> 2;
  const int tail = len - head - 4 * groups;
  const uint4* body = reinterpret_cast<const uint4*>(data);
  unsigned* lh = data + 4 * ((slice + 3) / 4);
  const unsigned body_s = smem_addr(body);
  const unsigned lane_col = smem_addr(lh) + 4u * lane;
  const int per_chunk = (groups + kChunks - 1) / kChunks;

  for (int i = tid; i < kLaneWords; i += kClusterThreads) lh[i] = 0u;
  if (tid == 0) {
    sh.prefix[0] = sh.prefix[1] = 0u;
    sh.rank[0] = (unsigned)((n - 1) / 2);
    sh.rank[1] = (unsigned)(n / 2);
    for (int c = 0; c < kChunks; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&sh.bar[c]))
                   : "memory");
    for (int c = 0; c < 2; ++c)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                       smem_addr(&sh.rbar[c]))
                   : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the cluster sends to these barriers once it has waited on this
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  unsigned used0 = 0u, used1 = 0u;   // completed phases of rbar[0], [1]
  // the head and tail elements outside the bulk copies
  unsigned edge = 0u;
  if (warp == 0 && lane < head + tail) {
    const int j = lane < head ? lane : head + 4 * groups + (lane - head);
    edge = __float_as_uint(src[j]);
  }
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < kChunks; ++c) {
      const int a = c * per_chunk, b = min(groups, a + per_chunk);
      const unsigned bytes = b > a ? 16u * (unsigned)(b - a) : 0u;
      const unsigned bar = smem_addr(&sh.bar[c]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(bar), "r"(bytes)
                   : "memory");
      if (bytes)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(body + a)),
            "l"(src + head + 4 * a), "r"(bytes), "r"(bar)
            : "memory");
    }
  }

  int buf = 0;   // histogram buffer of the next counted pass
  for (int pass = 0; pass < kPasses; ++pass) {
    const int bsel = buf;   // this counted pass's receive buffer
    buf ^= 1;
    const int shift = 32 - kBits * (pass + 1);
    Pass ps;
    ps.shift = shift;
    ps.mask = pass == 0 ? 0u : ~0u << (shift + kBits);
    ps.p0 = sh.prefix[0];
    ps.p1 = sh.prefix[1];
    // while the prefixes agree every counted element is a lo key
    const bool same = ps.p0 == ps.p1;
    const int keys = same ? kBins : kKeys;
    if (tid == 0)   // CS histograms of `keys` words arrive this pass
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(smem_addr(&sh.rbar[bsel])),
                   "r"((unsigned)(CS * keys * 4))
                   : "memory");
    if (pass == 0) {
      // count each chunk as its copy lands
      for (int c = 0; c < kChunks; ++c) {
        while (!bar_try_wait(smem_addr(&sh.bar[c]), 0u)) {
        }
        count_range(0, body_s, c * per_chunk,
                    min(groups, (c + 1) * per_chunk), 0u, 0u, lane_col);
      }
    } else {
      count_range(pass, body_s, 0, groups, ps.p0, ps.p1, lane_col);
    }
    if (pass == 0)   // every CTA's barriers are initialised
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    if (warp == 0 && lane < head + tail) {
      const unsigned key = ps.key(edge);
      if (key != kNone) count_key(key, lane_col);
    }
    __syncthreads();
    // this CTA's histogram: each key pair summed over the 32 lanes (a
    // thread starts at its own bank) and stored into every CTA's receive
    // buffer, the columns cleared for the next pass. A key's total is at
    // most `slice` < 2^16, so the low halves never carry into the high
    // ones. A CTA sends pass p + 2 only after it received every CTA's pass
    // p + 1, which each sent after summing its pass p buffer.
    for (int q = tid; q < keys / 2; q += kClusterThreads) {
      unsigned s = 0u;
#pragma unroll 8
      for (int l = 0; l < 32; ++l) {
        unsigned* w = &lh[q * 32 + ((l + q) & 31)];
        s += *w;
        *w = 0u;
      }
      const unsigned dst = smem_addr(&sh.recv[bsel][rank][2 * q]);
      const unsigned bar = smem_addr(&sh.rbar[bsel]);
#pragma unroll
      for (int r = 0; r < CS; ++r)
        asm volatile(
            "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.u32"
            " [%0], {%1, %2}, [%3];\n" ::"r"(map_rank(dst, r)),
            "r"(s & 0xffffu), "r"(s >> 16), "r"(map_rank(bar, r))
            : "memory");
    }
    // every CTA's histogram of this pass has landed here
    const unsigned parity = (bsel ? used1 : used0) & 1u;
    if (bsel)
      ++used1;
    else
      ++used0;
    while (!bar_try_wait(smem_addr(&sh.rbar[bsel]), parity)) {
    }
    for (int i = tid; i < keys; i += kClusterThreads) {
      unsigned s = 0u;
#pragma unroll
      for (int r = 0; r < CS; ++r) s += sh.recv[bsel][r][i];
      sh.tot[i] = s;
    }
    if (pass + 1 == kPasses)   // no CTA sends to another again
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    __syncthreads();
    if (warp < 2) {
      const unsigned* t = sh.tot + (warp == 1 && !same ? kBins : 0);
      choose_digit(sh, warp, t, warp == 0 ? ps.p0 : ps.p1, shift);
    }
    __syncthreads();
  }
  if (rank == 0 && tid == 0)
    out[blockIdx.y] = 0.5f * (__uint_as_float(sh.prefix[0]) +
                              __uint_as_float(sh.prefix[1]));
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// dynamic shared memory of a slice: its 16-byte groups and the per-lane
// histograms
size_t cluster_smem(int slice) {
  return 16 * (((size_t)slice + 3) / 4) + 4 * (size_t)kLaneWords;
}

template <int CS>
int launch_cluster(const float* x, float* out, int B, int n, int slice,
                   cudaStream_t s) {
  const size_t smem = cluster_smem(slice);
  cudaError_t e = cudaFuncSetAttribute(
      median_cluster<CS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)CS, (unsigned)B);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)CS;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, median_cluster<CS>, x, out, n, slice);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

int run_cluster(const float* x, float* out, int B, int n, int csize,
                int slice, cudaStream_t s) {
  if (slice < 1 || slice > kMaxSlice || (long long)csize * slice < n)
    return (int)cudaErrorInvalidValue;
  switch (csize) {
    case 1: return launch_cluster<1>(x, out, B, n, slice, s);
    case 2: return launch_cluster<2>(x, out, B, n, slice, s);
    case 4: return launch_cluster<4>(x, out, B, n, slice, s);
    case 8: return launch_cluster<8>(x, out, B, n, slice, s);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------- stream route

constexpr int kThreads = 256;
constexpr int kChunk = 8192;   // elements per histogram block

// state per row: {prefix, mask, rank} for the lo target, then the hi one
__global__ void median_init(unsigned* state, int B, int n) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  unsigned* s = state + 6 * b;
  s[0] = 0u; s[1] = 0u; s[2] = (unsigned)((n - 1) / 2);
  s[3] = 0u; s[4] = 0u; s[5] = (unsigned)(n / 2);
}

__global__ void median_hist(const unsigned* __restrict__ bits,
                            const unsigned* __restrict__ state,
                            unsigned* hist, int n, int shift) {
  __shared__ unsigned sh[2 * kBins];
  int b = blockIdx.y;
  for (int i = threadIdx.x; i < 2 * kBins; i += blockDim.x) sh[i] = 0u;
  __syncthreads();
  const unsigned* s = state + 6 * b;
  unsigned p0 = s[0], m0 = s[1], p1 = s[3], m1 = s[4];
  const unsigned* row = bits + (long long)b * n;
  int start = blockIdx.x * kChunk;
  int end = min(start + kChunk, n);
  for (int i = start + threadIdx.x; i < end; i += blockDim.x) {
    unsigned v = row[i];
    unsigned d = (v >> shift) & (kBins - 1);
    if ((v & m0) == p0) atomicAdd(&sh[d], 1u);
    if ((v & m1) == p1) atomicAdd(&sh[kBins + d], 1u);
  }
  __syncthreads();
  unsigned* h = hist + (long long)b * 2 * kBins;
  for (int i = threadIdx.x; i < 2 * kBins; i += blockDim.x) {
    if (sh[i]) atomicAdd(&h[i], sh[i]);
  }
}

__global__ void median_select(unsigned* state, const unsigned* hist,
                              float* out, int B, int shift, int last) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  unsigned* s = state + 6 * b;
  const unsigned* h = hist + (long long)b * 2 * kBins;
  for (int t = 0; t < 2; ++t) {
    unsigned k = s[3 * t + 2];
    unsigned cum = 0u;
    int d = 0;
    // the rank lies inside the counted elements, so d stops below kBins
    for (; d < kBins - 1; ++d) {
      unsigned c = h[t * kBins + d];
      if (k < cum + c) break;
      cum += c;
    }
    s[3 * t + 0] |= (unsigned)d << shift;
    s[3 * t + 1] |= (unsigned)(kBins - 1) << shift;
    s[3 * t + 2] = k - cum;
  }
  if (last) out[b] = 0.5f * (__uint_as_float(s[0]) + __uint_as_float(s[3]));
}

int run_stream(const float* x, unsigned* hist, unsigned* state, float* out,
               int B, int n, cudaStream_t s) {
  const unsigned* bits = reinterpret_cast<const unsigned*>(x);
  median_init<<<(B + 127) / 128, 128, 0, s>>>(state, B, n);
  dim3 grid((unsigned)((n + kChunk - 1) / kChunk), (unsigned)B);
  for (int shift = 32 - kBits; shift >= 0; shift -= kBits) {
    cudaMemsetAsync(hist, 0, (size_t)B * 2 * kBins * sizeof(unsigned), s);
    median_hist<<<grid, kThreads, 0, s>>>(bits, state, hist, n, shift);
    median_select<<<(B + 127) / 128, 128, 0, s>>>(state, hist, out, B,
                                                  shift, shift == 0);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x: [B, n] float32 >= 0; out: [B]. csize > 0: the cluster route, csize
// CTAs a row of `slice` elements each (hist and state unused, may be null);
// csize = 0: the stream route with hist [B,2,256] and state [B,2,3] int32
// scratch.
extern "C" int cartseg_median_nonneg(const float* x, unsigned* hist,
                                     unsigned* state, float* out, int B,
                                     int n, int csize, int slice,
                                     void* stream) {
  if (B <= 0 || n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (csize > 0) return run_cluster(x, out, B, n, csize, slice, s);
  return run_stream(x, hist, state, out, B, n, s);
}
