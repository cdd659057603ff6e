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
// Products, exp and sums run in fp32 whatever the input type; the
// outputs take the inputs' type.
//
// Design (simple first, as the forward): 256 threads per block; thread
// (ty, tx) of the 16x16 grid holds a 4x4 register tile of the logits,
// fed with float4 reads from padded shared-memory rows.
// - flash_bwd_dq: one block per (bnh, 64 query rows), streaming 64-key
//   tiles of K and V. dq accumulates in registers (4 rows x HD/16
//   columns a thread). The TPU kernel summed dS into drel with 0/1
//   selector matmuls; here a tile's dS is staged in shared memory and
//   summed into [64, g] fp32 drel_h / drel_w accumulators, also in shared
//   memory. Thread (row = tid/4, part = tid%4) does it: a (row, kh) sum
//   is the run of the tile's keys on grid row kh, split over the row's 4
//   threads and joined by two shuffles; a (row, kw) sum belongs to the
//   thread with kw % 4 == part. Every accumulator has one writer and a
//   fixed order of additions.
// - flash_bwd_dkv: one block per (bnh, 64-key tile), streaming 64-query
//   tiles of Q, dO, lse, D and the rows' bias factors: the TPU kernel's
//   grid over key tiles (:316-340) with its query loop inside the block.
//   Thread (ty, tx) holds P^T and dS^T for keys 4ty..4ty+3 and queries
//   tx + 16j, stages them in shared memory, and accumulates its 4 keys'
//   dk and dv rows in registers.
// Each output element is written by one block, with no atomics, so the
// gradients are the same bits from run to run. Keys and queries past S
// are masked (P = 0), so every g that the forward takes works here too.
//
// Bound on this card: operations. At [12,4096,64] one product is
// 2*12*4096^2*64 = 25.8 GFLOP; dq needs 3 (q k^T, dO v^T, dS K) and dkv 4
// (q k^T, dO v^T, P^T dO, dS^T Q): 1.15 and 1.54 ms at the 67 TFLOP/s fp32
// CUDA-core peak, against ~0.06 ms of fp32 memory traffic. The products
// run as fp32 FMAs on the CUDA cores; tensor cores (mma/wgmma), TMA and
// more than one block per SM (the tiles take 140-157 KB of shared memory
// at g = 64) are later work.

#include <type_traits>

#include "flash_relpos_common.cuh"

namespace {

using namespace flash_relpos;

constexpr unsigned kFull = 0xffffffffu;

template <int HD>
size_t dq_smem_bytes(int g) {
  const int tiles = 4 * kBQ * row_stride<HD>();   // q, dO, k, v
  const int ds = kBQ * (kBK + 4);
  const int rel = 4 * kBQ * rel_stride(g);        // rel_h, rel_w, 2 grads
  return sizeof(float) * (size_t)(tiles + ds + rel);
}

template <int HD>
size_t dkv_smem_bytes(int g) {
  const int tiles = 4 * kBQ * row_stride<HD>();   // k, v, q, dO
  const int pd = 2 * kBK * (kBQ + 4);             // P^T, dS^T
  const int rel = 2 * kBQ * rel_stride(g);
  return sizeof(float) * (size_t)(tiles + pd + rel + 2 * kBQ);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ rel_h,
             const T* __restrict__ rel_w, const T* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dq, T* __restrict__ drel_h,
             T* __restrict__ drel_w, int S, int g, float scale) {
  constexpr int ST = row_stride<HD>();
  constexpr int DST = kBK + 4;
  constexpr int CD = HD / 16;  // dq columns per thread
  static_assert(HD % 16 == 0 && (CD == 2 || CD == 4), "head_dim 32 or 64");
  const int RST = rel_stride(g);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                 // [BQ][ST]   query rows
  float* dos = qs + kBQ * ST;       // [BQ][ST]   dO rows
  float* ks = dos + kBQ * ST;       // [BK][ST]   key rows of a tile
  float* vs = ks + kBK * ST;        // [BK][ST]   value rows of a tile
  float* dss = vs + kBK * ST;       // [BQ][DST]  dS of a tile
  float* rhs = dss + kBQ * DST;     // [BQ][RST]  rel_h rows of the block
  float* rws = rhs + kBQ * RST;     // [BQ][RST]  rel_w rows of the block
  float* ghs = rws + kBQ * RST;     // [BQ][RST]  drel_h accumulators
  float* gws = ghs + kBQ * RST;     // [BQ][RST]  drel_w accumulators

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int dr = tid >> 2, part = tid & 3;  // the drel sums' layout
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)blockIdx.y * S * HD;
  const size_t rbase = (size_t)blockIdx.y * S * g;
  const size_t lbase = (size_t)blockIdx.y * S;

  load_rows<T, HD>(qs, q + base, q0, S);
  load_rows<T, HD>(dos, dout + base, q0, S);
  load_rel(rhs, rws, rel_h + rbase, rel_w + rbase, q0, S, g, RST);
  for (int e = tid; e < kBQ * RST; e += kThreads) {
    ghs[e] = 0.f;
    gws[e] = 0.f;
  }

  float lse_r[4], dd_r[4], acc[4][CD];
  bool rok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    rok[i] = r < S;
    lse_r[i] = rok[i] ? lse[lbase + r] : 0.f;
    dd_r[i] = rok[i] ? delta[lbase + r] : 0.f;
#pragma unroll
    for (int jj = 0; jj < CD; ++jj) acc[i][jj] = 0.f;
  }

  const int n_tiles = (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    const int nk = min(kBK, S - k0);
    __syncthreads();  // the previous tile's ks / vs / dss reads are done
    load_rows<T, HD>(ks, k + base, k0, S);
    load_rows<T, HD>(vs, v + base, k0, S);
    __syncthreads();

    // s = q . k and dp = dO . v over head_dim, 4 rows x 4 keys a thread
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], ao[4], b[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * ST + d);
        ao[i] = *reinterpret_cast<const float4*>(dos + (ty * 4 + i) * ST + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * ST + d);
        bv[j] = *reinterpret_cast<const float4*>(vs + (tx + 16 * j) * ST + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          dp[i][j] = fmaf(ao[i].x, bv[j].x, dp[i][j]);
          dp[i][j] = fmaf(ao[i].y, bv[j].y, dp[i][j]);
          dp[i][j] = fmaf(ao[i].z, bv[j].z, dp[i][j]);
          dp[i][j] = fmaf(ao[i].w, bv[j].w, dp[i][j]);
        }
    }

    // P = exp(logits - lse), dS = P (dp - D); 0 past S
    int kh[4], kw[4];
    bool kok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      kok[j] = kj < S;
      kh[j] = kok[j] ? kj / g : 0;
      kw[j] = kok[j] ? kj - kh[j] * g : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bias = rhs[r * RST + kh[j]] + rws[r * RST + kw[j]];
        const float p = (kok[j] && rok[i])
                            ? expf(s[i][j] * scale + bias - lse_r[i])
                            : 0.f;
        dss[r * DST + tx + 16 * j] = p * (dp[i][j] - dd_r[i]);
      }
    }
    __syncthreads();

    // dq += dS . K, 4 rows x CD columns a thread
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        da[i] = *reinterpret_cast<const float4*>(dss + (ty * 4 + i) * DST + c);
      float kb[4][CD];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int jj = 0; jj < CD; ++jj)
          kb[cc][jj] = ks[(c + cc) * ST + tx * CD + jj];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float dv4[4] = {da[i].x, da[i].y, da[i].z, da[i].w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int jj = 0; jj < CD; ++jj)
            acc[i][jj] = fmaf(dv4[cc], kb[cc][jj], acc[i][jj]);
      }
    }

    // drel_h[row, kh] += the run of this tile's keys on grid row kh
    const int kh_lo = k0 / g, kh_hi = (k0 + nk - 1) / g;
    for (int h = kh_lo; h <= kh_hi; ++h) {
      const int j_lo = max(h * g - k0, 0), j_hi = min((h + 1) * g - k0, nk);
      float sum = 0.f;
      for (int j = j_lo + part; j < j_hi; j += 4) sum += dss[dr * DST + j];
      sum += __shfl_xor_sync(kFull, sum, 1);
      sum += __shfl_xor_sync(kFull, sum, 2);
      if (part == 0) ghs[dr * RST + h] += sum;
    }
    // drel_w[row, w] += this tile's keys j with (k0 + j) % g == w, for
    // the thread's w = part, part + 4, ...
    int j0 = ((part - k0) % g + g) % g;
    for (int w = part; w < g; w += 4) {
      float sum = 0.f;
      for (int j = j0; j < nk; j += g) sum += dss[dr * DST + j];
      gws[dr * RST + w] += sum;
      j0 += 4;
      if (j0 >= g) j0 -= g;
    }
  }
  __syncthreads();  // every drel accumulator is complete

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    T* o = dq + base + (size_t)r * HD + tx * CD;
#pragma unroll
    for (int jj = 0; jj < CD; ++jj) from_f(o + jj, acc[i][jj] * scale);
  }
  for (int e = tid; e < kBQ * g; e += kThreads) {
    const int r = e / g, c = e - r * g;
    if (q0 + r >= S) continue;
    const size_t off = rbase + (size_t)q0 * g + e;
    from_f(drel_h + off, ghs[r * RST + c]);
    from_f(drel_w + off, gws[r * RST + c]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ rel_h,
              const T* __restrict__ rel_w, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dk, T* __restrict__ dv, int S, int g,
              float scale) {
  constexpr int ST = row_stride<HD>();
  constexpr int PST = kBQ + 4;
  constexpr int CD = HD / 16;  // dk / dv columns per thread
  static_assert(HD % 16 == 0 && (CD == 2 || CD == 4), "head_dim 32 or 64");
  const int RST = rel_stride(g);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ks = smem;                 // [BK][ST]   the block's key rows
  float* vs = ks + kBK * ST;        // [BK][ST]   the block's value rows
  float* qs = vs + kBK * ST;        // [BQ][ST]   query rows of a tile
  float* dos = qs + kBQ * ST;       // [BQ][ST]   dO rows of a tile
  float* pts = dos + kBQ * ST;      // [BK][PST]  P^T of a tile
  float* dsts = pts + kBK * PST;    // [BK][PST]  dS^T of a tile
  float* rhs = dsts + kBK * PST;    // [BQ][RST]  rel_h rows of a tile
  float* rws = rhs + kBQ * RST;     // [BQ][RST]  rel_w rows of a tile
  float* lses = rws + kBQ * RST;    // [BQ]       lse of a tile's rows
  float* dds = lses + kBQ;          // [BQ]       D of a tile's rows

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int k0 = blockIdx.x * kBK;
  const size_t base = (size_t)blockIdx.y * S * HD;
  const size_t rbase = (size_t)blockIdx.y * S * g;
  const size_t lbase = (size_t)blockIdx.y * S;

  load_rows<T, HD>(ks, k + base, k0, S);
  load_rows<T, HD>(vs, v + base, k0, S);

  // the thread's keys k0 + 4ty + i: grid row and column, and < S
  int kh[4], kw[4];
  bool kok[4];
  float gk[4][CD], gv[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k0 + ty * 4 + i;
    kok[i] = kj < S;
    kh[i] = kok[i] ? kj / g : 0;
    kw[i] = kok[i] ? kj - kh[i] * g : 0;
#pragma unroll
    for (int jj = 0; jj < CD; ++jj) gk[i][jj] = gv[i][jj] = 0.f;
  }

  const int n_tiles = (S + kBQ - 1) / kBQ;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();  // the previous tile's reads are done
    load_rows<T, HD>(qs, q + base, q0, S);
    load_rows<T, HD>(dos, dout + base, q0, S);
    load_rel(rhs, rws, rel_h + rbase, rel_w + rbase, q0, S, g, RST);
    for (int e = tid; e < kBQ; e += kThreads) {
      const bool ok = q0 + e < S;
      lses[e] = ok ? lse[lbase + q0 + e] : 0.f;
      dds[e] = ok ? delta[lbase + q0 + e] : 0.f;
    }
    __syncthreads();

    // s^T = k . q and dp^T = v . dO, 4 keys x 4 queries a thread
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], av[4], b[4], bo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = *reinterpret_cast<const float4*>(ks + (ty * 4 + i) * ST + d);
        av[i] = *reinterpret_cast<const float4*>(vs + (ty * 4 + i) * ST + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = *reinterpret_cast<const float4*>(qs + (tx + 16 * j) * ST + d);
        bo[j] = *reinterpret_cast<const float4*>(dos + (tx + 16 * j) * ST + d);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[i].x, b[j].x, st[i][j]);
          st[i][j] = fmaf(a[i].y, b[j].y, st[i][j]);
          st[i][j] = fmaf(a[i].z, b[j].z, st[i][j]);
          st[i][j] = fmaf(a[i].w, b[j].w, st[i][j]);
          dpt[i][j] = fmaf(av[i].x, bo[j].x, dpt[i][j]);
          dpt[i][j] = fmaf(av[i].y, bo[j].y, dpt[i][j]);
          dpt[i][j] = fmaf(av[i].z, bo[j].z, dpt[i][j]);
          dpt[i][j] = fmaf(av[i].w, bo[j].w, dpt[i][j]);
        }
    }

    // P^T and dS^T of the tile into shared memory; 0 past S
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = tx + 16 * j;
      const bool rok = q0 + r < S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float bias = rhs[r * RST + kh[i]] + rws[r * RST + kw[i]];
        const float p = (kok[i] && rok)
                            ? expf(st[i][j] * scale + bias - lses[r])
                            : 0.f;
        pts[(ty * 4 + i) * PST + r] = p;
        dsts[(ty * 4 + i) * PST + r] = p * (dpt[i][j] - dds[r]);
      }
    }
    __syncthreads();

    // dv += P^T . dO, dk += dS^T . Q over the tile's queries
#pragma unroll 2
    for (int c = 0; c < kBQ; c += 4) {
      float4 pa[4], da[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pa[i] = *reinterpret_cast<const float4*>(pts + (ty * 4 + i) * PST + c);
        da[i] = *reinterpret_cast<const float4*>(dsts + (ty * 4 + i) * PST + c);
      }
      float ob[4][CD], qb[4][CD];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int jj = 0; jj < CD; ++jj) {
          ob[cc][jj] = dos[(c + cc) * ST + tx * CD + jj];
          qb[cc][jj] = qs[(c + cc) * ST + tx * CD + jj];
        }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p4[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
        const float d4[4] = {da[i].x, da[i].y, da[i].z, da[i].w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int jj = 0; jj < CD; ++jj) {
            gv[i][jj] = fmaf(p4[cc], ob[cc][jj], gv[i][jj]);
            gk[i][jj] = fmaf(d4[cc], qb[cc][jj], gk[i][jj]);
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!kok[i]) continue;
    const size_t off = base + (size_t)(k0 + ty * 4 + i) * HD + tx * CD;
#pragma unroll
    for (int jj = 0; jj < CD; ++jj) {
      from_f(dk + off + jj, gk[i][jj] * scale);
      from_f(dv + off + jj, gv[i][jj]);
    }
  }
}

// calls f(T{}, HD) for the inputs' type and head_dim
template <typename F>
int dispatch(int hd, int bf16, F f) {
  using H32 = std::integral_constant<int, 32>;
  using H64 = std::integral_constant<int, 64>;
  if (hd == 64 && !bf16) return f(float{}, H64{});
  if (hd == 64 && bf16) return f(__nv_bfloat16{}, H64{});
  if (hd == 32 && !bf16) return f(float{}, H32{});
  if (hd == 32 && bf16) return f(__nv_bfloat16{}, H32{});
  return (int)cudaErrorInvalidValue;
}

template <typename K>
int set_smem(K kern, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// q, k, v, dout: [bnh, S, hd]; rel_h, rel_w: [bnh, S, g]; all contiguous,
// of one type: float32 (bf16 == 0) or bfloat16 (bf16 == 1). S == g*g.
// lse, delta: fp32 [bnh, S] (the forward's logsumexp and rowsum(dO * O)).
// Writes dq [bnh, S, hd] and drel_h, drel_w [bnh, S, g] in the inputs'
// type.
extern "C" int cartseg_flash_relpos_bwd_dq(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dq, void* drel_h, void* drel_w, int bnh, int S, int g, int hd,
    int bf16, float scale, void* stream) {
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  return dispatch(hd, bf16, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int HD = decltype(h)::value;
    auto kern = flash_bwd_dq<T, HD>;
    const size_t smem = dq_smem_bytes<HD>(g);
    const int err = set_smem(kern, smem);
    if (err) return err;
    kern<<<dim3((S + kBQ - 1) / kBQ, bnh), kThreads, smem,
           (cudaStream_t)stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(rel_h),
        static_cast<const T*>(rel_w), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dq), static_cast<T*>(drel_h), static_cast<T*>(drel_w),
        S, g, scale);
    return (int)cudaGetLastError();
  });
}

// The same inputs; writes dk and dv [bnh, S, hd] in the inputs' type.
extern "C" int cartseg_flash_relpos_bwd_dkv(
    const void* q, const void* k, const void* v, const void* rel_h,
    const void* rel_w, const void* dout, const void* lse, const void* delta,
    void* dk, void* dv, int bnh, int S, int g, int hd, int bf16, float scale,
    void* stream) {
  if (bnh <= 0 || S <= 0) return (int)cudaGetLastError();
  return dispatch(hd, bf16, [&](auto t, auto h) {
    using T = decltype(t);
    constexpr int HD = decltype(h)::value;
    auto kern = flash_bwd_dkv<T, HD>;
    const size_t smem = dkv_smem_bytes<HD>(g);
    const int err = set_smem(kern, smem);
    if (err) return err;
    kern<<<dim3((S + kBK - 1) / kBK, bnh), kThreads, smem,
           (cudaStream_t)stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(rel_h),
        static_cast<const T*>(rel_w), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), S, g, scale);
    return (int)cudaGetLastError();
  });
}
