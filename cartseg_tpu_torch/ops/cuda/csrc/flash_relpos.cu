// Flash attention with SAM's decomposed relative-position bias, forward,
// on Hopper.
//
// Replaces the TPU kernel `_kernel` (cartseg_tpu/ops/pallas/
// flash_attention.py:88, pallas_call at :162). For one (batch*head) slice
// of S = g*g tokens on a g x g grid:
//   out[i] = sum_j p_ij v_j,
//   p_ij   = softmax_j(scale * (q_i . k_j) + rel_h[i, j / g] + rel_w[i, j % g])
// with an fp32 online softmax (running max from -1e30, IEEE expf), for
// float32 inputs and output (bfloat16 takes flash_relpos_fwd_tc.cu). The
// (S, S) logits and
// bias are never written to device memory: a block rebuilds each 64x64
// tile of them in registers from Q, K and the two [S, g] factors, which
// is what the TPU kernel kept out of HBM too. Given a non-null lse (the
// training forward) it also writes each row's fp32 logsumexp m + log(l)
// for the backward (flash_relpos_bwd.cu), as the TPU kernel's lse_ref
// (:129-130); the inference call passes null and writes nothing.
//
// Design (simple first): one block of 256 threads per (bnh, 64 query
// rows); a loop inside the block streams 64-key tiles of K and V through
// shared memory. The TPU kernel's sequential grid and its 0/1 selector
// matmuls for the bias do not carry over: here the block's [64, g] slices
// of rel_h and rel_w sit in shared memory and every logit looks its two
// terms up (at g = 64 a key tile is one grid row, so rel_h is one scalar
// per query row per tile). Thread (ty, tx) of the 16x16 grid owns query
// rows 4*ty..4*ty+3; in the logit tile it owns key columns tx + 16*j,
// in the output columns tx*HD/16 ... Row max and row sum are reduced
// across the 16 threads of a row with warp shuffles. Shared rows are
// padded so that the float4 reads of the two products and the P stores
// are free of bank conflicts.
//
// Bound on this card: operations. At the ViT-B global block [12,4096,64]
// the two products are 2 * 2*12*4096^2*64 = 51.5 GFLOP, against 75.5 MB
// of fp32 inputs and output: 0.77 ms at the 67 TFLOP/s fp32 CUDA-core
// peak, 0.023 ms of memory traffic. Both products run as fp32 FMAs on
// the CUDA cores, 4x4 outer products from shared memory. This kernel is
// the float32 route; bfloat16 inputs go to the tensor-core kernel of
// flash_relpos_fwd_tc.cu (the C entry point below dispatches both).

#include <math_constants.h>

#include "flash_relpos_common.cuh"

namespace {

using namespace flash_relpos;

constexpr float kNegInit = -1e30f;

template <int HD>
size_t smem_bytes(int g) {
  const int qs = kBQ * row_stride<HD>();
  const int ks = kBK * row_stride<HD>();
  const int vs = kBK * HD;
  const int ps = kBQ * (kBK + 4);
  const int rs = 2 * kBQ * rel_stride(g);
  return sizeof(float) * (size_t)(qs + ks + vs + ps + rs);
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_relpos_fwd(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ rel_h,
                 const float* __restrict__ rel_w, float* __restrict__ out,
                 float* __restrict__ lse, int S, int g, float scale) {
  constexpr int QST = row_stride<HD>();
  constexpr int KST = row_stride<HD>();
  constexpr int PST = kBK + 4;
  constexpr int CD = HD / 16;  // output columns per thread
  static_assert(HD % 16 == 0 && (CD == 2 || CD == 4), "head_dim 32 or 64");
  const int RST = rel_stride(g);

  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qs = smem;                 // [BQ][QST]  query rows
  float* ks = qs + kBQ * QST;       // [BK][KST]  key rows
  float* vs = ks + kBK * KST;       // [BK][HD]   value rows
  float* ps = vs + kBK * HD;        // [BQ][PST]  probabilities of a tile
  float* rhs = ps + kBQ * PST;      // [BQ][RST]  rel_h rows of the block
  float* rws = rhs + kBQ * RST;     // [BQ][RST]  rel_w rows of the block

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = (size_t)blockIdx.y * S * HD;
  const size_t rbase = (size_t)blockIdx.y * S * g;

  // the block's query rows, and its rows of the two bias factors
  load_rows<HD>(qs, q + base, q0, S);
  load_rel(rhs, rws, rel_h + rbase, rel_w + rbase, q0, S, g, RST);

  float m[4], l[4], acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInit;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < CD; ++jj) acc[i][jj] = 0.f;
  }

  const int n_tiles = (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's ks / vs / ps reads are done
    for (int e = tid; e < kBK * HD / 4; e += kThreads) {
      const int c = e / (HD / 4), d = (e % (HD / 4)) * 4;
      float4 tk = make_float4(0.f, 0.f, 0.f, 0.f), tv = tk;
      if (k0 + c < S) {
        const size_t off = base + (size_t)(k0 + c) * HD + d;
        tk = load4(k + off);
        tv = load4(v + off);
      }
      *reinterpret_cast<float4*>(ks + c * KST + d) = tk;
      *reinterpret_cast<float4*>(vs + c * HD + d) = tv;
    }
    __syncthreads();

    // s = q . k over head_dim, 4 rows x 4 keys per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty * 4 + i) * QST + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(ks + (tx + 16 * j) * KST + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

    // logits = scale * s + (rel_h + rel_w); keys past S get -inf
    int kh[4], kw[4];
    bool kok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kj = k0 + tx + 16 * j;
      kok[j] = kj < S;
      kh[j] = kok[j] ? kj / g : 0;  // a key past S reads row 0, unused
      kw[j] = kok[j] ? kj - kh[j] * g : 0;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float mx = kNegInit;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float bias = rhs[r * RST + kh[j]] + rws[r * RST + kw[j]];
        s[i][j] = kok[j] ? s[i][j] * scale + bias : -CUDART_INF_F;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are lanes xor 1..8 of one half-warp
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * PST + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < CD; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();

    // acc += p . v, 4 rows x CD output columns per thread
#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float4 pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[i] = *reinterpret_cast<const float4*>(ps + (ty * 4 + i) * PST + c);
      float vb[4][CD];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vr = vs + (c + cc) * HD + tx * CD;
        if constexpr (CD == 4) {
          const float4 t = *reinterpret_cast<const float4*>(vr);
          vb[cc][0] = t.x; vb[cc][1] = t.y; vb[cc][2] = t.z; vb[cc][3] = t.w;
        } else {
          const float2 t = *reinterpret_cast<const float2*>(vr);
          vb[cc][0] = t.x; vb[cc][1] = t.y;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv[4] = {pa[i].x, pa[i].y, pa[i].z, pa[i].w};
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int jj = 0; jj < CD; ++jj)
            acc[i][jj] = fmaf(pv[cc], vb[cc][jj], acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= S) continue;
    float* o = out + base + (size_t)r * HD + tx * CD;
#pragma unroll
    for (int jj = 0; jj < CD; ++jj) o[jj] = acc[i][jj] / l[i];
    // the training forward's logsumexp, m + log(l) as the TPU kernel
    if (lse != nullptr && tx == 0)
      lse[(size_t)blockIdx.y * S + r] = m[i] + logf(l[i]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* rh,
           const void* rw, void* out, float* lse, int bnh, int S, int g,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_bytes<HD>(g);
  auto kern = flash_relpos_fwd<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kBQ - 1) / kBQ, bnh);
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

// q, k, v, out: [bnh, S, hd]; rel_h, rel_w: [bnh, S, g]; all contiguous,
// of one type: float32 (bf16 == 0, this file's CUDA-core kernel) or
// bfloat16 (bf16 == 1, 16-byte aligned: flash_relpos_fwd_tc.cu). S == g*g.
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
  if (hd == 64)
    return launch<64>(q, k, v, rel_h, rel_w, out, l, bnh, S, g, scale, st);
  if (hd == 32)
    return launch<32>(q, k, v, rel_h, rel_w, out, l, bnh, S, g, scale, st);
  return (int)cudaErrorInvalidValue;
}
