// Device bodies of the Phyloformer axial-block kernels, shared by
// axial_pipeline.cu (P0, A-only, A, M, Z) and axial_fused.cu (A1, A2, B).
//
// They mirror phyloformer_tpu/ops/pallas/axial_block.py: row attention
// (_body_row_attn, :172), column-stats partial sums (_body_col_stats, :204)
// and kernel B (_body_b, :224).  Each works on one tile of TS sites of one
// pair row held in shared memory (Smem); see the design note at the top of
// axial_pipeline.cu.  Everything here has internal linkage, so each source
// that includes this header gets its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "axial_pipeline.cuh"

namespace pf {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(x); }

template <int GELU>
__device__ __forceinline__ float gelu(float x) {
  if (GELU == 0) return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ int site_of(int i) { return (int)(threadIdx.x / D) + NG * i; }

__device__ __forceinline__ int n_tiles_of(int L) { return (L + TS - 1) / TS; }

// [lo, hi) of part `idx` when n items are split into `parts` contiguous parts.
__device__ __forceinline__ void split_range(int idx, int n, int parts, int& lo, int& hi) {
  lo = (int)(((long long)idx * n) / parts);
  hi = (int)(((long long)(idx + 1) * n) / parts);
}

// Sum of the first L entries of m over the block, in a fixed order.
static __device__ float block_sum(const float* __restrict__ m, int L, Smem& S) {
  float v = 0.f;
  for (int l = threadIdx.x; l < L; l += NT) v += m[l];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) S.wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) total += S.wsum[w];
  __syncthreads();
  return total;
}

// S.count <- max(real site count, 1); visible after the next __syncthreads.
// Kept in shared memory rather than a register through the row passes.
__device__ __forceinline__ void set_site_count(const float* __restrict__ smask_b, int L,
                                               Smem& S) {
  const float count = fmaxf(block_sum(smask_b, L, S), 1.f);
  if (threadIdx.x == 0) S.count = count;
}

// LayerNorm over the D channels of each tile row, one warp per row.
static __device__ void ln_tile(const float* X, float* Y, const float* __restrict__ scale,
                               const float* __restrict__ bias, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float s0 = scale[lane], s1 = scale[lane + 32];
  const float b0 = bias[lane], b1 = bias[lane + 32];
  for (int s = warp; s < TS; s += NWARP) {
    const float a = X[s * D + lane], b = X[s * D + lane + 32];
    const float mu = warp_sum(a + b) * (1.f / D);
    const float da = a - mu, db = b - mu;
    const float var = warp_sum(da * da + db * db) * (1.f / D);
    const float r = 1.f / sqrtf(var + eps);
    Y[s * D + lane] = da * r * s0 + b0;
    Y[s * D + lane + 32] = db * r * s1 + b1;
  }
}

// acc[w][i] = Σ_k A[site_of(i), k] · W_w[k, c] for NW (K x D) weights that
// share the activation reads; A is a (TS x K) tile in shared memory.
template <int K, int NW>
__device__ __forceinline__ void mm_d(const float* A, const float* __restrict__ w0,
                                     const float* __restrict__ w1,
                                     const float* __restrict__ w2, float (&acc)[NW][SPT]) {
  const float* W[3] = {w0, w1, w2};
  const int c = threadIdx.x & (D - 1);
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < SPT; ++i) acc[w][i] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float wv[NW][4];
#pragma unroll
    for (int w = 0; w < NW; ++w)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wv[w][kk] = __ldg(W[w] + (k + kk) * D + c);
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(A + site_of(i) * K + k);
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        acc[w][i] = fmaf(a.x, wv[w][0], acc[w][i]);
        acc[w][i] = fmaf(a.y, wv[w][1], acc[w][i]);
        acc[w][i] = fmaf(a.z, wv[w][2], acc[w][i]);
        acc[w][i] = fmaf(a.w, wv[w][3], acc[w][i]);
      }
    }
  }
}

// acc[s] = Σ_k A[s, k] · W[k, t] for the FFN up-projection (D x F), t = thread.
__device__ __forceinline__ void mm_up(const float* A, const float* __restrict__ W,
                                      float (&acc)[TS]) {
  const int t = threadIdx.x;
#pragma unroll
  for (int s = 0; s < TS; ++s) acc[s] = 0.f;
#pragma unroll 1
  for (int k = 0; k < D; k += 4) {
    const float w0 = __ldg(W + (k + 0) * F + t), w1 = __ldg(W + (k + 1) * F + t);
    const float w2 = __ldg(W + (k + 2) * F + t), w3 = __ldg(W + (k + 3) * F + t);
#pragma unroll
    for (int s = 0; s < TS; ++s) {
      const float4 a = *reinterpret_cast<const float4*>(A + s * D + k);
      acc[s] = fmaf(a.x, w0, acc[s]);
      acc[s] = fmaf(a.y, w1, acc[s]);
      acc[s] = fmaf(a.z, w2, acc[s]);
      acc[s] = fmaf(a.w, w3, acc[s]);
    }
  }
}

// xs <- rows [0, nv) of a (·, D) row-major source (or the sum of two
// sources); rows [nv, TS) are zero, so a ragged last tile reads nothing
// past the end of the row.
__device__ __forceinline__ void load_tile(float* xs, const float* src, const float* src2,
                                          int nv) {
  for (int e = threadIdx.x; e < TS * D / 4; e += NT) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e / (D / 4) < nv) {
      v = reinterpret_cast<const float4*>(src)[e];
      if (src2 != nullptr) {
        const float4 u = reinterpret_cast<const float4*>(src2)[e];
        v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
      }
    }
    reinterpret_cast<float4*>(xs)[e] = v;
  }
}

// ---- body: kernel B (_body_b) on the tile in S.xs, in place: x1 -> x3 ----
// stats_b: (L, 3D) global column stats of this batch element, read one site
// tile at a time; n_pairs is max(real pair count, 1).  If dst is given, x3
// is also written there.
template <int GELU>
static __device__ void body_b(Smem& S, const float* __restrict__ bw,
                              const float* __restrict__ stats_b, int l0, int nv, float n_pairs,
                              float eps, float* dst) {
  const int c = threadIdx.x & (D - 1);
  ln_tile(S.xs, S.hs, bw + B_CNS, bw + B_CNB, eps);
  __syncthreads();
  {
    float acc[1][SPT];
    mm_d<D, 1>(S.hs, bw + B_CWQ, nullptr, nullptr, acc);
    const float bq = bw[B_CBQ + c];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      float ksum = 1.f, qsum = 1.f, kv = 0.f;
      if (s < nv) {
        const float* st = stats_b + (size_t)(l0 + s) * 3 * D;
        ksum = st[c];
        qsum = st[D + c];
        kv = st[2 * D + c];
      }
      float qm = qsum / n_pairs;
      qm = qm > 0.f ? qm : 1.f;
      ksum = ksum > 0.f ? ksum : 1.f;
      const float ctx = kv / ksum;
      S.as[s * D + c] = (phi(acc[0][i] + bq) / qm) * ctx;
    }
  }
  __syncthreads();
  {
    float acc[1][SPT];
    mm_d<D, 1>(S.as, bw + B_CWO, nullptr, nullptr, acc);
    const float bo = bw[B_CBO + c];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      S.xs[s * D + c] = S.xs[s * D + c] + (acc[0][i] + bo);  // x2
    }
  }
  __syncthreads();
  ln_tile(S.xs, S.hs, bw + B_FNS, bw + B_FNB, eps);
  __syncthreads();
  {
    float acc[TS];
    mm_up(S.hs, bw + B_W1, acc);
    const float b1 = bw[B_B1 + threadIdx.x];
#pragma unroll
    for (int s = 0; s < TS; ++s) S.fs[s * F + threadIdx.x] = gelu<GELU>(acc[s] + b1);
  }
  __syncthreads();
  {
    float acc[1][SPT];
    mm_d<F, 1>(S.fs, bw + B_W2, nullptr, nullptr, acc);
    const float b2 = bw[B_B2 + c];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      const float x3 = S.xs[s * D + c] + (acc[0][i] + b2);
      S.xs[s * D + c] = x3;
      if (dst != nullptr && s < nv) dst[(size_t)s * D + c] = x3;
    }
  }
  __syncthreads();
}

// ---- body: row attention pass 1 (_body_row_attn sums, _kernel_a1) on S.xs ----
// Adds this tile's masked Σq, Σk, Σk·v of column c to the thread's sums.
// Sites at or past nv have mask 0, so a ragged tile adds nothing for them.
static __device__ void row_sums(Smem& S, const float* __restrict__ rw,
                                const float* __restrict__ smask_b, int l0, int nv, float eps,
                                float& rq, float& rk, float& rkv) {
  const int c = threadIdx.x & (D - 1);
  ln_tile(S.xs, S.hs, rw + R_LNS, rw + R_LNB, eps);
  __syncthreads();
  float acc[3][SPT];
  mm_d<D, 3>(S.hs, rw + R_WQ, rw + R_WK, rw + R_WV, acc);
  const float bq = rw[R_BQ + c], bk = rw[R_BK + c], bv = rw[R_BV + c];
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = site_of(i);
    const float m = s < nv ? smask_b[l0 + s] : 0.f;
    const float q = phi(acc[0][i] + bq) * m;
    const float k = phi(acc[1][i] + bk) * m;
    const float v = acc[2][i] + bv;
    rq += q;
    rk += k;
    rkv += k * v;
  }
}

// Combine the four site groups' row sums in a fixed order and store the
// pair's raw sums [Σq | Σk | Σk·v] (3 x D, _kernel_a1's rowstats layout).
static __device__ void store_row_sums(Smem& S, float rq, float rk, float rkv, float* rowsum_p) {
  const int c = threadIdx.x & (D - 1), g = threadIdx.x / D;
  S.red[(0 * NG + g) * D + c] = rq;
  S.red[(1 * NG + g) * D + c] = rk;
  S.red[(2 * NG + g) * D + c] = rkv;
  __syncthreads();
  if (threadIdx.x < D) {
    float q = 0.f, k = 0.f, kv = 0.f;
#pragma unroll
    for (int gg = 0; gg < NG; ++gg) {
      q += S.red[(0 * NG + gg) * D + c];
      k += S.red[(1 * NG + gg) * D + c];
      kv += S.red[(2 * NG + gg) * D + c];
    }
    rowsum_p[c] = q;
    rowsum_p[D + c] = k;
    rowsum_p[2 * D + c] = kv;
  }
  __syncthreads();
}

// Row walk of pass 1 over a pair row x_row (L x D) or, when emb_i is given,
// over emb_i + emb_j (the in-kernel pair gather); stores the raw sums.
static __device__ void row_pass1(Smem& S, const float* x_row, const float* emb_i,
                                 const float* emb_j, const float* __restrict__ rw,
                                 const float* __restrict__ smask_b, int L, float eps,
                                 float* rowsum_p) {
  float rq = 0.f, rk = 0.f, rkv = 0.f;
  for (int l0 = 0; l0 < L; l0 += TS) {
    const int nv = min(TS, L - l0);
    if (emb_i != nullptr) {
      load_tile(S.xs, emb_i + (size_t)l0 * D, emb_j + (size_t)l0 * D, nv);
    } else {
      load_tile(S.xs, x_row + (size_t)l0 * D, nullptr, nv);
    }
    __syncthreads();
    row_sums(S, rw, smask_b, l0, nv, eps, rq, rk, rkv);
    __syncthreads();
  }
  store_row_sums(S, rq, rk, rkv, rowsum_p);
}

// ---- bodies: row attention pass 2 (_body_row_attn output, _kernel_a2) and
// the column stats (_body_col_stats) on S.xs.  rs holds the pair's raw row
// sums [Σq | Σk | Σk·v], finalized here with the guards where(s > 0, s, 1)
// and the site count S.count (_kernel_a2's q_mean and ctx = Σk·v / Σk);
// x1 goes to dst and the pair's masked column sums are
// added to ck/cq/ckv ----
static __device__ void row_out_col_stats(Smem& S, const float* __restrict__ rw,
                                         const float* __restrict__ cw,
                                         const float* __restrict__ smask_b, float pm, int l0,
                                         int nv, float eps, const float* rs, float* dst,
                                         float (&ck)[SPT], float (&cq)[SPT],
                                         float (&ckv)[SPT]) {
  const int c = threadIdx.x & (D - 1);
  float qm = rs[c] / S.count;
  qm = qm > 0.f ? qm : 1.f;
  float ks = rs[D + c];
  ks = ks > 0.f ? ks : 1.f;
  const float ctx = rs[2 * D + c] / ks;
  ln_tile(S.xs, S.hs, rw + R_LNS, rw + R_LNB, eps);
  __syncthreads();
  {
    float acc[1][SPT];
    mm_d<D, 1>(S.hs, rw + R_WQ, nullptr, nullptr, acc);
    const float bq = rw[R_BQ + c];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      const float m = s < nv ? smask_b[l0 + s] : 0.f;
      S.as[s * D + c] = (phi(acc[0][i] + bq) * m / qm) * ctx;
    }
  }
  __syncthreads();
  {
    float acc[1][SPT];
    mm_d<D, 1>(S.as, rw + R_WO, nullptr, nullptr, acc);
    const float bo = rw[R_BO + c];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      const float x1 = S.xs[s * D + c] + (acc[0][i] + bo);
      S.xs[s * D + c] = x1;
      if (s < nv) dst[(size_t)s * D + c] = x1;
    }
  }
  __syncthreads();
  ln_tile(S.xs, S.hs, cw + C_LNS, cw + C_LNB, eps);
  __syncthreads();
  {
    float acc[3][SPT];
    mm_d<D, 3>(S.hs, cw + C_WQ, cw + C_WK, cw + C_WV, acc);
    const float bq = cw[C_BQ + c], bk = cw[C_BK + c], bv = cw[C_BV + c];
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const float qc = phi(acc[0][i] + bq) * pm;
      const float kc = phi(acc[1][i] + bk) * pm;
      const float vc = acc[2][i] + bv;
      ck[i] += kc;
      cq[i] += qc;
      ckv[i] += kc * vc;
    }
  }
  __syncthreads();
}

// Pass 2 shared by kernels A, M and A2: site tiles [t0, t1) outermost, the
// pairs [p0, p1) innermost.  The row source is x_in (or emb[i] + emb[j]),
// x1 goes to x_out; rowsum_b holds each pair's raw row sums [Σq | Σk | Σk·v]
// (3 x D) and S.count the site count (set_site_count).  The column stats of
// the block's pairs go to rows [t0·TS, t1·TS) ∩ [0, L) of its (L, 3D) partial.
static __device__ void pass2(Smem& S, const float* x_in, const float* emb_b, const int* ii,
                             const int* jj, float* x_out, const float* __restrict__ smask_b,
                             const float* __restrict__ pmask_b, const float* __restrict__ rw,
                             const float* __restrict__ cw, const float* rowsum_b,
                             float* partial_bs, int p0, int p1, int t0, int t1, int L,
                             float eps) {
  const int c = threadIdx.x & (D - 1);
  for (int t = t0; t < t1; ++t) {
    const int l0 = t * TS;
    const int nv = min(TS, L - l0);
    float ck[SPT], cq[SPT], ckv[SPT];
#pragma unroll
    for (int i = 0; i < SPT; ++i) ck[i] = cq[i] = ckv[i] = 0.f;
    for (int p = p0; p < p1; ++p) {
      if (emb_b != nullptr) {
        load_tile(S.xs, emb_b + ((size_t)ii[p] * L + l0) * D,
                  emb_b + ((size_t)jj[p] * L + l0) * D, nv);
      } else {
        load_tile(S.xs, x_in + ((size_t)p * L + l0) * D, nullptr, nv);
      }
      __syncthreads();
      row_out_col_stats(S, rw, cw, smask_b, pmask_b[p], l0, nv, eps,
                        rowsum_b + (size_t)p * 3 * D, x_out + ((size_t)p * L + l0) * D,
                        ck, cq, ckv);
    }
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      if (s < nv) {
        float* pp = partial_bs + (size_t)(l0 + s) * 3 * D;
        pp[c] = ck[i];
        pp[D + c] = cq[i];
        pp[2 * D + c] = ckv[i];
      }
    }
  }
}

template <typename K>
static cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
}

}  // namespace pf
