// Pipelined Phyloformer axial-block kernels for Hopper (sm_90a), fp32 SIMT.
//
// Hand-written CUDA counterparts of the Pallas TPU kernels of
// phyloformer_tpu/ops/pallas/pipeline.py:
//
//   pf_kernel_p0      <- _kernel_p0      (pipeline.py:100): pair gather + block-0 kernel A
//   pf_kernel_a_only  <- _kernel_a_only  (pipeline.py:145): kernel A on a gathered pair tensor
//   pf_kernel_m       <- _kernel_m       (pipeline.py:176): kernel B of block i + kernel A of i+1
//   pf_kernel_z       <- _kernel_z       (pipeline.py:214): last kernel B + softplus head + site mean
//   pf_reduce_stats   <- the stats accumulation across sequential grid steps
//                        (pl.when(pi == 0) init, then +=; pipeline.py:136-142)
//
// They are built from three device bodies mirroring
// phyloformer_tpu/ops/pallas/axial_block.py: row attention (_body_row_attn,
// :172), column-stats partial sums (_body_col_stats, :204) and kernel B
// (_body_b, :224).  The plain PyTorch versions of the same functions are in
// ops/kernels/axial_block.py and ops/kernels/pipeline.py.
//
// What bounds them on the card.  Per pair-site, kernel A does 7 d x d
// products (~57 kFLOP), kernel B 2 d x d + 2 d x 4d (~82 kFLOP), M both
// (~139 kFLOP), while M moves ~1 KB of activations per pair-site: fp32
// arithmetic, not HBM, is the bound (the card's fp32 SIMT peak).
//
// Design.
// - One block of 256 threads owns a contiguous range of pairs of one batch
//   element and walks each pair row in tiles of 32 sites held in shared
//   memory.  In the d-wide products thread (c, g) computes output column c
//   for 8 sites (g, g+4, ...): a warp shares one site, so activation reads
//   are shared-memory broadcasts (float4 along k) and weight reads are one
//   coalesced 128-byte line per k, served from L1/L2 (the ~272 KB of weights
//   of kernel M exceed a block's shared memory, so they stay in the cache).
// - Row attention needs sums over the whole site axis before any output.
//   Pass 1 walks a pair's row and accumulates Σq, Σk, Σk·v in registers
//   (the one-pass ctx = Σk·v / Σk, equal to Σ(k/Σk)·v up to rounding); the
//   per-pair q-mean and ctx go to a small scratch buffer.  Pass 2 walks the
//   row again and writes x1.  In kernel M the first pass runs kernel B and
//   writes x3 in place over x1, so the second pass reads x3 back (the TPU
//   kept x3 in VMEM; here a row of up to 1024 sites does not fit shared
//   memory, and the re-read is cheap next to the arithmetic).
// - Column stats are sums over pairs, which CUDA blocks cannot carry across
//   one another.  Pass 2 runs tiles outermost and the block's pairs
//   innermost, so each thread sums its sites' stats over the block's pairs
//   in registers and writes one (L, 3d) partial per block.  pf_reduce_stats
//   then sums the partials in a fixed order: no float atomics, so two runs
//   give the same bits.
// - x1 is updated in place (A-only and M): a block reads each tile of its
//   own pair rows before it writes that tile and never reads it again.  The
//   incoming stats are read-only; the wrapper gives every kernel a fresh
//   stats buffer (ping-pong), since other blocks still read the old one.
// - Activation pointers are never marked __restrict__ or read through the
//   non-coherent cache: the in-place kernels read what the block itself
//   wrote earlier in the same launch.
//
// Numerics match the JAX bodies: masked q/k, zero-sum guards
// where(s > 0, s, 1), counts max(count, 1), the column q-mean divided by the
// number of real pairs, stats laid out [Σk | Σq | Σk·v].  Exact GELU uses
// erff, φ(x) = x > 0 ? x + 1 : exp(x), softplus = max(x,0) + log1p(exp(-|x|)).

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

// Sum of the first L entries of m over the block, in a fixed order.
__device__ float block_sum(const float* __restrict__ m, int L, Smem& S) {
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

// LayerNorm over the D channels of each tile row, one warp per row.
__device__ void ln_tile(const float* X, float* Y, const float* __restrict__ scale,
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
// sources); rows [nv, TS) are zero.
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
// stats_b: (L, 3D) global column stats of this batch element; n_pairs is
// max(real pair count, 1).  If dst is given, x3 is also written there.
template <int GELU>
__device__ void body_b(Smem& S, const float* __restrict__ bw,
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

// ---- body: row attention pass 1 (_body_row_attn sums) on S.xs ----
// Adds this tile's masked Σq, Σk, Σk·v of column c to the thread's sums.
__device__ void row_sums(Smem& S, const float* __restrict__ rw,
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
// pair's guarded q-mean and ctx = Σk·v / Σk into rowctx_p (2 x D).
__device__ void row_finish(Smem& S, float rq, float rk, float rkv, float count,
                           float* rowctx_p) {
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
    float qm = q / count;
    qm = qm > 0.f ? qm : 1.f;
    k = k > 0.f ? k : 1.f;
    rowctx_p[c] = qm;
    rowctx_p[D + c] = kv / k;
  }
  __syncthreads();
}

// ---- bodies: row attention pass 2 (_body_row_attn output) and the column
// stats (_body_col_stats) on S.xs; x1 goes to dst and the pair's masked
// column sums are added to ck/cq/ckv ----
__device__ void row_out_col_stats(Smem& S, const float* __restrict__ rw,
                                  const float* __restrict__ cw,
                                  const float* __restrict__ smask_b, float pm, int l0,
                                  int nv, float eps, const float* rowctx_p, float* dst,
                                  float (&ck)[SPT], float (&cq)[SPT], float (&ckv)[SPT]) {
  const int c = threadIdx.x & (D - 1);
  const float qm = rowctx_p[c], ctx = rowctx_p[D + c];
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

__device__ __forceinline__ void pair_range(int P, int S_, int& p0, int& p1) {
  p0 = (int)(((long long)blockIdx.x * P) / S_);
  p1 = (int)(((long long)(blockIdx.x + 1) * P) / S_);
}

// Pass 2 shared by kernel A and kernel M: tiles outermost, the block's pairs
// innermost; the row source is x_in (x for A, x3 for M) and x1 goes to
// x_out; one (L, 3D) partial of column stats per block.
__device__ void pass2(Smem& S, const float* x_in, const float* emb_b, const int* ii,
                      const int* jj, float* x_out, const float* __restrict__ smask_b,
                      const float* __restrict__ pmask_b, const float* __restrict__ rw,
                      const float* __restrict__ cw, const float* rowctx_b, float* partial_bs,
                      int p0, int p1, int L, float eps) {
  const int c = threadIdx.x & (D - 1);
  for (int l0 = 0; l0 < L; l0 += TS) {
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
                        rowctx_b + (size_t)p * 2 * D, x_out + ((size_t)p * L + l0) * D,
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

// ---- kernel A: block-0 row attention + column stats.  GATHER: the pair
// rows are emb[i] + emb[j] (_kernel_p0); else read from x (_kernel_a_only,
// x1 written in place when x_out == x). ----
template <bool GATHER>
__global__ void __launch_bounds__(NT) kernel_a(const float* x, const int* __restrict__ ii,
                                               const int* __restrict__ jj, float* x_out,
                                               const float* __restrict__ smask,
                                               const float* __restrict__ pmask,
                                               const float* __restrict__ rw,
                                               const float* __restrict__ cw, float* rowctx,
                                               float* partial, int n, int P, int L, int S_,
                                               float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  pair_range(P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  const float count = fmaxf(block_sum(smask_b, L, S), 1.f);
  const float* emb_b = GATHER ? x + (size_t)b * n * L * D : nullptr;
  const float* x_b = GATHER ? nullptr : x + (size_t)b * P * L * D;
  float* rowctx_b = rowctx + (size_t)b * P * 2 * D;

  for (int p = p0; p < p1; ++p) {
    float rq = 0.f, rk = 0.f, rkv = 0.f;
    for (int l0 = 0; l0 < L; l0 += TS) {
      const int nv = min(TS, L - l0);
      if (GATHER) {
        load_tile(S.xs, emb_b + ((size_t)ii[p] * L + l0) * D,
                  emb_b + ((size_t)jj[p] * L + l0) * D, nv);
      } else {
        load_tile(S.xs, x_b + ((size_t)p * L + l0) * D, nullptr, nv);
      }
      __syncthreads();
      row_sums(S, rw, smask_b, l0, nv, eps, rq, rk, rkv);
      __syncthreads();
    }
    row_finish(S, rq, rk, rkv, count, rowctx_b + (size_t)p * 2 * D);
  }
  pass2(S, x_b, emb_b, ii, jj, x_out + (size_t)b * P * L * D, smask_b, pmask + (size_t)b * P,
        rw, cw, rowctx_b, partial + ((size_t)b * S_ + blockIdx.x) * L * 3 * D, p0, p1, L, eps);
}

// ---- kernel M: kernel B of block i (x3 written in place over x1), then
// kernel A of block i+1 on x3 ----
template <int GELU>
__global__ void __launch_bounds__(NT) kernel_m(float* x, const float* __restrict__ stats,
                                               const float* __restrict__ smask,
                                               const float* __restrict__ pmask,
                                               const float* __restrict__ pair_count,
                                               const float* __restrict__ bw,
                                               const float* __restrict__ rw,
                                               const float* __restrict__ cw, float* rowctx,
                                               float* partial, int P, int L, int S_,
                                               float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  pair_range(P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  const float count = fmaxf(block_sum(smask_b, L, S), 1.f);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  float* x_b = x + (size_t)b * P * L * D;
  float* rowctx_b = rowctx + (size_t)b * P * 2 * D;

  for (int p = p0; p < p1; ++p) {
    float rq = 0.f, rk = 0.f, rkv = 0.f;
    for (int l0 = 0; l0 < L; l0 += TS) {
      const int nv = min(TS, L - l0);
      float* row = x_b + ((size_t)p * L + l0) * D;
      load_tile(S.xs, row, nullptr, nv);
      __syncthreads();
      body_b<GELU>(S, bw, stats_b, l0, nv, n_pairs, eps, row);
      row_sums(S, rw, smask_b, l0, nv, eps, rq, rk, rkv);
      __syncthreads();
    }
    row_finish(S, rq, rk, rkv, count, rowctx_b + (size_t)p * 2 * D);
  }
  pass2(S, x_b, nullptr, nullptr, nullptr, x_b, smask_b, pmask + (size_t)b * P, rw, cw,
        rowctx_b, partial + ((size_t)b * S_ + blockIdx.x) * L * 3 * D, p0, p1, L, eps);
}

// ---- kernel Z: last kernel B + head (d -> 1) + softplus + masked site mean ----
template <int GELU>
__global__ void __launch_bounds__(NT) kernel_z(const float* x, const float* __restrict__ stats,
                                               const float* __restrict__ smask,
                                               const float* __restrict__ pair_count,
                                               const float* __restrict__ bw,
                                               const float* __restrict__ hw, float* out,
                                               int P, int L, int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int p0, p1;
  pair_range(P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  const float count = fmaxf(block_sum(smask_b, L, S), 1.f);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const float* x_b = x + (size_t)b * P * L * D;
  const float h0 = hw[H_W + lane], h1 = hw[H_W + lane + 32], hb = hw[H_B];

  for (int p = p0; p < p1; ++p) {
    float sum = 0.f;
    for (int l0 = 0; l0 < L; l0 += TS) {
      const int nv = min(TS, L - l0);
      load_tile(S.xs, x_b + ((size_t)p * L + l0) * D, nullptr, nv);
      __syncthreads();
      body_b<GELU>(S, bw, stats_b, l0, nv, n_pairs, eps, nullptr);
      for (int s = warp; s < nv; s += NWARP) {
        const float h = warp_sum(S.xs[s * D + lane] * h0 + S.xs[s * D + lane + 32] * h1) + hb;
        sum += softplus(h) * smask_b[l0 + s];
      }
      __syncthreads();
    }
    if (lane == 0) S.wsum[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < NWARP; ++w) total += S.wsum[w];
      out[(size_t)b * P + p] = total / count;
    }
    __syncthreads();
  }
}

// ---- stats reduction: stats[b] = Σ_s partial[b, s] in slot order ----
__global__ void reduce_stats(const float* __restrict__ partial, float* __restrict__ stats,
                             int S_, int L) {
  const int b = blockIdx.y;
  const size_t n = (size_t)L * 3 * D;
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  const float* p = partial + (size_t)b * S_ * n + idx;
  float acc = 0.f;
  for (int s = 0; s < S_; ++s) acc += p[(size_t)s * n];
  stats[(size_t)b * n + idx] = acc;
}

template <typename K>
static cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
}

}  // namespace pf

using namespace pf;

extern "C" {

// Packed weight sizes, for the wrapper to check its layout against.
int pf_weight_sizes(int* out) {
  out[0] = R_SIZE;
  out[1] = C_SIZE;
  out[2] = B_SIZE;
  out[3] = H_SIZE;
  return 0;
}

int pf_kernel_p0(const float* emb, const int* ii, const int* jj, float* x1,
                 const float* smask, const float* pmask, const float* rw, const float* cw,
                 float* rowctx, float* partial, int B, int n, int P, int L, int S_, float eps,
                 void* stream) {
  cudaError_t e = allow_smem(kernel_a<true>);
  if (e != cudaSuccess) return (int)e;
  kernel_a<true><<<dim3(S_, B), NT, sizeof(Smem), (cudaStream_t)stream>>>(
      emb, ii, jj, x1, smask, pmask, rw, cw, rowctx, partial, n, P, L, S_, eps);
  return (int)cudaGetLastError();
}

int pf_kernel_a_only(float* x, const float* smask, const float* pmask, const float* rw,
                     const float* cw, float* rowctx, float* partial, int B, int P, int L,
                     int S_, float eps, void* stream) {
  cudaError_t e = allow_smem(kernel_a<false>);
  if (e != cudaSuccess) return (int)e;
  kernel_a<false><<<dim3(S_, B), NT, sizeof(Smem), (cudaStream_t)stream>>>(
      x, nullptr, nullptr, x, smask, pmask, rw, cw, rowctx, partial, 0, P, L, S_, eps);
  return (int)cudaGetLastError();
}

int pf_kernel_m(float* x, const float* stats, const float* smask, const float* pmask,
                const float* pair_count, const float* bw, const float* rw, const float* cw,
                float* rowctx, float* partial, int B, int P, int L, int S_, float eps,
                int gelu, void* stream) {
  cudaError_t e = gelu == 0 ? allow_smem(kernel_m<0>) : allow_smem(kernel_m<1>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S_, B);
  if (gelu == 0) {
    kernel_m<0><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pmask, pair_count, bw, rw, cw, rowctx, partial, P, L, S_, eps);
  } else {
    kernel_m<1><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pmask, pair_count, bw, rw, cw, rowctx, partial, P, L, S_, eps);
  }
  return (int)cudaGetLastError();
}

int pf_kernel_z(const float* x, const float* stats, const float* smask,
                const float* pair_count, const float* bw, const float* hw, float* out, int B,
                int P, int L, int S_, float eps, int gelu, void* stream) {
  cudaError_t e = gelu == 0 ? allow_smem(kernel_z<0>) : allow_smem(kernel_z<1>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S_, B);
  if (gelu == 0) {
    kernel_z<0><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pair_count, bw, hw, out, P, L, S_, eps);
  } else {
    kernel_z<1><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pair_count, bw, hw, out, P, L, S_, eps);
  }
  return (int)cudaGetLastError();
}

int pf_reduce_stats(const float* partial, float* stats, int B, int S_, int L, void* stream) {
  const int n = L * 3 * D;
  reduce_stats<<<dim3((n + 255) / 256, B), 256, 0, (cudaStream_t)stream>>>(partial, stats, S_,
                                                                          L);
  return (int)cudaGetLastError();
}

const char* pf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
