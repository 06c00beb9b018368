// The fused backward of one axial block for Hopper (sm_90a), fp32 SIMT.
//
// Hand-written CUDA counterparts of the Pallas TPU kernels of
// phyloformer_tpu/ops/pallas/axial_block_bwd.py that the fused training step
// runs (kernels C and E, _kernel_c and _kernel_e, run their products on the
// tensor cores in axial_bwd_tc.cu; their fp32 SIMT form, described below,
// is in the git history):
//
//   pf_kernel_d  <- _kernel_d (:281): the column-attention backward from A1
//                   and the stats -> g1; the column LN and q/k/v gradients
//   pf_kernel_e1 <- _kernel_e1 (:492): above 1024 sites, each pair's raw row
//                   sums [Σq | Σk | Σk·v | Σd_attn·q] (B, P, 4d)
//   pf_kernel_e2 <- _kernel_e2 (:534): the row backward finalized from those
//                   sums, site tile by site tile -> gx and the row gradients
//
// The accumulation of A1 and of every weight gradient across sequential grid
// steps (pl.when(first) init, then +=; :241-274, :340-365, :450-476,
// :610-639) is pf_reduce_slots of slot_reduce.cu, the slot reduction it
// shares with the forward's column stats.
//
// The plain PyTorch versions are kernel_d_plain, kernel_e1_plain and
// kernel_e2_plain in
// ops/kernels/axial_block_bwd.py.  The device helpers (LayerNorm, the d-wide
// and 4d-wide products, tile loads) are those of axial_bodies.cuh.
//
// What bounds them on the card.  Per pair-site, D does 4 d x d + 6 d x H
// products (~36 kFLOP), E1 2 d x d + 2 d x H (~17 kFLOP), E2 5 d x d + 6 d x H
// (~44 kFLOP, the products of kernel E),
// each moving at most 768 B of activations: fp32 arithmetic, not HBM, is the
// bound.  The partial reduction is bound by bytes instead: one add per 4
// bytes read.  Its weight-gradient partials are narrow, (1, 396, 4808) for D
// and (1, 396, 8968) for E and E2, so its 128-column tiles give only 38 and 71
// blocks on 132 SMs; those partials come from L2, where 8 warps a block with
// four 16-byte loads in flight a thread beat torch.sum without splitting the
// slots over blocks (slot_reduce.cu).
//
// Design.
// - Blocks of 256 threads own a contiguous range of pairs of one batch
//   element (grid: pair slots x B) and walk 32-site tiles held in shared
//   memory, as the forward kernels do.  The d-wide products use the
//   forward's mapping (thread (c, g): column c of sites g, g+4, ...), so a
//   head's 16 lanes sit in 16 neighbouring lanes of one warp and the head
//   contractions are 16-lane shuffles.
// - Sums across the grid.  Pallas adds A1 and the weight gradients over
//   sequential grid steps; CUDA blocks run in parallel, so every block keeps
//   its own sums and writes them to its slot of a partial buffer, and
//   pf_reduce_slots sums the slots in an order fixed by the shapes and
//   the SM count (reduce.reduce_plan).  No float atomics: two runs give the
//   same bits, equal to reduce.reduce_slots_ordered's.  The slot counts
//   depend only on the shapes.
// - Weight gradients are products a^T b over pair-sites.  Per tile, each
//   thread sums a fixed strip of the gradient matrix over the tile's sites in
//   registers (float4 broadcasts of a, one column of b) and adds the strip to
//   the block's copy in shared memory.  The (d, H) q/k gradients are one
//   value per thread, kept in registers.
// - The row backward needs sums over the whole site axis per pair, and a
//   row of up to 1024 sites (256 KB per operand) exceeds shared memory:
//   pass 1 sums q, k, k*v and d_attn*q over the sites, a finalize turns them
//   into the pair's ctx, q-mean and the d_ctx / d_qm terms (the E1/E2
//   algebra of axial_block_bwd.py:483-490), and pass 2 emits gx and the
//   weight gradients tile by tile.  Kernel E (axial_bwd_tc.cu) walks each
//   row twice in one block.
// - Above 1024 sites, as in JAX, the passes are two kernels.  E1 is pass 1:
//   one block walks the whole rows of a contiguous range of pairs (grid:
//   pair slots x B, as A1), so each pair's sums come from one block, in
//   registers, combined over the four site groups in a fixed order; no
//   atomics.  E2 reads the sums from device memory, so a row need not be
//   walked whole by one block: its grid is (pair slots x site chunks, B), as
//   A2's, with one weight-gradient partial per block.  Their stages are
//   the two passes written as device functions.
// - Kernel D's per-site terms (from the stats and A1) are the same for every
//   pair, so D walks tiles outermost and builds them once per tile.
// - A ragged last tile is zero-filled on load and every sum stops at the
//   tile's real sites.  Zero-sum guards where(s > 0, s, 1) and the
//   positive-sum gates of _derive_col_site_grads are kept exactly.
//   Activation offsets are size_t.

#include "axial_bwd.cuh"

namespace pf {

static_assert(NT == D * H, "the (d, H) q/k gradients map one thread to one entry");

struct SmemD {
  float xs[TS * D];  // x1
  float hs[TS * D];  // column LN output, then d_hc
  float gs[TS * D];  // g2, then g1
  float vs[TS * D];  // d_v; at the end the per-warp vector sums
  float tctx[TS * D];  // per-site terms of the tile: ctx_e, d_skv_e
  float tskv[TS * D];
  float tqmh[TS * H];  // qm_H, d_sq_H, d_sk_H
  float tsqh[TS * H];
  float tskh[TS * H];
  float dzq[TS * H];  // d_zq_H, d_zk_H of the tile
  float dzk[TS * H];
  float dwv[D * D];
};

struct SmemE {
  float xs[TS * D];  // x
  float hs[TS * D];  // row LN output, then d_h
  float gs[TS * D];  // g1, then gx
  float vs[TS * D];  // d_v; at the end the per-warp vector sums
  float as[TS * D];  // row attention output before Wo
  float dzq[TS * H];
  float dzk[TS * H];
  float red[4 * NG * D];  // pass-1 sums of the site groups
  float pqm[D];  // the pair's qm, ctx, d_skv and the head terms (per lane)
  float pctx[D];
  float pskv[D];
  float pqmh[D];
  float pskh[D];
  float psqh[D];
  float wsum[NWARP];
  float dwv[D * D];
  float dwo[D * D];
};

struct SmemE1 {
  float xs[TS * D];  // x
  float hs[TS * D];  // row LN output
  float gs[TS * D];  // g1
  float red[4 * NG * D];  // the site groups' sums
};

// Sum over the 16 lanes of a head (neighbouring lanes of one warp).
__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = HD / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float guard(float s) { return s > 0.f ? s : 1.f; }

// 1 where a raw sum is positive, else 0: gradient passes only there.
__device__ __forceinline__ float gate(float s) { return s > 0.f ? 1.f : 0.f; }

__device__ __forceinline__ float phi_grad(float z) { return z > 0.f ? 1.f : expf(z); }

__device__ __forceinline__ float gelu_grad(float u) {
  const float cdf = 0.5f * (1.f + erff(u * 0.7071067811865476f));
  return cdf + u * (expf(-0.5f * u * u) * 0.3989422804014327f);
}

// acc[k, c] += sum_{s < nv} A[s, k] * G[s, c] for a (TS x KR) tile A and a
// (TS x KC) tile G.  Thread t sums column c = t % KC of the R rows
// [r0, r0 + R) in registers, then adds them to acc (shared memory).
template <int KR, int KC>
__device__ __forceinline__ void outer_acc(const float* A, const float* G, float* acc, int nv) {
  constexpr int R = KR * KC / NT;
  static_assert(R % 4 == 0 && NT % KC == 0, "strip of whole float4 rows");
  const int c = threadIdx.x % KC, r0 = (threadIdx.x / KC) * R;
  float s[R];
#pragma unroll
  for (int k = 0; k < R; ++k) s[k] = 0.f;
#pragma unroll 2
  for (int site = 0; site < nv; ++site) {
    const float g = G[site * KC + c];
#pragma unroll
    for (int k = 0; k < R; k += 4) {
      const float4 a = *reinterpret_cast<const float4*>(A + site * KR + r0 + k);
      s[k] = fmaf(a.x, g, s[k]);
      s[k + 1] = fmaf(a.y, g, s[k + 1]);
      s[k + 2] = fmaf(a.z, g, s[k + 2]);
      s[k + 3] = fmaf(a.w, g, s[k + 3]);
    }
  }
#pragma unroll
  for (int k = 0; k < R; ++k) acc[(r0 + k) * KC + c] += s[k];
}

// LayerNorm backward of rows [0, nv), one warp per row: X holds the LN
// input, DH the upstream gradient and G the residual gradient, which becomes
// G + dx (also written to dst).  Adds the columns lane and lane + 32 of
// sum dh*xhat, sum dh, sum G (before) and sum G (after) to the warp's sums.
static __device__ void ln_bwd_rows(const float* X, const float* DH, float* G,
                                   const float* __restrict__ scale, float eps, int nv,
                                   float* dst, float (&ds)[2], float (&db)[2],
                                   float (&g_in)[2], float (&g_out)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float s0 = scale[lane], s1 = scale[lane + 32];
  for (int s = warp; s < nv; s += NWARP) {
    const float a = X[s * D + lane], b = X[s * D + lane + 32];
    const float mu = warp_sum(a + b) * (1.f / D);
    const float da = a - mu, db_ = b - mu;
    const float var = warp_sum(da * da + db_ * db_) * (1.f / D);
    const float r = 1.f / sqrtf(var + eps);
    const float xh0 = da * r, xh1 = db_ * r;
    const float dh0 = DH[s * D + lane], dh1 = DH[s * D + lane + 32];
    const float gx0 = dh0 * s0, gx1 = dh1 * s1;
    const float m1 = warp_sum(gx0 + gx1) * (1.f / D);
    const float m2 = warp_sum(gx0 * xh0 + gx1 * xh1) * (1.f / D);
    const float g0 = G[s * D + lane], g1 = G[s * D + lane + 32];
    const float o0 = g0 + r * (gx0 - m1 - xh0 * m2);
    const float o1 = g1 + r * (gx1 - m1 - xh1 * m2);
    G[s * D + lane] = o0;
    G[s * D + lane + 32] = o1;
    dst[(size_t)s * D + lane] = o0;
    dst[(size_t)s * D + lane + 32] = o1;
    ds[0] += dh0 * xh0;
    ds[1] += dh1 * xh1;
    db[0] += dh0;
    db[1] += dh1;
    g_in[0] += g0;
    g_in[1] += g1;
    g_out[0] += o0;
    g_out[1] += o1;
  }
}

// red[(v * NWARP + warp) * D + col] <- the warp's column sums of vector v.
__device__ __forceinline__ void put_warp_sums(float* red, int v, const float (&x)[2]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  red[(v * NWARP + warp) * D + lane] = x[0];
  red[(v * NWARP + warp) * D + lane + 32] = x[1];
}

// Column t (< D) of vector v, summed over the warps in order.
__device__ __forceinline__ float warp_sums_total(const float* red, int v) {
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) total += red[(v * NWARP + w) * D + threadIdx.x];
  return total;
}

// Column c of the thread's site-group sums x, summed over the NG groups in
// order by the threads t < D (red holds NG * D floats).
__device__ __forceinline__ float group_sums_total(float* red, float x) {
  red[threadIdx.x] = x;  // (g, c) at g * D + c
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x < D) {
#pragma unroll
    for (int g = 0; g < NG; ++g) total += red[g * D + threadIdx.x];
  }
  __syncthreads();
  return total;
}

// (k, h) = (t / H, t % H) entry of sum_{s < nv} A[s, k] * Z[s, h], and for
// t < H also sum_{s < nv} Z[s, t]: the (d, H) q/k gradients of one tile.
__device__ __forceinline__ void dh_grad(const float* A, const float* Zq, const float* Zk,
                                        int nv, float& wq, float& wk, float& bq, float& bk) {
  const int k = threadIdx.x / H, h = threadIdx.x % H;
  for (int s = 0; s < nv; ++s) {
    const float a = A[s * D + k];
    wq = fmaf(a, Zq[s * H + h], wq);
    wk = fmaf(a, Zk[s * H + h], wk);
    if (threadIdx.x < H) {
      bq += Zq[s * H + threadIdx.x];
      bk += Zk[s * H + threadIdx.x];
    }
  }
}

// d_h[site_of(i), c] = sum_c' dv[., c'] wv[c, c'] + sum_h (dzq wq[c, h] +
// dzk wk[c, h]): the gradient of the LN output from the q/k/v projections.
__device__ __forceinline__ void dh_from_qkv(const float* vs, const float* dzq, const float* dzk,
                                            const float* __restrict__ w, float (&out)[SPT]) {
  const int c = threadIdx.x & (D - 1);
  float acc[1][SPT];
  mm_d<D, 1>(vs, w + AG_WVT, nullptr, nullptr, acc);
  float wq[H], wk[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    wq[h] = w[AG_WQ + c * H + h];
    wk[h] = w[AG_WK + c * H + h];
  }
#pragma unroll
  for (int i = 0; i < SPT; ++i) {
    const int s = site_of(i);
    float v = acc[0][i];
#pragma unroll
    for (int h = 0; h < H; ++h) v += dzq[s * H + h] * wq[h] + dzk[s * H + h] * wk[h];
    out[i] = v;
  }
}

// ---- kernel D ----
__global__ void __launch_bounds__(NT) kernel_d(
    const float* __restrict__ x1, const float* __restrict__ g2, const float* __restrict__ stats,
    const float* __restrict__ a1, const float* __restrict__ pmask,
    const float* __restrict__ pair_count, const float* __restrict__ w, float* __restrict__ g1,
    float* __restrict__ w_part, int P, int L, int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  SmemD& S = *reinterpret_cast<SmemD*>(smem_raw);
  const int b = blockIdx.y, slot = blockIdx.x, t = threadIdx.x, c = t & (D - 1), hc = c / HD;
  int p0, p1;
  split_range(slot, P, S_, p0, p1);
  for (int e = t; e < D * D; e += NT) S.dwv[e] = 0.f;
  float vds[2] = {0.f, 0.f}, vdb[2] = {0.f, 0.f}, unused[2] = {0.f, 0.f};
  float dwq = 0.f, dwk = 0.f, dbq = 0.f, dbk = 0.f, dbv = 0.f;
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const float* a1_b = a1 + (size_t)b * L * D;
  const float bq = w[AG_BQE + c], bk = w[AG_BKE + c], bv = w[AG_BV + c];

  for (int l0 = 0; l0 < L; l0 += TS) {
    const int nv = min(TS, L - l0);
    // the per-site terms (_derive_col_site_grads), once per tile
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      float sk_raw = 0.f, sq_raw = 0.f, kv = 0.f, a1v = 0.f;
      if (s < nv) {
        const float* st = stats_b + (size_t)(l0 + s) * 3 * D;
        sk_raw = st[c];
        sq_raw = st[D + c];
        kv = st[2 * D + c];
        a1v = a1_b[(size_t)(l0 + s) * D + c];
      }
      const float qm_raw = sq_raw / n_pairs;
      const float qm_e = guard(qm_raw), sk_e = guard(sk_raw);
      const float ctx_e = kv / sk_e;
      // every lane runs every head_sum: the gates multiply, as in JAX
      const float sk_h = head_sum(sk_e) / HD;
      const float d_sk_h = -head_sum(a1v * ctx_e) / sk_h * gate(head_sum(sk_raw));
      const float qm_h = head_sum(qm_e) / HD;
      const float d_qm_h =
          -head_sum(ctx_e * qm_e * a1v) / (qm_h * qm_h) * gate(head_sum(qm_raw));
      S.tctx[s * D + c] = ctx_e;
      S.tskv[s * D + c] = a1v / sk_e;
      if ((c & (HD - 1)) == 0) {
        S.tqmh[s * H + hc] = qm_h;
        S.tsqh[s * H + hc] = d_qm_h / n_pairs;
        S.tskh[s * H + hc] = d_sk_h;
      }
    }
    for (int p = p0; p < p1; ++p) {
      const size_t off = (((size_t)b * P + p) * L + l0) * D;
      const float pm = pmask[(size_t)b * P + p];
      load_tile(S.xs, x1 + off, nullptr, nv);
      load_tile(S.gs, g2 + off, nullptr, nv);
      __syncthreads();
      ln_tile(S.xs, S.hs, w + AG_LNS, w + AG_LNB, eps);
      __syncthreads();
      {
        float acc[3][SPT], da[1][SPT];
        mm_d<D, 3>(S.hs, w + AG_WQE, w + AG_WKE, w + AG_WV, acc);
        mm_d<D, 1>(S.gs, w + AG_WOT, nullptr, nullptr, da);  // d_attn = g2 Wo_c^T
#pragma unroll
        for (int i = 0; i < SPT; ++i) {
          const int s = site_of(i);
          const float zq = acc[0][i] + bq, zk = acc[1][i] + bk, v = acc[2][i] + bv;
          const float skv = S.tskv[s * D + c];
          const float d_q = head_sum(da[0][i] * S.tctx[s * D + c]) / S.tqmh[s * H + hc] +
                            S.tsqh[s * H + hc];
          const float d_k = S.tskh[s * H + hc] + head_sum(skv * v);
          const bool real = s < nv;
          const float dzq = real ? d_q * phi_grad(zq) * pm : 0.f;
          const float dzk = real ? d_k * phi_grad(zk) * pm : 0.f;
          const float dv = real ? skv * phi(zk) * pm : 0.f;
          S.vs[s * D + c] = dv;
          if ((c & (HD - 1)) == 0) {
            S.dzq[s * H + hc] = dzq;
            S.dzk[s * H + hc] = dzk;
          }
          dbv += dv;
        }
      }
      __syncthreads();
      outer_acc<D, D>(S.hs, S.vs, S.dwv, nv);  // dWv += hc^T d_v
      dh_grad(S.hs, S.dzq, S.dzk, nv, dwq, dwk, dbq, dbk);
      {
        float dh[SPT];
        dh_from_qkv(S.vs, S.dzq, S.dzk, w, dh);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < SPT; ++i) S.hs[site_of(i) * D + c] = dh[i];
      }
      __syncthreads();
      ln_bwd_rows(S.xs, S.hs, S.gs, w + AG_LNS, eps, nv, g1 + off, vds, vdb, unused, unused);
      __syncthreads();
    }
  }

  float* wp = w_part + ((size_t)b * S_ + slot) * NWD;
  const float dbv_total = group_sums_total(S.vs, dbv);
  put_warp_sums(S.vs, 0, vds);
  put_warp_sums(S.vs, 1, vdb);
  __syncthreads();
  for (int e = t; e < D * D; e += NT) wp[WA_WV + e] = S.dwv[e];
  wp[WA_WQ + t] = dwq;
  wp[WA_WK + t] = dwk;
  if (t < H) {
    wp[WA_BQ + t] = dbq;
    wp[WA_BK + t] = dbk;
  }
  if (t < D) {
    wp[WA_LNS + t] = warp_sums_total(S.vs, 0);
    wp[WA_LNB + t] = warp_sums_total(S.vs, 1);
    wp[WA_BV + t] = dbv_total;
  }
}

// ---- the L-tiled row backward: the stages of kernel E as device functions ----
// E1 runs stage 1 (kernel E's pass 1) and writes the raw sums; E2 reads them
// and runs stages 2 and 3 (the finalize and pass 2) on a chunk of the site
// tiles.

// max(real site count, 1) of the block's batch element, summed in a fixed
// order; S.wsum holds NWARP floats.
__device__ __forceinline__ float row_site_count(SmemE& S, const float* __restrict__ smask_b,
                                                int L) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  float v = 0.f;
  for (int l = t; l < L; l += NT) v += smask_b[l];
  v = warp_sum(v);
  if (lane == 0) S.wsum[warp] = v;
  __syncthreads();
  float count = 0.f;
#pragma unroll
  for (int ww = 0; ww < NWARP; ++ww) count += S.wsum[ww];
  return fmaxf(count, 1.f);
}

// Stage 1 over the whole row of one pair (x_row, g_row: L x D): the thread's
// masked sums of column c over its site group, r = [q, k, k*v, d_attn*q].
__device__ __forceinline__ void row_bwd_sums(SmemE1& S, const float* x_row, const float* g_row,
                                             const float* __restrict__ smask_b,
                                             const float* __restrict__ w, int L, float eps,
                                             float (&r)[4]) {
  const int c = threadIdx.x & (D - 1);
  const float bq = w[AG_BQE + c], bk = w[AG_BKE + c], bv = w[AG_BV + c];
  for (int l0 = 0; l0 < L; l0 += TS) {
    const int nv = min(TS, L - l0);
    load_tile(S.xs, x_row + (size_t)l0 * D, nullptr, nv);
    load_tile(S.gs, g_row + (size_t)l0 * D, nullptr, nv);
    __syncthreads();
    ln_tile(S.xs, S.hs, w + AG_LNS, w + AG_LNB, eps);
    __syncthreads();
    float acc[3][SPT], da[1][SPT];
    mm_d<D, 3>(S.hs, w + AG_WQE, w + AG_WKE, w + AG_WV, acc);
    mm_d<D, 1>(S.gs, w + AG_WOT, nullptr, nullptr, da);  // d_attn = g1 Wo^T
#pragma unroll
    for (int i = 0; i < SPT; ++i) {
      const int s = site_of(i);
      const float m = s < nv ? smask_b[l0 + s] : 0.f;
      const float q = phi(acc[0][i] + bq) * m, k = phi(acc[1][i] + bk) * m;
      r[0] += q;
      r[1] += k;
      r[2] += k * (acc[2][i] + bv);
      r[3] += da[0][i] * q;
    }
    __syncthreads();
  }
}

// The pair's raw sums [Σq | Σk | Σk·v | Σd_attn·q] of column t, the NG site
// groups' sums r added in a fixed order; valid in threads t < D.
__device__ __forceinline__ void row_bwd_pair_sums(SmemE1& S, const float (&r)[4],
                                                  float (&sum)[4]) {
  const int c = threadIdx.x & (D - 1), g = threadIdx.x / D;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    S.red[(v * NG + g) * D + c] = r[v];
    sum[v] = 0.f;
  }
  __syncthreads();
  if (threadIdx.x < D) {
#pragma unroll
    for (int gg = 0; gg < NG; ++gg)
#pragma unroll
      for (int v = 0; v < 4; ++v) sum[v] += S.red[(v * NG + gg) * D + threadIdx.x];
  }
}

// Stage 2, in threads t < D (warps 0 and 1: whole warps, so the head shuffles
// are safe): the pair's ctx, q-mean and d_ctx / d_qm terms from its raw sums
// and the site count (_kernel_e2, axial_block_bwd.py:563-581), into S.p*.
__device__ __forceinline__ void row_bwd_finalize(SmemE& S, const float (&sum)[4], float count) {
  const int c = threadIdx.x;
  const float sq_raw = sum[0] / count, sk_raw = sum[1], skv = sum[2], sdq = sum[3];
  const float qm = guard(sq_raw), sk = guard(sk_raw);
  const float ctx = skv / sk;
  const float d_ctx = sdq / qm;
  const float sk_h = head_sum(sk) / HD;
  const float d_sk_h = -head_sum(d_ctx * ctx) / sk_h * gate(head_sum(sk_raw));
  const float qm_h = head_sum(qm) / HD;
  const float d_qm_h = -head_sum(ctx * sdq) / (qm_h * qm_h) * gate(head_sum(sq_raw));
  S.pqm[c] = qm;
  S.pctx[c] = ctx;
  S.pskv[c] = d_ctx / sk;
  S.pqmh[c] = qm_h;
  S.pskh[c] = d_sk_h;
  S.psqh[c] = d_qm_h / count;
}

// The row weight gradients a block sums in registers (the rest are in SmemE).
struct RowGrads {
  float vds[2] = {0.f, 0.f}, vdb[2] = {0.f, 0.f}, vbo[2] = {0.f, 0.f};
  float dwq = 0.f, dwk = 0.f, dbq = 0.f, dbk = 0.f, dbv = 0.f;
};

// Stage 3 over the site tiles [t0, t1) of one pair row, from the pair's
// constants in S.p* (visible to every thread): gx to gx_row and the tiles'
// weight gradients added to a and to S.dwv / S.dwo.
__device__ __forceinline__ void row_bwd_emit(SmemE& S, const float* x_row, const float* g_row,
                                             float* gx_row, const float* __restrict__ smask_b,
                                             const float* __restrict__ w, int L, int t0, int t1,
                                             float eps, RowGrads& a) {
  const int c = threadIdx.x & (D - 1);
  const float bq = w[AG_BQE + c], bk = w[AG_BKE + c], bv = w[AG_BV + c];
  const float qm = S.pqm[c], ctx = S.pctx[c], skv = S.pskv[c];
  const float qm_h = S.pqmh[c], d_sk_h = S.pskh[c], d_sq_h = S.psqh[c];
  float unused[2] = {0.f, 0.f};
  for (int tile = t0; tile < t1; ++tile) {
    const int l0 = tile * TS, nv = min(TS, L - l0);
    const size_t off = (size_t)l0 * D;
    load_tile(S.xs, x_row + off, nullptr, nv);
    load_tile(S.gs, g_row + off, nullptr, nv);
    __syncthreads();
    ln_tile(S.xs, S.hs, w + AG_LNS, w + AG_LNB, eps);
    __syncthreads();
    {
      float acc[3][SPT], da[1][SPT];
      mm_d<D, 3>(S.hs, w + AG_WQE, w + AG_WKE, w + AG_WV, acc);
      mm_d<D, 1>(S.gs, w + AG_WOT, nullptr, nullptr, da);
#pragma unroll
      for (int i = 0; i < SPT; ++i) {
        const int s = site_of(i);
        const float m = s < nv ? smask_b[l0 + s] : 0.f;
        const float zq = acc[0][i] + bq, zk = acc[1][i] + bk, v = acc[2][i] + bv;
        const float q = phi(zq) * m, k = phi(zk) * m;
        const float d_q = head_sum(da[0][i] * ctx) / qm_h + d_sq_h;
        const float d_k = d_sk_h + head_sum(skv * v);
        const float dzq = d_q * phi_grad(zq) * m, dzk = d_k * phi_grad(zk) * m;
        const float dv = skv * k;
        S.vs[s * D + c] = dv;
        S.as[s * D + c] = (q / qm) * ctx;
        if ((c & (HD - 1)) == 0) {
          S.dzq[s * H + c / HD] = dzq;
          S.dzk[s * H + c / HD] = dzk;
        }
        a.dbv += dv;
      }
    }
    __syncthreads();
    outer_acc<D, D>(S.hs, S.vs, S.dwv, nv);  // dWv += h^T d_v
    outer_acc<D, D>(S.as, S.gs, S.dwo, nv);  // dWo += attn^T g1
    dh_grad(S.hs, S.dzq, S.dzk, nv, a.dwq, a.dwk, a.dbq, a.dbk);
    {
      float dh[SPT];
      dh_from_qkv(S.vs, S.dzq, S.dzk, w, dh);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < SPT; ++i) S.hs[site_of(i) * D + c] = dh[i];
    }
    __syncthreads();
    ln_bwd_rows(S.xs, S.hs, S.gs, w + AG_LNS, eps, nv, gx_row + off, a.vds, a.vdb, a.vbo,
                unused);
    __syncthreads();
  }
}

// The block's row weight gradients (layout WA_*, NWE floats) to wp.
__device__ __forceinline__ void store_row_grads(SmemE& S, const RowGrads& a, float* wp) {
  const int t = threadIdx.x;
  const float dbv_total = group_sums_total(S.vs, a.dbv);
  put_warp_sums(S.vs, 0, a.vds);
  put_warp_sums(S.vs, 1, a.vdb);
  put_warp_sums(S.vs, 2, a.vbo);
  __syncthreads();
  for (int e = t; e < D * D; e += NT) {
    wp[WA_WV + e] = S.dwv[e];
    wp[WA_WO + e] = S.dwo[e];
  }
  wp[WA_WQ + t] = a.dwq;
  wp[WA_WK + t] = a.dwk;
  if (t < H) {
    wp[WA_BQ + t] = a.dbq;
    wp[WA_BK + t] = a.dbk;
  }
  if (t < D) {
    wp[WA_LNS + t] = warp_sums_total(S.vs, 0);
    wp[WA_LNB + t] = warp_sums_total(S.vs, 1);
    wp[WA_BO + t] = warp_sums_total(S.vs, 2);
    wp[WA_BV + t] = dbv_total;
  }
}

// ---- kernel E1: each pair's raw row sums (B, P, 4D) ----
__global__ void __launch_bounds__(NT) kernel_e1(
    const float* __restrict__ x, const float* __restrict__ g1, const float* __restrict__ smask,
    const float* __restrict__ w, float* __restrict__ rowsums, int P, int L, int S_,
    float eps) {
  extern __shared__ float4 smem_raw[];
  SmemE1& S = *reinterpret_cast<SmemE1*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  for (int p = p0; p < p1; ++p) {
    const size_t row = ((size_t)b * P + p) * L * D;
    float r[4] = {0.f, 0.f, 0.f, 0.f}, sum[4];
    row_bwd_sums(S, x + row, g1 + row, smask_b, w, L, eps, r);
    row_bwd_pair_sums(S, r, sum);
    if (threadIdx.x < D) {
      float* rs = rowsums + ((size_t)b * P + p) * 4 * D;
#pragma unroll
      for (int v = 0; v < 4; ++v) rs[v * D + threadIdx.x] = sum[v];
    }
  }
}

// ---- kernel E2: gx and the row weight gradients of a pair slot / site chunk ----
__global__ void __launch_bounds__(NT) kernel_e2(
    const float* __restrict__ x, const float* __restrict__ g1,
    const float* __restrict__ rowsums, const float* __restrict__ smask,
    const float* __restrict__ w, float* __restrict__ gx, float* __restrict__ w_part, int P,
    int L, int SP, int SC, float eps) {
  extern __shared__ float4 smem_raw[];
  SmemE& S = *reinterpret_cast<SmemE*>(smem_raw);
  const int b = blockIdx.y, slot = blockIdx.x / SC, chunk = blockIdx.x % SC;
  int p0, p1, t0, t1;
  split_range(slot, P, SP, p0, p1);
  split_range(chunk, n_tiles_of(L), SC, t0, t1);
  for (int e = threadIdx.x; e < D * D; e += NT) S.dwv[e] = S.dwo[e] = 0.f;
  RowGrads a;
  const float* smask_b = smask + (size_t)b * L;
  const float count = row_site_count(S, smask_b, L);
  for (int p = p0; p < p1; ++p) {
    const size_t row = ((size_t)b * P + p) * L * D;
    if (threadIdx.x < D) {
      const float* rs = rowsums + ((size_t)b * P + p) * 4 * D;
      const float sum[4] = {rs[threadIdx.x], rs[D + threadIdx.x], rs[2 * D + threadIdx.x],
                            rs[3 * D + threadIdx.x]};
      row_bwd_finalize(S, sum, count);
    }
    __syncthreads();
    row_bwd_emit(S, x + row, g1 + row, gx + row, smask_b, w, L, t0, t1, eps, a);
  }
  store_row_grads(S, a, w_part + ((size_t)b * SP * SC + blockIdx.x) * NWE);
}

template <typename Sm, typename K>
static cudaError_t allow_smem_of(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Sm));
}

}  // namespace pf

using namespace pf;

extern "C" {

// Packed group and gradient sizes, for the wrapper to check its layout.
int pf_bwd_sizes(int* out) {
  out[0] = AG_SIZE;
  out[1] = NWD;
  out[2] = NWE;
  out[3] = 4 * D;  // floats of one pair's row sums (E1 -> E2)
  return 0;
}

int pf_kernel_d(const float* x1, const float* g2, const float* stats, const float* a1,
                const float* pmask, const float* pair_count, const float* w, float* g1,
                float* w_part, int B, int P, int L, int S_, float eps, void* stream) {
  cudaError_t e = allow_smem_of<SmemD>(kernel_d);
  if (e != cudaSuccess) return (int)e;
  kernel_d<<<dim3(S_, B), NT, sizeof(SmemD), (cudaStream_t)stream>>>(
      x1, g2, stats, a1, pmask, pair_count, w, g1, w_part, P, L, S_, eps);
  return (int)cudaGetLastError();
}

int pf_kernel_e1(const float* x, const float* g1, const float* smask, const float* w,
                 float* rowsums, int B, int P, int L, int S_, float eps, void* stream) {
  cudaError_t e = allow_smem_of<SmemE1>(kernel_e1);
  if (e != cudaSuccess) return (int)e;
  kernel_e1<<<dim3(S_, B), NT, sizeof(SmemE1), (cudaStream_t)stream>>>(x, g1, smask, w,
                                                                       rowsums, P, L, S_, eps);
  return (int)cudaGetLastError();
}

int pf_kernel_e2(const float* x, const float* g1, const float* rowsums, const float* smask,
                 const float* w, float* gx, float* w_part, int B, int P, int L, int SP, int SC,
                 float eps, void* stream) {
  cudaError_t e = allow_smem_of<SmemE>(kernel_e2);
  if (e != cudaSuccess) return (int)e;
  kernel_e2<<<dim3(SP * SC, B), NT, sizeof(SmemE), (cudaStream_t)stream>>>(
      x, g1, rowsums, smask, w, gx, w_part, P, L, SP, SC, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
