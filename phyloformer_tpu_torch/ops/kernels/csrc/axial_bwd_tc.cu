// Backward kernels C, D, E and E2 of one axial block for Hopper (sm_90a):
// split-TF32 products on the tensor cores.
//
// Hand-written CUDA counterparts of the Pallas TPU kernels of
// phyloformer_tpu/ops/pallas/axial_block_bwd.py:
//
//   pf_kernel_c  <- _kernel_c (axial_block_bwd.py:176): x2 and the FFN
//                   recomputed from x1 and the column stats; the FFN backward
//                   -> g2; d_attn = g2 Wo_c^T and A1 = sum_p d_attn * qn
//                   (B, L, d); the FFN and column out-projection gradients
//   pf_kernel_d  <- _kernel_d (:281): the column-attention backward from A1
//                   and the stats -> g1; the column LN and q/k/v gradients
//   pf_kernel_e  <- _kernel_e (:372): the row-attention backward on whole
//                   rows -> gx; the row LN and q/k/v/o gradients (up to 1024
//                   sites)
//   pf_kernel_e2 <- _kernel_e2 (:534): above 1024 sites, the same backward
//                   finalized from E1's raw row sums, on a chunk of site tiles
//
// Kernel E1 (the raw row sums) is a streaming pass in axial_bwd.cu.  The
// accumulation of A1 and of the weight gradients across the grid is
// pf_reduce_slots (slot_reduce.cu), as for every kernel.  The plain PyTorch
// versions are kernel_c_plain, kernel_d_plain, kernel_e_plain and
// kernel_e2_plain in ops/kernels/axial_block_bwd.py.
//
// What bounds them on the card.  Per pair-site C does 5 d x 4d + 3 d x d +
// 1 d x d (the head-expanded q projection) products, D 4 d x d + 6 d x H,
// E and E2 5 d x d + 6 d x H, on at most 768 B of activations.  At three
// TF32 passes over 495 TFLOP/s (dense TF32) that is 1.1 ns for C, 0.22 ns
// for D and 0.27 ns for E a pair-site, against 0.23 ns for 768 B at
// 3.35 TB/s: tensor-core arithmetic bounds C and E, the bytes (just) D.
//
// Design (as the forward's, axial_pipeline.cu, with the backward's needs).
// - Every product runs on mma.sync.m16n8k8 TF32 in three passes (NP = 3,
//   the fp32 backward): both operands split into big = cvt.rna(x) and
//   small = cvt.rna(x - big), a_small b_big + a_big b_small + a_big b_big
//   summed in fp32, within ~2^-22 of the fp32 product; or in one pass (NP =
//   1, the reduced-precision backward, JAX's prec = DEFAULT): a_big b_big
//   alone, tf32_rna(a) tf32_rna(b) accumulated in fp32, the small planes
//   neither written nor read and only the big halves of the packed weights
//   loaded (the shared-memory layouts stay those of three passes: at one
//   pass the small planes go unused).  Each kernel is built for both and the
//   entries take the count.  That covers the activation products (C:
//   the q projection, attn Wo_c, hf W1, g3 W2^T, du W1^T, g2 Wo_c^T; D, E
//   and E2: [q | k] = h [Wq | Wk] on the d x H weights, h Wv, g Wo^T, and
//   d_h = [dv | dz] [Wv^T ; Wq^T ; Wk^T]) and the weight gradients,
//   products with the sites as K (C: dW1 = hf^T du, dW2 = a^T g3, dWo_c =
//   attn^T g2; D, E and E2: dWv = h^T dv, [dWq | dWk] = h^T [dzq | dzk];
//   E and E2: dWo = attn^T g1).
// - Weights are packed once per step and layer (c_group and e_group in the
//   wrapper, pipeline.pack_mma): split and in fragment order, one 16-byte
//   load a lane from L1/L2.  D (the column attention) and E, E2 (the row
//   attention) read the same packed layout (EM_*); E1 reads the flat group.
// - Activation operands are split once where they are made and kept as big
//   and small planes in shared memory.  The weight gradients read them
//   transposed (rows t, columns g) and the products over the channels
//   straight (rows g, columns t); the row stride 72 with the swizzle
//   c ^ (r & 4) serves both without bank conflicts (axial_bwd.cuh).
// - Tiles of 32 sites, the next tile's x and g copied in with cp.async
//   (zero-filled past the row's end) while this one computes.  64-site
//   tiles do not fit: C holds seven tile operands at once (x, g3, their next
//   tiles, three split planes) beside its FFN gradients, E eight split
//   planes and four fp32 tiles at two blocks an SM.
// - Weight-gradient sums.  The mma accumulators of a gradient cover 32
//   sites of one tile (grad_tile: the tensor cores' accumulation does not
//   round to nearest, so no chain runs longer), and the tiles' sums are
//   added in fp32.  D's and E's (dWv, E's dWo: 16 values a thread each;
//   [dWq|dWk]: 4 in warps 0-3) stay in registers across the block's whole
//   range, so they keep no gradient in shared memory and run two blocks
//   (16 warps) an SM within 128 registers.  C's are 36,864 values, 144 a
//   thread: dWo_c (16) stays in registers, dW1 and dW2 (128 a thread) are
//   added per tile into 128 KB of shared memory, each thread into float4
//   slots of its own (no barrier, no bank conflict).  In registers they
//   would leave nothing for the products, and the tiles and those 128 KB
//   fill the SM: C runs one block an SM, of C_WARPS = 8 warps with up to
//   255 registers a thread.  The kernel is written for 16 warps too (128
//   registers each); measured on the card (bwd_timing), 16 ran 4% slower
//   than 8.
// - Sums across the grid: per-block partials in a fixed order, no atomics
//   (two runs give the same bits).  C and D walk site tiles outermost and
//   their pairs innermost: C sums A1 in registers (one (L, d) partial per
//   block), D builds the tile's per-site terms (ctx, a1 / sk and the head
//   terms of _derive_col_site_grads) once into shared memory, where E reads
//   the pair's.  E walks each pair row twice (pass 1: Σq, Σk, Σk·v,
//   Σd_attn·q over the sites, combined over the rows and the two row warps
//   in a fixed order; the finalize of _kernel_e; pass 2: gx and the
//   gradients).  E2 is E's pass 2 on a chunk of site tiles (grid: pair
//   slots x site chunks), the pair's terms finalized from E1's sums; one
//   body serves both (row_bwd).
// - Zero-sum guards where(s > 0, s, 1), the positive-sum gates, the masks
//   and ragged last tiles are as in the plain versions; LayerNorm, φ, GELU
//   (erff), the gates and the LN backward stay fp32 on the SIMT cores.

#include "axial_bwd.cuh"

namespace pf {
namespace bt {

__device__ __forceinline__ int sw(int r, int c) { return r * BXS + (c ^ (r & 4)); }

__device__ __forceinline__ float head_sum(float v) {
#pragma unroll
  for (int o = HD / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float guard(float s) { return s > 0.f ? s : 1.f; }
__device__ __forceinline__ float gate(float s) { return s > 0.f ? 1.f : 0.f; }
__device__ __forceinline__ float phi_grad(float z) { return z > 0.f ? 1.f : expf(z); }

__device__ __forceinline__ float gelu_grad(float u) {
  const float cdf = 0.5f * (1.f + erff(u * 0.7071067811865476f));
  return cdf + u * (expf(-0.5f * u * u) * 0.3989422804014327f);
}

// (a, b) at (r, c), (r, c + 1) of the big plane P and the small plane P + PLN.
// One pass (NP = 1) reads the big plane alone, so only it is written.
template <int ST, int PLN, int NP = PASSES_SPLIT>
__device__ __forceinline__ void put_split(float* P, int r, int c, float a, float b) {
  const int i = r * ST + (c ^ (r & 4));
  if constexpr (NP == PASSES_ONE) {
    st2(P + i, __uint_as_float(to_tf32(a)), __uint_as_float(to_tf32(b)));
  } else {
    uint32_t ba, sa, bb, sb;
    split_tf32(a, ba, sa);
    split_tf32(b, bb, sb);
    st2(P + i, __uint_as_float(ba), __uint_as_float(bb));
    st2(P + PLN + i, __uint_as_float(sa), __uint_as_float(sb));
  }
}

// An mma.m16n8k8 TF32 A fragment from shared memory in one instruction: the
// four 8 x 8 b16 matrices of ldmatrix are 8 rows x 4 fp32 each, and lane
// 4g + t receives word t of row g of each, which is the fragment's layout
// (a0 = (g, t), a1 = (g + 8, t), a2 = (g, t + 4), a3 = (g + 8, t + 4)).
// Lane l gives the address of row l % 8 of matrix l / 8 (16 bytes).
__device__ __forceinline__ void ldsm_x4(const float* p, uint32_t (&r)[4]) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s));
}

// The lane's place in a fragment: g = lane / 4 (rows), t = lane % 4.
__device__ __forceinline__ int lane_g() { return (threadIdx.x & 31) >> 2; }
__device__ __forceinline__ int lane_t() { return threadIdx.x & 3; }
__device__ __forceinline__ int warp_id() { return threadIdx.x >> 5; }

// ---- products over the channels: the warp's 16 rows (16 (warp / WPR) + g,
// + 8; WPR warps a row group) of A (split planes of row stride AST, plane size APL) times KS k-steps
// [k0, k0 + KS) of a packed weight (w_nt n-tiles wide), n-tiles nt .. nt + NI.
// acc[ni][2h + e] is row 16 (warp / WPR) + 8h + g, column 8 (nt + ni) + 2t + e.
// The k-loop is unrolled whole, so that the B fragments' loads (from L2: the
// blocks' shared memory leaves L1 little room) are all in flight at once;
// unrolled by two, C and E ran 16% and 10% slower (bwd_timing, on the card).
// A fragments come by ldmatrix (ldsm_x4), 1% faster than four 32-bit loads.
// NP TF32 passes: 3 (split, as above) or 1 (a_big b_big alone; the small
// plane is not read and each B fragment is the float2 of its big halves).
template <int KS, int NI, int AST, int APL, int WPR = 4, int NP = PASSES_SPLIT>
__device__ __forceinline__ void mma_act(const float* A, const float* __restrict__ Wp, int w_nt,
                                        int k0, int nt, float (&acc)[NI][4]) {
  static_assert(NP == PASSES_SPLIT || NP == PASSES_ONE, "three TF32 passes or one");
  const int lane = threadIdx.x & 31;
  // ldmatrix.x4 row address of this lane: matrices (rows 0-7 | 8-15) x
  // (columns 0-3 | 4-7) of the k-step, in that order, give a0..a3.
  const int lrow = 16 * (warp_id() / WPR) + (lane & 7) + 8 * ((lane >> 3) & 1);
  const float* a = A + lrow * AST + ((4 * (lane >> 4)) ^ (lrow & 4));
  const float4* W = reinterpret_cast<const float4*>(Wp);
#pragma unroll
  for (int j = 0; j < KS; ++j) {
    uint32_t ab[4], as[4];
    ldsm_x4(a + 8 * j, ab);
    if constexpr (NP == PASSES_SPLIT) ldsm_x4(a + APL + 8 * j, as);
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const float4* bp = W + ((k0 + j) * w_nt + nt + ni) * 32 + lane;
      if constexpr (NP == PASSES_SPLIT) {
        const float4 b = __ldg(bp);
        const uint32_t bb0 = __float_as_uint(b.x), bb1 = __float_as_uint(b.y);
        const uint32_t bs0 = __float_as_uint(b.z), bs1 = __float_as_uint(b.w);
        mma_tf32(acc[ni], as, bb0, bb1);
        mma_tf32(acc[ni], ab, bs0, bs1);
        mma_tf32(acc[ni], ab, bb0, bb1);
      } else {
        const float2 b = __ldg(reinterpret_cast<const float2*>(bp));
        mma_tf32(acc[ni], ab, __float_as_uint(b.x), __float_as_uint(b.y));
      }
    }
  }
}

// ---- weight gradients: acc[mi][ni] += Σ_{s < BT} X[s, m] Y[s, n] for the
// rows m = m0 + 16 mi + 8h + g and columns n = n0 + 8 ni + 2t + e of the
// product X^T Y, the sites as K.  X and Y are split planes (row strides XST,
// YST; plane sizes XPL, YPL), read transposed: rows t (+4), columns g.  NP
// TF32 passes, as mma_act (one pass reads the big planes alone). ----
template <int MI, int NI, int XST, int XPL, int YST, int YPL, int NP = PASSES_SPLIT>
__device__ __forceinline__ void mma_grad(const float* X, const float* Y, int m0, int n0,
                                         float (&acc)[MI][NI][4]) {
  const int g = lane_g(), t = lane_t();
#pragma unroll
  for (int j = 0; j < BT / 8; ++j) {
    const int s0 = 8 * j + t, s1 = s0 + 4;  // s0 & 4 == 0, s1 & 4 == 4
    uint32_t xb[MI][4], xs[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const int m = m0 + 16 * mi + g;
      const int o[4] = {s0 * XST + m, s0 * XST + m + 8, s1 * XST + (m ^ 4),
                        s1 * XST + ((m + 8) ^ 4)};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        xb[mi][r] = __float_as_uint(X[o[r]]);
        if constexpr (NP == PASSES_SPLIT) xs[mi][r] = __float_as_uint(X[XPL + o[r]]);
      }
    }
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
      const int n = n0 + 8 * ni + g;
      const int o0 = s0 * YST + n, o1 = s1 * YST + (n ^ 4);
      const uint32_t bb0 = __float_as_uint(Y[o0]), bb1 = __float_as_uint(Y[o1]);
      if constexpr (NP == PASSES_SPLIT) {
        const uint32_t bs0 = __float_as_uint(Y[YPL + o0]), bs1 = __float_as_uint(Y[YPL + o1]);
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) {
          mma_tf32(acc[mi][ni], xs[mi], bb0, bb1);
          mma_tf32(acc[mi][ni], xb[mi], bs0, bs1);
          mma_tf32(acc[mi][ni], xb[mi], bb0, bb1);
        }
      } else {
#pragma unroll
        for (int mi = 0; mi < MI; ++mi) mma_tf32(acc[mi][ni], xb[mi], bb0, bb1);
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float* a) {
#pragma unroll
  for (int i = 0; i < N; ++i) a[i] = 0.f;
}

// One tile's weight gradient (mma_grad from fresh accumulators) added to the
// running sums run (same layout) with fp32 adds.  The tensor cores' own fp32
// accumulation does not round to nearest: chained over a block's thousands
// of sites it drifted to 7e-5 of the gradients (on the card), so each chain
// covers one tile's 32 sites and the sums across tiles are ordinary adds.
template <int MI, int NI, int XST, int XPL, int YST, int YPL, int NP = PASSES_SPLIT>
__device__ __forceinline__ void grad_tile(const float* X, const float* Y, int m0, int n0,
                                          float (&run)[MI][NI][4]) {
  float acc[MI][NI][4];
  zero<MI * NI * 4>(&acc[0][0][0]);
  mma_grad<MI, NI, XST, XPL, YST, YPL, NP>(X, Y, m0, n0, acc);
#pragma unroll
  for (int i = 0; i < MI * NI * 4; ++i) (&run[0][0][0])[i] += (&acc[0][0][0])[i];
}

// ---- tiles: rows [0, nv) of a (·, D) row-major source copied with
// cp.async into a buffer of row stride ST (ST == BXS: swizzled), rows
// [nv, BT) zero-filled.  Thread t owns the 16-byte chunks t + k NT. ----
template <int ST>
__device__ __forceinline__ int tile_at(int r, int c) {
  return ST == BXS ? sw(r, c) : r * ST + c;
}

template <int ST, int NTH = NT>
__device__ __forceinline__ void tile_issue(float* dst, const float* src, int nv) {
#pragma unroll
  for (int k = 0; k < BT * D / 4 / NTH; ++k) {
    const int e = threadIdx.x + k * NTH, r = e / (D / 4), c = 4 * (e % (D / 4));
    const bool in = r < nv;
    cp_async16_zfill(dst + tile_at<ST>(r, c), in ? src + r * D + c : src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;" ::: "memory"); }

// LayerNorm of each tile row of X (row stride ST), one warp per row,
// written split to the planes Y (the big plane alone at one pass).
template <int ST, int NW = NWARP, int NP = PASSES_SPLIT>
static __device__ void ln_split_rows(const float* X, float* Y, const float* __restrict__ scale,
                                     const float* __restrict__ bias, float eps) {
  const int warp = warp_id(), lane = threadIdx.x & 31;
  const float2 sc = ld2(scale + 2 * lane), bi = ld2(bias + 2 * lane);
  for (int s = warp; s < BT; s += NW) {
    const float2 x = ld2(X + tile_at<ST>(s, 2 * lane));
    const float mu = warp_sum(x.x + x.y) * (1.f / D);
    const float da = x.x - mu, db = x.y - mu;
    const float var = warp_sum(da * da + db * db) * (1.f / D);
    const float r = 1.f / sqrtf(var + eps);
    put_split<BXS, PL, NP>(Y, s, 2 * lane, da * r * sc.x + bi.x, db * r * sc.y + bi.y);
  }
}

// The split planes of a tile (row stride ST), one float2 a thread at a time.
template <int ST, int NTH = NT, int NP = PASSES_SPLIT>
__device__ __forceinline__ void split_tile(const float* G, float* P) {
  for (int e = threadIdx.x; e < BT * D / 2; e += NTH) {
    const int r = e / (D / 2), c = 2 * (e % (D / 2));
    const float2 v = ld2(G + tile_at<ST>(r, c));
    put_split<BXS, PL, NP>(P, r, c, v.x, v.y);
  }
}

// LayerNorm backward of the tile rows: X the LN input (stride ST), DH the
// upstream gradient (a plane, fp32), G the residual gradient (stride ST);
// out = G + dx for rows < nv goes to dst (·, D) and, if P is given, split to
// the planes P (zero for rows >= nv).  Adds the columns 2 lane, 2 lane + 1
// of Σ dh·xhat, Σ dh, Σ G and Σ out to the warp's sums.
template <int ST, int NW = NWARP, int NP = PASSES_SPLIT>
static __device__ void ln_bwd_tile(const float* X, const float* DH, const float* G,
                                   const float* __restrict__ scale, float eps, int nv,
                                   float* dst, float* P, float (&ds)[2], float (&db)[2],
                                   float (&g_in)[2], float (&g_out)[2]) {
  const int warp = warp_id(), lane = threadIdx.x & 31;
  const float2 sc = ld2(scale + 2 * lane);
  for (int s = warp; s < BT; s += NW) {
    if (s >= nv) {
      if (P != nullptr) put_split<BXS, PL, NP>(P, s, 2 * lane, 0.f, 0.f);
      continue;
    }
    const float2 x = ld2(X + tile_at<ST>(s, 2 * lane));
    const float mu = warp_sum(x.x + x.y) * (1.f / D);
    const float da = x.x - mu, db_ = x.y - mu;
    const float var = warp_sum(da * da + db_ * db_) * (1.f / D);
    const float r = 1.f / sqrtf(var + eps);
    const float xh0 = da * r, xh1 = db_ * r;
    const float2 dh = ld2(DH + sw(s, 2 * lane));
    const float gx0 = dh.x * sc.x, gx1 = dh.y * sc.y;
    const float m1 = warp_sum(gx0 + gx1) * (1.f / D);
    const float m2 = warp_sum(gx0 * xh0 + gx1 * xh1) * (1.f / D);
    const float2 g = ld2(G + tile_at<ST>(s, 2 * lane));
    const float o0 = g.x + r * (gx0 - m1 - xh0 * m2);
    const float o1 = g.y + r * (gx1 - m1 - xh1 * m2);
    st2(dst + (size_t)s * D + 2 * lane, o0, o1);
    if (P != nullptr) put_split<BXS, PL, NP>(P, s, 2 * lane, o0, o1);
    ds[0] += dh.x * xh0;
    ds[1] += dh.y * xh1;
    db[0] += dh.x;
    db[1] += dh.y;
    g_in[0] += g.x;
    g_in[1] += g.y;
    g_out[0] += o0;
    g_out[1] += o1;
  }
}

// red[(v NW + warp) D + c] <- the warp's sums of vector v (columns 2 lane, +1).
template <int NW = NWARP>
__device__ __forceinline__ void put_warp_sums(float* red, int v, const float (&x)[2]) {
  st2(red + (v * NW + warp_id()) * D + 2 * (threadIdx.x & 31), x[0], x[1]);
}

// Column threadIdx.x (< D) of vector v, summed over the NW warps in order.
template <int NW = NWARP>
__device__ __forceinline__ float warp_sums_total(const float* red, int v) {
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NW; ++w) total += red[(v * NW + w) * D + threadIdx.x];
  return total;
}

// Sum over the 8 row lanes g of a fragment column (lanes t fixed).
__device__ __forceinline__ float rows_sum(float v) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ======================= kernel C =======================
// A product over the channels (BT x 64 output) has WPR warps a row group of
// 16 rows, each warp 64 / WPR columns: row 16 (warp / WPR) + 8h + g, column
// (64 / WPR)(warp % WPR) + 8 ni + 2t + e for element i = 4 ni + 2h + e.
template <int WPR = 4>
__device__ __forceinline__ int act_row(int h) { return 16 * (warp_id() / WPR) + 8 * h + lane_g(); }
template <int WPR = 4>
__device__ __forceinline__ int act_col(int ni) {
  return (D / WPR) * (warp_id() % WPR) + 8 * ni + 2 * lane_t();
}

// Add a thread's GE accumulators of a 64 x 64 gradient block to its own
// float4 slots (slot q at q NTH + thread).
template <int GE, int NTH>
__device__ __forceinline__ void grad_add(float4* slots, const float* a) {
#pragma unroll
  for (int q = 0; q < GE / 4; ++q) {
    float4& s = slots[q * NTH + threadIdx.x];
    float4 v = s;
    v.x += a[4 * q];
    v.y += a[4 * q + 1];
    v.z += a[4 * q + 2];
    v.w += a[4 * q + 3];
    s = v;
  }
}

// A thread's share of a 64 x 64 gradient block, acc[mi][ni][2h + e] flat (row
// m0 + 16 mi + 8h + g, column n0 + 8 ni + 2t + e), to dst[row ld + col].
template <int MI, int NI>
__device__ __forceinline__ void grad_store(const float* a, float* dst, int ld, int m0, int n0) {
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + 16 * mi + 8 * h + lane_g(), n = n0 + 8 * ni + 2 * lane_t();
        const float* v = a + (mi * NI + ni) * 4 + 2 * h;
        st2(dst + (size_t)m * ld + n, v[0], v[1]);
      }
}

// Kernel C's warp layout: C_WARPS warps; the products over the channels in
// two row groups (CNI n-tiles a warp, CE elements a thread); the 64 x 64
// weight gradients in C_WARPS / 4 row groups of 16 GMI rows by 4 column
// groups of 16 (GE accumulators a thread).
constexpr int CWPR = C_WARPS / 2;
constexpr int CNI = D / CWPR / 8;
constexpr int CE = 4 * CNI;
constexpr int GMI = 16 / C_WARPS;
constexpr int GE = 4 * GMI * 2;
static_assert(CNI >= 1 && GMI >= 1, "kernel C takes 8 or 16 warps");

template <int NP>
__global__ void __launch_bounds__(C_NT, 1) kernel_c(
    const float* __restrict__ x1, const float* __restrict__ g3, const float* __restrict__ stats,
    const float* __restrict__ pmask, const float* __restrict__ pair_count,
    const float* __restrict__ w, const float* __restrict__ wm, float* __restrict__ g2,
    float* __restrict__ a1_part, float* __restrict__ w_part, int P, int L, int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  SmemC& S = *reinterpret_cast<SmemC*>(smem_raw);
  const int b = blockIdx.y, slot = blockIdx.x, t = threadIdx.x, warp = warp_id();
  const int nt0 = CNI * (warp % CWPR), gm0 = 16 * GMI * (warp / 4), gn0 = 16 * (warp % 4);
  int p0, p1;
  split_range(slot, P, S_, p0, p1);
  for (int e = t; e < CGRAD / 4; e += C_NT) S.grad[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  float dwo[GMI][2][4];
  zero<GE>(&dwo[0][0][0]);
  float db1[F / D][2 * CNI];  // columns 64 ch + act_col(ni) + e of du, over the thread's rows
  zero<F / D * 2 * CNI>(&db1[0][0]);
  float vfs[2] = {0.f, 0.f}, vfb[2] = {0.f, 0.f}, vb2[2] = {0.f, 0.f}, vbo[2] = {0.f, 0.f};
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const int np = p1 - p0, nt = (L + BT - 1) / BT, n = nt * np;
  const size_t row_b = (size_t)b * P;

  float qm[CE], ctx[CE], a1r[CE], qn[CE];
  if (n > 0) {
    const size_t off = (row_b + p0) * L * D;
    tile_issue<BXS, C_NT>(S.xs[0], x1 + off, min(BT, L));
    tile_issue<BXS, C_NT>(S.g3[0], g3 + off, min(BT, L));
    cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int tile = i / np, p = p0 + i % np, l0 = tile * BT, nv = min(BT, L - l0);
    const size_t off = ((row_b + p) * L + l0) * D;
    float* X = S.xs[i & 1];
    const float* G = S.g3[i & 1];
    cp_wait_all();
    __syncthreads();
    if (i + 1 < n) {
      const int tn = (i + 1) / np, pn = p0 + (i + 1) % np, ln = tn * BT;
      const size_t offn = ((row_b + pn) * L + ln) * D;
      tile_issue<BXS, C_NT>(S.xs[(i + 1) & 1], x1 + offn, min(BT, L - ln));
      tile_issue<BXS, C_NT>(S.g3[(i + 1) & 1], g3 + offn, min(BT, L - ln));
      cp_commit();
    }
    if (p == p0) {  // the tile's column terms, and A1's sums start
#pragma unroll
      for (int k = 0; k < CE; ++k) {
        const int s = act_row<CWPR>((k >> 1) & 1), c = act_col<CWPR>(k >> 2) + (k & 1);
        float ksum = 1.f, qsum = n_pairs, kv = 0.f;
        if (s < nv) {
          const float* st = stats_b + (size_t)(l0 + s) * 3 * D;
          ksum = st[c];
          qsum = st[D + c];
          kv = st[2 * D + c];
        }
        qm[k] = guard(qsum / n_pairs);
        ctx[k] = kv / guard(ksum);
        a1r[k] = 0.f;
      }
    }
    const float pm = pmask[row_b + p];
    // column attention output (kernel B's math): qn, attn, x2
    ln_split_rows<BXS, C_WARPS, NP>(X, S.hs, w + CB_CNS, w + CB_CNB, eps);
    split_tile<BXS, C_NT, NP>(G, S.gs);
    __syncthreads();
    {
      float acc[CNI][4];
      zero<CE>(&acc[0][0]);
      mma_act<D / 8, CNI, BXS, PL, CWPR, NP>(S.hs, wm + CTM_CWQ, D / 8, 0, nt0, acc);
#pragma unroll
      for (int ni = 0; ni < CNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = act_row<CWPR>(h), c = act_col<CWPR>(ni), k = 4 * ni + 2 * h;
          float at[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            qn[k + e] = phi(acc[ni][2 * h + e] + w[CB_CBQE + c + e]) * pm / qm[k + e];
            at[e] = qn[k + e] * ctx[k + e];
          }
          put_split<BXS, PL, NP>(S.as, s, c, at[0], at[1]);
        }
    }
    __syncthreads();
    {
      float acc[CNI][4];
      zero<CE>(&acc[0][0]);
      mma_act<D / 8, CNI, BXS, PL, CWPR, NP>(S.as, wm + CTM_CWO, D / 8, 0, nt0, acc);
#pragma unroll
      for (int ni = 0; ni < CNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = act_row<CWPR>(h), c = act_col<CWPR>(ni);
          float* xp = X + sw(s, c);
          const float2 x = ld2(xp);
          st2(xp, x.x + (acc[ni][2 * h] + w[CB_CBO + c]),
              x.y + (acc[ni][2 * h + 1] + w[CB_CBO + c + 1]));  // x2
        }
    }
    __syncthreads();
    // the FFN recomputed and differentiated, one 64-wide hidden chunk at a time
    ln_split_rows<BXS, C_WARPS, NP>(X, S.hs, w + CB_FNS, w + CB_FNB, eps);
    __syncthreads();
    float dhf[CNI][4];
    zero<CE>(&dhf[0][0]);
#pragma unroll 1
    for (int ch = 0; ch < F / D; ++ch) {
      float u[CNI][4];
      zero<CE>(&u[0][0]);
      mma_act<D / 8, CNI, BXS, PL, CWPR, NP>(S.hs, wm + CTM_W1, F / 8, 0, ch * (D / 8) + nt0, u);
#pragma unroll
      for (int ni = 0; ni < CNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = act_row<CWPR>(h), c = act_col<CWPR>(ni);
          const float* b1 = w + CB_B1 + ch * D + c;
          u[ni][2 * h] += b1[0];
          u[ni][2 * h + 1] += b1[1];
          put_split<BXS, PL, NP>(S.as, s, c, gelu<0>(u[ni][2 * h]),
                                 gelu<0>(u[ni][2 * h + 1]));
        }
      __syncthreads();
      {
        float acc[GMI][2][4];  // dW2 rows 64 ch .. : a^T g3
        zero<GE>(&acc[0][0][0]);
        mma_grad<GMI, 2, BXS, PL, BXS, PL, NP>(S.as, S.gs, gm0, gn0, acc);
        grad_add<GE, C_NT>(S.grad + (F / D + ch) * (GE / 4) * C_NT, &acc[0][0][0]);
      }
      float gd[CNI][4];  // g3 W2^T, the chunk's columns
      zero<CE>(&gd[0][0]);
      mma_act<D / 8, CNI, BXS, PL, CWPR, NP>(S.gs, wm + CTM_W2T, F / 8, 0, ch * (D / 8) + nt0, gd);
      __syncthreads();
#pragma unroll
      for (int ni = 0; ni < CNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = act_row<CWPR>(h), c = act_col<CWPR>(ni);
          float du[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            du[e] = gd[ni][2 * h + e] * gelu_grad(u[ni][2 * h + e]);
            if (s < nv) db1[ch][2 * ni + e] += du[e];
          }
          put_split<BXS, PL, NP>(S.as, s, c, du[0], du[1]);
        }
      __syncthreads();
      {
        float acc[GMI][2][4];  // dW1 columns 64 ch .. : hf^T du
        zero<GE>(&acc[0][0][0]);
        mma_grad<GMI, 2, BXS, PL, BXS, PL, NP>(S.hs, S.as, gm0, gn0, acc);
        grad_add<GE, C_NT>(S.grad + ch * (GE / 4) * C_NT, &acc[0][0][0]);
      }
      {  // d_hf += du W1^T (the chunk's k-steps; chains of one chunk, as grad_tile)
        float acc[CNI][4];
        zero<CE>(&acc[0][0]);
        mma_act<D / 8, CNI, BXS, PL, CWPR, NP>(S.as, wm + CTM_W1T, D / 8, ch * (D / 8), nt0, acc);
#pragma unroll
        for (int k = 0; k < CE; ++k) (&dhf[0][0])[k] += (&acc[0][0])[k];
      }
      __syncthreads();
    }
#pragma unroll
    for (int ni = 0; ni < CNI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        st2(S.as + sw(act_row<CWPR>(h), act_col<CWPR>(ni)), dhf[ni][2 * h], dhf[ni][2 * h + 1]);
    __syncthreads();
    // g2 = g3 + LN_f backward; attn split again (hs is free now)
    ln_bwd_tile<BXS, C_WARPS, NP>(X, S.as, G, w + CB_FNS, eps, nv, g2 + off, S.gs, vfs, vfb,
                                  vb2, vbo);
#pragma unroll
    for (int ni = 0; ni < CNI; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 4 * ni + 2 * h;
        put_split<BXS, PL, NP>(S.hs, act_row<CWPR>(h), act_col<CWPR>(ni), qn[k] * ctx[k],
                               qn[k + 1] * ctx[k + 1]);
      }
    __syncthreads();
    // dWo_c += attn^T g2; d_attn = g2 Wo_c^T and the A1 sum
    grad_tile<GMI, 2, BXS, PL, BXS, PL, NP>(S.hs, S.gs, gm0, gn0, dwo);
    {
      float acc[CNI][4];
      zero<CE>(&acc[0][0]);
      mma_act<D / 8, CNI, BXS, PL, CWPR, NP>(S.gs, wm + CTM_CWOT, D / 8, 0, nt0, acc);
#pragma unroll
      for (int k = 0; k < CE; ++k) a1r[k] = fmaf(acc[k >> 2][k & 3], qn[k], a1r[k]);
    }
    if (p == p1 - 1) {
      float* ap = a1_part + ((size_t)b * S_ + slot) * L * D;
#pragma unroll
      for (int ni = 0; ni < CNI; ++ni)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = act_row<CWPR>(h);
          if (s < nv) st2(ap + (size_t)(l0 + s) * D + act_col<CWPR>(ni), a1r[4 * ni + 2 * h],
                          a1r[4 * ni + 2 * h + 1]);
        }
    }
  }
  __syncthreads();

  // the block's weight gradients, each sum in a fixed order
  float* wp = w_part + ((size_t)b * S_ + slot) * NWC;
  grad_store<GMI, 2>(&dwo[0][0][0], wp + WC_CWO, D, gm0, gn0);
#pragma unroll 1
  for (int ch = 0; ch < F / D; ++ch) {
    float v[GE];
#pragma unroll
    for (int m = 0; m < 2; ++m) {  // dW1's chunk, then dW2's
      const float4* sl = S.grad + (m * (F / D) + ch) * (GE / 4) * C_NT;
#pragma unroll
      for (int q = 0; q < GE / 4; ++q) {
        const float4 a = sl[q * C_NT + t];
        v[4 * q] = a.x;
        v[4 * q + 1] = a.y;
        v[4 * q + 2] = a.z;
        v[4 * q + 3] = a.w;
      }
      if (m == 0) grad_store<GMI, 2>(v, wp + WC_W1 + ch * D, F, gm0, gn0);
      else grad_store<GMI, 2>(v, wp + WC_W2 + (size_t)ch * D * D, D, gm0, gn0);
    }
  }
  // db1: the thread's rows, then the 8 row lanes, then the two row groups
#pragma unroll
  for (int ch = 0; ch < F / D; ++ch)
#pragma unroll
    for (int k = 0; k < 2 * CNI; ++k) db1[ch][k] = rows_sum(db1[ch][k]);
  if (lane_g() == 0) {
#pragma unroll
    for (int ch = 0; ch < F / D; ++ch)
#pragma unroll
      for (int ni = 0; ni < CNI; ++ni)
        st2(S.red + (warp / CWPR) * F + ch * D + act_col<CWPR>(ni), db1[ch][2 * ni],
            db1[ch][2 * ni + 1]);
  }
  put_warp_sums<C_WARPS>(S.as, 0, vfs);
  put_warp_sums<C_WARPS>(S.as, 1, vfb);
  put_warp_sums<C_WARPS>(S.as, 2, vb2);
  put_warp_sums<C_WARPS>(S.as, 3, vbo);
  __syncthreads();
  if (t < F) wp[WC_B1 + t] = S.red[t] + S.red[F + t];
  if (t < D) {
    wp[WC_FNS + t] = warp_sums_total<C_WARPS>(S.as, 0);
    wp[WC_FNB + t] = warp_sums_total<C_WARPS>(S.as, 1);
    wp[WC_B2 + t] = warp_sums_total<C_WARPS>(S.as, 2);
    wp[WC_CBO + t] = warp_sums_total<C_WARPS>(S.as, 3);
  }
}

// ======================= kernels E, E2 and D =======================
// A warp owns the rows 16 (warp / 4) + 8h + g of a tile and the 16 columns
// of head warp % 4: its products' outputs (act_row, act_col) and its q/k
// head terms line up, and a head's sum over its lanes is the thread's four
// columns, then its quad.

// [zq | zk] of the warp's head (warp % 4) for its rows 8h + g: the z product
// (16 rows x 8, one fragment) has zq of head c at column c and zk at 4 + c,
// held by lane 4g + c / 2 (element c % 2).
__device__ __forceinline__ void head_z(const float (&z)[1][4], float (&zq)[2], float (&zk)[2]) {
  const int hh = warp_id() & 3, lane = threadIdx.x & 31;
  const int src = (lane & ~3) | (hh >> 1);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = z[0][2 * h + (hh & 1)];
    zq[h] = __shfl_sync(0xffffffffu, v, src);
    zk[h] = __shfl_sync(0xffffffffu, v, src + 2);
  }
}

// The three products of a tile: [zq | zk] = h [Wq | Wk] (the d x H
// weights), v = h Wv and d_attn = g Wo^T, for the warp's rows and head; hs
// and gs are the split planes of h and g.
template <int NP>
__device__ __forceinline__ void row_products(const float* hs, const float* gs,
                                             const float* __restrict__ wm, float (&z)[1][4],
                                             float (&v)[2][4], float (&da)[2][4]) {
  zero<4>(&z[0][0]);
  zero<8>(&v[0][0]);
  zero<8>(&da[0][0]);
  const int nt = 2 * (warp_id() & 3);
  mma_act<D / 8, 1, BXS, PL, 4, NP>(hs, wm + EM_WQK, 1, 0, 0, z);
  mma_act<D / 8, 2, BXS, PL, 4, NP>(hs, wm + EM_WV, D / 8, 0, nt, v);
  mma_act<D / 8, 2, BXS, PL, 4, NP>(gs, wm + EM_WOT, D / 8, 0, nt, da);
}

// Sum over the thread's quad (the 4 lanes t of a row): with its own four
// columns, a head's 16 lanes.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// dzq and dzk of row s and head hh, split into the [dzq | dzk] planes (the
// big plane alone at one pass).
template <int NP>
__device__ __forceinline__ void put_dz(float* dz, int s, int hh, float dzq, float dzk) {
  const int iq = s * DZS + (hh ^ (s & 4)), ik = s * DZS + ((H + hh) ^ (s & 4));
  if constexpr (NP == PASSES_ONE) {
    dz[iq] = __uint_as_float(to_tf32(dzq));
    dz[ik] = __uint_as_float(to_tf32(dzk));
  } else {
    uint32_t big, small;
    split_tf32(dzq, big, small);
    dz[iq] = __uint_as_float(big);
    dz[DZPL + iq] = __uint_as_float(small);
    split_tf32(dzk, big, small);
    dz[ik] = __uint_as_float(big);
    dz[DZPL + ik] = __uint_as_float(small);
  }
}

// d_h = [d_v | dz] [Wv^T ; Wq^T ; Wk^T] for the warp's rows and head, into
// the big plane of hs (fp32) once every warp is done reading hs.
template <int NP>
__device__ __forceinline__ void dh_product(const float* vs, const float* dz,
                                           const float* __restrict__ wm, float* hs) {
  const int hh = warp_id() & 3;
  float dh[2][4];
  zero<8>(&dh[0][0]);
  mma_act<D / 8, 2, BXS, PL, 4, NP>(vs, wm + EM_WDH, D / 8, 0, 2 * hh, dh);
  mma_act<1, 2, DZS, DZPL, 4, NP>(dz, wm + EM_WDH, D / 8, D / 8, 2 * hh, dh);
  __syncthreads();
#pragma unroll
  for (int ni = 0; ni < 2; ++ni)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      st2(hs + sw(act_row(h), act_col(ni)), dh[ni][2 * h], dh[ni][2 * h + 1]);
}

// The pair's terms of pass 2 from its sums over the row (column t < D, in
// warps 0 and 1: whole warps, so the head shuffles are safe): q-mean, ctx,
// d_ctx / sk and the head terms qm_h, d_sk_h, d_sq_h into pc (the finalize
// of _kernel_e, and of _kernel_e2 from E1's raw sums, axial_block_bwd.py:563).
__device__ __forceinline__ void pair_terms(float* pc, float sq, float sk_raw, float skv,
                                           float sdq, float count) {
  const int t = threadIdx.x;
  const float sq_raw = sq / count;
  const float qm = guard(sq_raw), sk = guard(sk_raw);
  const float ctx = skv / sk;
  const float d_ctx = sdq / qm;
  const float sk_h = head_sum(sk) / HD;
  const float d_sk_h = -head_sum(d_ctx * ctx) / sk_h * gate(head_sum(sk_raw));
  const float qm_h = head_sum(qm) / HD;
  const float d_qm_h = -head_sum(ctx * sdq) / (qm_h * qm_h) * gate(head_sum(sq_raw));
  pc[t] = qm;
  pc[D + t] = ctx;
  pc[2 * D + t] = d_ctx / sk;
  pc[3 * D + t] = qm_h;
  pc[4 * D + t] = d_sk_h;
  pc[5 * D + t] = d_qm_h / count;
}

// The row backward of kernels E and E2, one body.  E (FROM_SUMS false, one
// site chunk) walks each pair's whole row twice: pass 1 sums q, k, k v and
// d_attn q over the sites, the finalize turns them into the pair's terms,
// pass 2 emits gx and the weight gradients.  E2 (FROM_SUMS true) runs pass
// 2 alone on the tiles [t0, t1) of its site chunk (block slot * SC +
// chunk), each pair's terms finalized from its raw sums in rowsums (E1's).
template <bool FROM_SUMS, int NP>
__device__ __forceinline__ void row_bwd(SmemE& S, const float* __restrict__ x,
                                        const float* __restrict__ g1,
                                        const float* __restrict__ rowsums,
                                        const float* __restrict__ smask,
                                        const float* __restrict__ w, const float* __restrict__ wm,
                                        float* __restrict__ gx, float* __restrict__ w_part, int P,
                                        int L, int SP, int SC, float eps) {
  const int b = blockIdx.y, slot = blockIdx.x / SC, chunk = blockIdx.x % SC, t = threadIdx.x;
  const int warp = warp_id(), lane = t & 31, hh = warp & 3, wmr = warp >> 2;
  int p0, p1, t0, t1;
  split_range(slot, P, SP, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  {
    float v = 0.f;
    for (int l = t; l < L; l += NT) v += smask_b[l];
    v = warp_sum(v);
    if (lane == 0) S.wsum[warp] = v;
    __syncthreads();
    if (t == 0) {
      float c = 0.f;
#pragma unroll
      for (int ww = 0; ww < NWARP; ++ww) c += S.wsum[ww];
      S.count = fmaxf(c, 1.f);
    }
  }
  float dwv[2][2][4], dwo[2][2][4], dwqk[1][1][4];
  zero<16>(&dwv[0][0][0]);
  zero<16>(&dwo[0][0][0]);
  zero<4>(&dwqk[0][0][0]);
  float dbv[4] = {0.f, 0.f, 0.f, 0.f}, dzs[2] = {0.f, 0.f};
  float vds[2] = {0.f, 0.f}, vdb[2] = {0.f, 0.f}, vbo[2] = {0.f, 0.f}, unused[2] = {0.f, 0.f};
  float bv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) bv[k] = w[AG_BV + act_col(k >> 1) + (k & 1)];
  const float bq = w[AG_BQ + hh], bk = w[AG_BK + hh];
  const int nt = (L + BT - 1) / BT;
  split_range(chunk, nt, SC, t0, t1);
  const int span = t1 - t0, per_pair = (FROM_SUMS ? 1 : 2) * span, n = (p1 - p0) * per_pair;
  const size_t row_b = (size_t)b * P;
  float rq[4], rk[4], rkv[4], rdq[4];

  if (n > 0) {
    const size_t off = ((row_b + p0) * L + (size_t)t0 * BT) * D;
    tile_issue<D>(S.xs[0], x + off, min(BT, L - t0 * BT));
    tile_issue<D>(S.g1[0], g1 + off, min(BT, L - t0 * BT));
    cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int p = p0 + i / per_pair, pass = FROM_SUMS ? 1 : (i % per_pair) / span;
    const int tile = t0 + i % span, l0 = tile * BT, nv = min(BT, L - l0);
    const size_t off = ((row_b + p) * L + l0) * D;
    const float* X = S.xs[i & 1];
    const float* G = S.g1[i & 1];
    cp_wait_all();
    __syncthreads();
    if (i + 1 < n) {
      const int pn = p0 + (i + 1) / per_pair, ln = (t0 + (i + 1) % span) * BT;
      const size_t offn = ((row_b + pn) * L + ln) * D;
      tile_issue<D>(S.xs[(i + 1) & 1], x + offn, min(BT, L - ln));
      tile_issue<D>(S.g1[(i + 1) & 1], g1 + offn, min(BT, L - ln));
      cp_commit();
    }
    if (FROM_SUMS && tile == t0 && t < D) {  // read after the barrier below
      const float* rs = rowsums + (row_b + p) * 4 * D;
      pair_terms(S.pc, rs[t], rs[D + t], rs[2 * D + t], rs[3 * D + t], S.count);
    }
    ln_split_rows<D, NWARP, NP>(X, S.hs, w + AG_LNS, w + AG_LNB, eps);
    split_tile<D, NT, NP>(G, S.gs);
    __syncthreads();
    float z[1][4], v[2][4], da[2][4], zq[2], zk[2], m[2];
    row_products<NP>(S.hs, S.gs, wm, z, v, da);
    head_z(z, zq, zk);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = act_row(h);
      m[h] = s < nv ? smask_b[l0 + s] : 0.f;
      zq[h] += bq;
      zk[h] += bk;
    }
    if (!FROM_SUMS && pass == 0) {
      // pass 1: the pair's sums over the site axis
      if (tile == 0) {
#pragma unroll
        for (int k = 0; k < 4; ++k) rq[k] = rk[k] = rkv[k] = rdq[k] = 0.f;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float q = phi(zq[h]) * m[h], kk = phi(zk[h]) * m[h];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rq[k] += q;
          rk[k] += kk;
          rkv[k] += kk * (v[k >> 1][2 * h + (k & 1)] + bv[k]);
          rdq[k] += da[k >> 1][2 * h + (k & 1)] * q;
        }
      }
      if (tile == nt - 1) {
        // finalize: the rows' sums in a fixed order, then the pair's terms
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          rq[k] = rows_sum(rq[k]);
          rk[k] = rows_sum(rk[k]);
          rkv[k] = rows_sum(rkv[k]);
          rdq[k] = rows_sum(rdq[k]);
        }
        float* red = S.dz;  // (v, row warp, column)
        if (lane_g() == 0) {
#pragma unroll
          for (int ni = 0; ni < 2; ++ni) {
            const int c = act_col(ni);
            st2(red + (0 * 2 + wmr) * D + c, rq[2 * ni], rq[2 * ni + 1]);
            st2(red + (1 * 2 + wmr) * D + c, rk[2 * ni], rk[2 * ni + 1]);
            st2(red + (2 * 2 + wmr) * D + c, rkv[2 * ni], rkv[2 * ni + 1]);
            st2(red + (3 * 2 + wmr) * D + c, rdq[2 * ni], rdq[2 * ni + 1]);
          }
        }
        __syncthreads();
        if (t < D)
          pair_terms(S.pc, red[t] + red[D + t], red[2 * D + t] + red[3 * D + t],
                     red[4 * D + t] + red[5 * D + t], red[6 * D + t] + red[7 * D + t], S.count);
      }
      continue;  // the next item's first barrier orders these reads and writes
    }
    // pass 2: gx and the weight gradients of the tile
    {
      const int c0 = act_col(0);
      const float qm_h = S.pc[3 * D + c0], d_sk_h = S.pc[4 * D + c0], d_sq_h = S.pc[5 * D + c0];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = act_row(h);
        float pq = 0.f, pk = 0.f;
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int c = act_col(k >> 1) + (k & 1);
          pq += da[k >> 1][2 * h + (k & 1)] * S.pc[D + c];
          pk += S.pc[2 * D + c] * (v[k >> 1][2 * h + (k & 1)] + bv[k]);
        }
        pq = quad_sum(pq);
        pk = quad_sum(pk);
        const float d_q = pq / qm_h + d_sq_h, d_k = d_sk_h + pk;
        const float dzq = d_q * phi_grad(zq[h]) * m[h], dzk = d_k * phi_grad(zk[h]) * m[h];
        const float q = phi(zq[h]) * m[h], kk = phi(zk[h]) * m[h];
#pragma unroll
        for (int ni = 0; ni < 2; ++ni) {
          const int c = act_col(ni);
          float dv[2], at[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dv[e] = S.pc[2 * D + c + e] * kk;
            at[e] = (q / S.pc[c + e]) * S.pc[D + c + e];
            dbv[2 * ni + e] += dv[e];
          }
          put_split<BXS, PL, NP>(S.vs, s, c, dv[0], dv[1]);
          put_split<BXS, PL, NP>(S.as, s, c, at[0], at[1]);
        }
        if (lane_t() == 0) {
          put_dz<NP>(S.dz, s, hh, dzq, dzk);
          dzs[0] += dzq;
          dzs[1] += dzk;
        }
      }
    }
    __syncthreads();
    grad_tile<2, 2, BXS, PL, BXS, PL, NP>(S.hs, S.vs, 32 * wmr, 16 * hh, dwv);  // h^T d_v
    grad_tile<2, 2, BXS, PL, BXS, PL, NP>(S.as, S.gs, 32 * wmr, 16 * hh, dwo);  // attn^T g1
    if (warp < 4) grad_tile<1, 1, BXS, PL, DZS, DZPL, NP>(S.hs, S.dz, 16 * warp, 0, dwqk);
    dh_product<NP>(S.vs, S.dz, wm, S.hs);
    __syncthreads();
    ln_bwd_tile<D>(X, S.hs, G, w + AG_LNS, eps, nv, gx + off, nullptr, vds, vdb, vbo, unused);
  }
  __syncthreads();

  // the block's weight gradients, each sum in a fixed order
  float* wp = w_part + ((size_t)b * gridDim.x + blockIdx.x) * NWE;
  grad_store<2, 2>(&dwv[0][0][0], wp + WA_WV, D, 32 * wmr, 16 * hh);
  grad_store<2, 2>(&dwo[0][0][0], wp + WA_WO, D, 32 * wmr, 16 * hh);
  if (warp < 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mrow = 16 * warp + 8 * h + lane_g(), c = 2 * lane_t();
      float* dst = c < H ? wp + WA_WQ + mrow * H + c : wp + WA_WK + mrow * H + c - H;
      st2(dst, dwqk[0][0][2 * h], dwqk[0][0][2 * h + 1]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dbv[k] = rows_sum(dbv[k]);
  dzs[0] = rows_sum(dzs[0]);
  dzs[1] = rows_sum(dzs[1]);
  if (lane_g() == 0) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni)
      st2(S.pc + wmr * D + act_col(ni), dbv[2 * ni], dbv[2 * ni + 1]);
  }
  if (lane == 0) {
    S.pc[2 * D + wmr * H + hh] = dzs[0];
    S.pc[2 * D + 2 * H + wmr * H + hh] = dzs[1];
  }
  put_warp_sums(S.vs, 0, vds);
  put_warp_sums(S.vs, 1, vdb);
  put_warp_sums(S.vs, 2, vbo);
  __syncthreads();
  if (t < D) {
    wp[WA_LNS + t] = warp_sums_total(S.vs, 0);
    wp[WA_LNB + t] = warp_sums_total(S.vs, 1);
    wp[WA_BO + t] = warp_sums_total(S.vs, 2);
    wp[WA_BV + t] = S.pc[t] + S.pc[D + t];
  }
  if (t < H) {
    wp[WA_BQ + t] = S.pc[2 * D + t] + S.pc[2 * D + H + t];
    wp[WA_BK + t] = S.pc[2 * D + 2 * H + t] + S.pc[2 * D + 3 * H + t];
  }
}

template <int NP>
__global__ void __launch_bounds__(NT, 2) kernel_e(
    const float* __restrict__ x, const float* __restrict__ g1, const float* __restrict__ smask,
    const float* __restrict__ w, const float* __restrict__ wm, float* __restrict__ gx,
    float* __restrict__ w_part, int P, int L, int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  row_bwd<false, NP>(*reinterpret_cast<SmemE*>(smem_raw), x, g1, nullptr, smask, w, wm, gx,
                     w_part, P, L, S_, 1, eps);
}

template <int NP>
__global__ void __launch_bounds__(NT, 2) kernel_e2(
    const float* __restrict__ x, const float* __restrict__ g1, const float* __restrict__ rowsums,
    const float* __restrict__ smask, const float* __restrict__ w, const float* __restrict__ wm,
    float* __restrict__ gx, float* __restrict__ w_part, int P, int L, int SP, int SC, float eps) {
  extern __shared__ float4 smem_raw[];
  row_bwd<true, NP>(*reinterpret_cast<SmemE*>(smem_raw), x, g1, rowsums, smask, w, wm, gx,
                    w_part, P, L, SP, SC, eps);
}

// ======================= kernel D =======================
// The tile's per-site terms of the column backward (_derive_col_site_grads)
// for the thread's rows and columns: ctx and a1 / sk into the tables, the
// head terms of the warp's head (written by lanes t = 0).  The gates
// multiply, as in JAX; rows past the tile's end (stats 0) stay finite.
__device__ __forceinline__ void col_site_terms(SmemD& S, const float* __restrict__ stats_b,
                                               const float* __restrict__ a1_b, int l0, int nv,
                                               float n_pairs) {
  const int hh = warp_id() & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = act_row(h);
    float sk_raw[4], qm_raw[4], kv[4], a1v[4];
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      const int c = act_col(ni);
      float2 k = make_float2(0.f, 0.f), q = k, kvv = k, a = k;
      if (s < nv) {
        const float* st = stats_b + (size_t)(l0 + s) * 3 * D;
        k = ld2(st + c);
        q = ld2(st + D + c);
        kvv = ld2(st + 2 * D + c);
        a = ld2(a1_b + (size_t)(l0 + s) * D + c);
      }
      sk_raw[2 * ni] = k.x;
      sk_raw[2 * ni + 1] = k.y;
      qm_raw[2 * ni] = q.x / n_pairs;
      qm_raw[2 * ni + 1] = q.y / n_pairs;
      kv[2 * ni] = kvv.x;
      kv[2 * ni + 1] = kvv.y;
      a1v[2 * ni] = a.x;
      a1v[2 * ni + 1] = a.y;
    }
    float ctx[4], skv[4], sk_h = 0.f, qm_h = 0.f, skr_h = 0.f, qmr_h = 0.f, dsk = 0.f, dqm = 0.f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float qm_e = guard(qm_raw[k]), sk_e = guard(sk_raw[k]);
      ctx[k] = kv[k] / sk_e;
      skv[k] = a1v[k] / sk_e;
      sk_h += sk_e;
      qm_h += qm_e;
      skr_h += sk_raw[k];
      qmr_h += qm_raw[k];
      dsk += a1v[k] * ctx[k];
      dqm += ctx[k] * qm_e * a1v[k];
    }
    sk_h = quad_sum(sk_h) / HD;
    qm_h = quad_sum(qm_h) / HD;
    const float d_sk_h = -quad_sum(dsk) / sk_h * gate(quad_sum(skr_h));
    const float d_qm_h = -quad_sum(dqm) / (qm_h * qm_h) * gate(quad_sum(qmr_h));
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) {
      st2(S.ctx + sw(s, act_col(ni)), ctx[2 * ni], ctx[2 * ni + 1]);
      st2(S.skv + sw(s, act_col(ni)), skv[2 * ni], skv[2 * ni + 1]);
    }
    if (lane_t() == 0) {
      S.th[s * H + hh] = qm_h;
      S.th[BT * H + s * H + hh] = d_qm_h / n_pairs;
      S.th[2 * BT * H + s * H + hh] = d_sk_h;
    }
  }
}

// Kernel D: the column-attention backward, pass 2 of kernel E with the
// pair's terms replaced by the per-site terms of the tile.  A block owns a
// contiguous range of pairs of one batch element and walks the site tiles
// outermost, its pairs innermost, so the site terms are built once a tile.
template <int NP>
__global__ void __launch_bounds__(NT, 2) kernel_d(
    const float* __restrict__ x1, const float* __restrict__ g2, const float* __restrict__ stats,
    const float* __restrict__ a1, const float* __restrict__ pmask,
    const float* __restrict__ pair_count, const float* __restrict__ w,
    const float* __restrict__ wm, float* __restrict__ g1, float* __restrict__ w_part, int P,
    int L, int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  SmemD& S = *reinterpret_cast<SmemD*>(smem_raw);
  const int b = blockIdx.y, slot = blockIdx.x, t = threadIdx.x;
  const int warp = warp_id(), lane = t & 31, hh = warp & 3, wmr = warp >> 2;
  int p0, p1;
  split_range(slot, P, S_, p0, p1);
  float dwv[2][2][4], dwqk[1][1][4];
  zero<16>(&dwv[0][0][0]);
  zero<4>(&dwqk[0][0][0]);
  float dbv[4] = {0.f, 0.f, 0.f, 0.f}, dzs[2] = {0.f, 0.f};
  float vds[2] = {0.f, 0.f}, vdb[2] = {0.f, 0.f}, unused[2] = {0.f, 0.f};
  float bv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) bv[k] = w[AG_BV + act_col(k >> 1) + (k & 1)];
  const float bq = w[AG_BQ + hh], bk = w[AG_BK + hh];
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const float* a1_b = a1 + (size_t)b * L * D;
  const int np = p1 - p0, n = ((L + BT - 1) / BT) * np;
  const size_t row_b = (size_t)b * P;

  if (n > 0) {
    const size_t off = (row_b + p0) * L * D;
    tile_issue<D>(S.xs[0], x1 + off, min(BT, L));
    tile_issue<D>(S.g2[0], g2 + off, min(BT, L));
    cp_commit();
  }
  for (int i = 0; i < n; ++i) {
    const int p = p0 + i % np, l0 = (i / np) * BT, nv = min(BT, L - l0);
    const size_t off = ((row_b + p) * L + l0) * D;
    const float* X = S.xs[i & 1];
    const float* G = S.g2[i & 1];
    cp_wait_all();
    __syncthreads();
    if (i + 1 < n) {
      const int pn = p0 + (i + 1) % np, ln = ((i + 1) / np) * BT;
      const size_t offn = ((row_b + pn) * L + ln) * D;
      tile_issue<D>(S.xs[(i + 1) & 1], x1 + offn, min(BT, L - ln));
      tile_issue<D>(S.g2[(i + 1) & 1], g2 + offn, min(BT, L - ln));
      cp_commit();
    }
    if (p == p0) col_site_terms(S, stats_b, a1_b, l0, nv, n_pairs);  // read after the barrier
    ln_split_rows<D, NWARP, NP>(X, S.hs, w + AG_LNS, w + AG_LNB, eps);
    split_tile<D, NT, NP>(G, S.gs);
    __syncthreads();
    float z[1][4], v[2][4], da[2][4], zq[2], zk[2];
    row_products<NP>(S.hs, S.gs, wm, z, v, da);  // d_attn = g2 Wo_c^T
    head_z(z, zq, zk);
    const float pm = pmask[row_b + p];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = act_row(h);
      const float m = s < nv ? pm : 0.f;
      float ctx[4], skv[4], pq = 0.f, pk = 0.f;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const float2 cx = ld2(S.ctx + sw(s, act_col(ni))), sv = ld2(S.skv + sw(s, act_col(ni)));
        ctx[2 * ni] = cx.x;
        ctx[2 * ni + 1] = cx.y;
        skv[2 * ni] = sv.x;
        skv[2 * ni + 1] = sv.y;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        pq += da[k >> 1][2 * h + (k & 1)] * ctx[k];
        pk += skv[k] * (v[k >> 1][2 * h + (k & 1)] + bv[k]);
      }
      pq = quad_sum(pq);
      pk = quad_sum(pk);
      const float d_q = pq / S.th[s * H + hh] + S.th[BT * H + s * H + hh];
      const float d_k = S.th[2 * BT * H + s * H + hh] + pk;
      const float zqh = zq[h] + bq, zkh = zk[h] + bk;
      const float dzq = d_q * phi_grad(zqh) * m, dzk = d_k * phi_grad(zkh) * m;
      const float kk = phi(zkh) * m;
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const float dv0 = skv[2 * ni] * kk, dv1 = skv[2 * ni + 1] * kk;
        dbv[2 * ni] += dv0;
        dbv[2 * ni + 1] += dv1;
        put_split<BXS, PL, NP>(S.vs, s, act_col(ni), dv0, dv1);
      }
      if (lane_t() == 0) {
        put_dz<NP>(S.dz, s, hh, dzq, dzk);
        dzs[0] += dzq;
        dzs[1] += dzk;
      }
    }
    __syncthreads();
    grad_tile<2, 2, BXS, PL, BXS, PL, NP>(S.hs, S.vs, 32 * wmr, 16 * hh, dwv);  // hc^T d_v
    if (warp < 4) grad_tile<1, 1, BXS, PL, DZS, DZPL, NP>(S.hs, S.dz, 16 * warp, 0, dwqk);
    dh_product<NP>(S.vs, S.dz, wm, S.hs);
    __syncthreads();
    ln_bwd_tile<D>(X, S.hs, G, w + AG_LNS, eps, nv, g1 + off, nullptr, vds, vdb, unused, unused);
  }
  __syncthreads();

  // the block's weight gradients, each sum in a fixed order
  float* wp = w_part + ((size_t)b * S_ + slot) * NWD;
  grad_store<2, 2>(&dwv[0][0][0], wp + WA_WV, D, 32 * wmr, 16 * hh);
  if (warp < 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mrow = 16 * warp + 8 * h + lane_g(), c = 2 * lane_t();
      float* dst = c < H ? wp + WA_WQ + mrow * H + c : wp + WA_WK + mrow * H + c - H;
      st2(dst, dwqk[0][0][2 * h], dwqk[0][0][2 * h + 1]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) dbv[k] = rows_sum(dbv[k]);
  dzs[0] = rows_sum(dzs[0]);
  dzs[1] = rows_sum(dzs[1]);
  float* red = S.ctx;  // the row warps' bias sums
  if (lane_g() == 0) {
#pragma unroll
    for (int ni = 0; ni < 2; ++ni) st2(red + wmr * D + act_col(ni), dbv[2 * ni], dbv[2 * ni + 1]);
  }
  if (lane == 0) {
    red[2 * D + wmr * H + hh] = dzs[0];
    red[2 * D + 2 * H + wmr * H + hh] = dzs[1];
  }
  put_warp_sums(S.vs, 0, vds);
  put_warp_sums(S.vs, 1, vdb);
  __syncthreads();
  if (t < D) {
    wp[WA_LNS + t] = warp_sums_total(S.vs, 0);
    wp[WA_LNB + t] = warp_sums_total(S.vs, 1);
    wp[WA_BV + t] = red[t] + red[D + t];
  }
  if (t < H) {
    wp[WA_BQ + t] = red[2 * D + t] + red[2 * D + H + t];
    wp[WA_BK + t] = red[2 * D + 2 * H + t] + red[2 * D + 3 * H + t];
  }
}

template <typename Sm, typename K>
static cudaError_t allow_smem_of(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Sm));
}

}  // namespace bt
}  // namespace pf

using namespace pf;
using namespace pf::bt;

extern "C" {

// Layouts, tile size and shared memory, for the wrapper to check its own.
int pf_bwd_tc_sizes(int* out) {
  out[0] = CB_SIZE;
  out[1] = CTM_SIZE;
  out[2] = AG_SIZE;
  out[3] = EM_SIZE;
  out[4] = NWC;
  out[5] = NWD;
  out[6] = NWE;
  out[7] = BT;
  out[8] = (int)sizeof(SmemC);
  out[9] = (int)sizeof(SmemD);
  out[10] = (int)sizeof(SmemE);
  return 0;
}

// Each entry takes the products' TF32 passes (3 or 1; any other count is an
// invalid-value error) and launches the kernel built for them.
int pf_kernel_c(const float* x1, const float* g3, const float* stats, const float* pmask,
                const float* pair_count, const float* w, const float* wm, float* g2,
                float* a1_part, float* w_part, int B, int P, int L, int S_, float eps,
                int passes, void* stream) {
  return with_passes(passes, [&](auto np) {
    auto* kernel_c = bt::kernel_c<decltype(np)::value>;
    cudaError_t e = allow_smem_of<SmemC>(kernel_c);
    if (e != cudaSuccess) return (int)e;
    kernel_c<<<dim3(S_, B), C_NT, sizeof(SmemC), (cudaStream_t)stream>>>(
        x1, g3, stats, pmask, pair_count, w, wm, g2, a1_part, w_part, P, L, S_, eps);
    return (int)cudaGetLastError();
  });
}

int pf_kernel_d(const float* x1, const float* g2, const float* stats, const float* a1,
                const float* pmask, const float* pair_count, const float* w, const float* wm,
                float* g1, float* w_part, int B, int P, int L, int S_, float eps, int passes,
                void* stream) {
  return with_passes(passes, [&](auto np) {
    auto* kernel_d = bt::kernel_d<decltype(np)::value>;
    cudaError_t e = allow_smem_of<SmemD>(kernel_d);
    if (e != cudaSuccess) return (int)e;
    kernel_d<<<dim3(S_, B), pf::NT, sizeof(SmemD), (cudaStream_t)stream>>>(
        x1, g2, stats, a1, pmask, pair_count, w, wm, g1, w_part, P, L, S_, eps);
    return (int)cudaGetLastError();
  });
}

int pf_kernel_e(const float* x, const float* g1, const float* smask, const float* w,
                const float* wm, float* gx, float* w_part, int B, int P, int L, int S_,
                float eps, int passes, void* stream) {
  return with_passes(passes, [&](auto np) {
    auto* kernel_e = bt::kernel_e<decltype(np)::value>;
    cudaError_t e = allow_smem_of<SmemE>(kernel_e);
    if (e != cudaSuccess) return (int)e;
    kernel_e<<<dim3(S_, B), pf::NT, sizeof(SmemE), (cudaStream_t)stream>>>(
        x, g1, smask, w, wm, gx, w_part, P, L, S_, eps);
    return (int)cudaGetLastError();
  });
}

int pf_kernel_e2(const float* x, const float* g1, const float* rowsums, const float* smask,
                 const float* w, const float* wm, float* gx, float* w_part, int B, int P, int L,
                 int SP, int SC, float eps, int passes, void* stream) {
  return with_passes(passes, [&](auto np) {
    auto* kernel_e2 = bt::kernel_e2<decltype(np)::value>;
    cudaError_t e = allow_smem_of<SmemE>(kernel_e2);
    if (e != cudaSuccess) return (int)e;
    kernel_e2<<<dim3(SP * SC, B), pf::NT, sizeof(SmemE), (cudaStream_t)stream>>>(
        x, g1, rowsums, smask, w, wm, gx, w_part, P, L, SP, SC, eps);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
