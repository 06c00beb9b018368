// Packed weight layouts and weight-gradient layouts of the backward kernels
// (axial_bwd_tc.cu: C, D, E and E2; axial_bwd.cu: E1), the tiles and shared
// memory of the kernels on the tensor cores, and E1's streaming ring.
//
// The offsets must match ops/kernels/axial_block_bwd.py: C_PARTS and
// ATT_PARTS there give the flat groups, C_MMA_MATS and e_mma_mats the
// matrices packed for the tensor cores (pipeline.pack_mma's layout, see
// axial_pipeline.cuh), and grad_spec the flat weight-gradient vectors.
// pf_bwd_sizes and pf_bwd_tc_sizes report them to the wrapper at load time,
// and tests/test_torch_tf32_bwd.py parses this file.  E1's E1_WARPS and
// E1_PART are the wrapper's E1_WARPS and E1_PART, its tile TS
// (axial_pipeline.cuh) pipeline.TILE_SITES.
#pragma once

#include "axial_bodies.cuh"

namespace pf {

constexpr int H = 4;        // heads
constexpr int HD = D / H;   // lanes per head

// Packed kernel-C weights (flat): cn_s, cn_b, cwq_e (D x D), cbq_e, cwo,
// cwo_t, cbo, fn_s, fn_b, w1 (D x F), b1, w1_t (F x D), w2_t (D x F), cwq
// (D x H), cbq (H)
constexpr int CB_CNS = 0;
constexpr int CB_CNB = CB_CNS + D;
constexpr int CB_CWQE = CB_CNB + D;
constexpr int CB_CBQE = CB_CWQE + D * D;
constexpr int CB_CWO = CB_CBQE + D;
constexpr int CB_CWOT = CB_CWO + D * D;
constexpr int CB_CBO = CB_CWOT + D * D;
constexpr int CB_FNS = CB_CBO + D;
constexpr int CB_FNB = CB_FNS + D;
constexpr int CB_W1 = CB_FNB + D;
constexpr int CB_B1 = CB_W1 + D * F;
constexpr int CB_W1T = CB_B1 + F;
constexpr int CB_W2T = CB_W1T + F * D;
constexpr int CB_CWQ = CB_W2T + D * F;
constexpr int CB_CBQ = CB_CWQ + D * H;
constexpr int CB_SIZE = CB_CBQ + H;
// ... and its matrices in the mma layout: cwq_e, cwo, cwo_t, w1, w1_t, w2_t
constexpr int CTM_CWQ = 0;
constexpr int CTM_CWO = CTM_CWQ + 2 * D * D;
constexpr int CTM_CWOT = CTM_CWO + 2 * D * D;
constexpr int CTM_W1 = CTM_CWOT + 2 * D * D;
constexpr int CTM_W1T = CTM_W1 + 2 * D * F;
constexpr int CTM_W2T = CTM_W1T + 2 * F * D;
constexpr int CTM_SIZE = CTM_W2T + 2 * D * F;

// Packed attention weights of kernels D (column) and E, E1, E2 (row), flat:
// ln_s, ln_b, wq_e (D x D), bq_e, wk_e, bk_e, wv, bv, wo_t, wq (D x H), bq,
// wk, bk, wv_t
constexpr int AG_LNS = 0;
constexpr int AG_LNB = AG_LNS + D;
constexpr int AG_WQE = AG_LNB + D;
constexpr int AG_BQE = AG_WQE + D * D;
constexpr int AG_WKE = AG_BQE + D;
constexpr int AG_BKE = AG_WKE + D * D;
constexpr int AG_WV = AG_BKE + D;
constexpr int AG_BV = AG_WV + D * D;
constexpr int AG_WOT = AG_BV + D;
constexpr int AG_WQ = AG_WOT + D * D;
constexpr int AG_BQ = AG_WQ + D * H;
constexpr int AG_WK = AG_BQ + H;
constexpr int AG_BK = AG_WK + D * H;
constexpr int AG_WVT = AG_BK + H;
constexpr int AG_SIZE = AG_WVT + D * D;
// ... and the matrices of D, E and E2 in the mma layout: wqk = [wq | wk]
// (D x 2H), wv, wo_t, wdh = [wv_t ; wq^T ; wk^T] ((D + 2H) x D)
constexpr int EM_WQK = 0;
constexpr int EM_WV = EM_WQK + 2 * D * 2 * H;
constexpr int EM_WOT = EM_WV + 2 * D * D;
constexpr int EM_WDH = EM_WOT + 2 * D * D;
constexpr int EM_SIZE = EM_WDH + 2 * (D + 2 * H) * D;

// Weight-gradient vectors (grad_spec).
// C: dWo_c, dbo_c, dγ_f, dβ_f, dW1 (D x F), db1, dW2 (F x D), db2
constexpr int WC_CWO = 0;
constexpr int WC_CBO = WC_CWO + D * D;
constexpr int WC_FNS = WC_CBO + D;
constexpr int WC_FNB = WC_FNS + D;
constexpr int WC_W1 = WC_FNB + D;
constexpr int WC_B1 = WC_W1 + D * F;
constexpr int WC_W2 = WC_B1 + F;
constexpr int WC_B2 = WC_W2 + F * D;
constexpr int NWC = WC_B2 + D;
// D, E and E2: dγ, dβ, dWq (D x H), dbq, dWk, dbk, dWv, dbv; E and E2 add dWo, dbo
constexpr int WA_LNS = 0;
constexpr int WA_LNB = WA_LNS + D;
constexpr int WA_WQ = WA_LNB + D;
constexpr int WA_BQ = WA_WQ + D * H;
constexpr int WA_WK = WA_BQ + H;
constexpr int WA_BK = WA_WK + D * H;
constexpr int WA_WV = WA_BK + H;
constexpr int WA_BV = WA_WV + D * D;
constexpr int NWD = WA_BV + D;
constexpr int WA_WO = NWD;
constexpr int WA_BO = WA_WO + D * D;
constexpr int NWE = WA_BO + D;

// Kernel E1 (axial_bwd.cu): each warp streams its own TS-site tiles of x
// and g1 through a ring of E1_RING slots (E1_RING - 1 in flight while one
// computes) and leaves, per row segment, a partial [M | N | ΣqH | ΣkH].
constexpr int E1_WARPS = 4;                  // warps a block (2 blocks an SM)
constexpr int E1_RING = 3;                   // ring slots a warp
constexpr int E1_PART = 2 * D * H + 2 * H;   // floats of a partial

// Shared memory of one kernel-E1 block (96 KB: two blocks an SM).
struct SmemE1 {
  float tile[E1_WARPS * E1_RING * 2 * TS * D];  // per warp and slot: x, then g1
};

namespace bt {  // kernels C, D, E and E2 on the tensor cores

// Tiles of BT sites.  Every tile operand lives in shared memory as BT rows of
// BXS floats; element (r, c) sits at r BXS + (c ^ (r & 4)).  With BXS = 72
// and that swizzle, both fragment patterns of mma.m16n8k8 hit 32 distinct
// banks: rows g, columns t (an A fragment of a product over the channels)
// and rows t, columns g (the fragments of a weight gradient, whose K is the
// sites).  A split operand is two such planes, big then small.
constexpr int BT = 32;
constexpr int BXS = D + 8;
constexpr int PL = BT * BXS;   // floats of one plane
constexpr int DZS = 8;         // row stride of the [dzq | dzk] planes (same swizzle)
constexpr int DZPL = BT * DZS;

// Kernel C runs one block of C_WARPS warps an SM.
constexpr int C_WARPS = 8;
constexpr int C_NT = 32 * C_WARPS;

// Kernel C's FFN weight gradients dW1 and dW2, block-private in shared
// memory: 4 hidden chunks x 2 matrices of 64 x 64, each thread's mma
// accumulator values of a chunk matrix as float4 slots of its own.
constexpr int CGRAD = 2 * (F / D) * D * D;

// Shared memory of one kernel-C block (~220 KB: one block an SM).
struct SmemC {
  float xs[2][PL];      // x1 (then x2 in place) of this tile and the next (cp.async)
  float g3[2][PL];      // g3 of this tile and the next
  float hs[2 * PL];     // column LN output; then the FFN LN output; then attn again
  float as[2 * PL];     // attn; then a 64-wide chunk of gelu(u), then of du; then d_hf
  float gs[2 * PL];     // g3 split; then g2 split
  float red[2 * F];     // db1 of the two row-warp groups
  float4 grad[CGRAD / 4];
};

// Shared memory of one kernel-D block (~108 KB: two blocks an SM).
struct SmemD {
  float xs[2][BT * D];   // x1 of this tile and the next (cp.async), row stride D
  float g2[2][BT * D];   // g2 of this tile and the next
  float hs[2 * PL];      // column LN output; then d_h (big plane, fp32)
  float gs[2 * PL];      // g2 split
  float vs[2 * PL];      // d_v split; at the end the warps' sums
  float dz[2 * DZPL];    // [dzq | dzk] split
  float ctx[PL];         // the tile's per-site terms (swizzled rows): ctx, then
  float skv[PL];         // a1 / sk; at the end the row warps' bias sums in ctx
  float th[3 * BT * H];  // qm_h, d_qm_h / n_pairs and d_sk_h of each site and head
};

// Shared memory of one kernel-E or E2 block (~108 KB: two blocks an SM).
struct SmemE {
  float xs[2][BT * D];  // x of this tile and the next (cp.async), row stride D
  float g1[2][BT * D];  // g1 of this tile and the next
  float hs[2 * PL];     // row LN output; then d_h (big plane, fp32)
  float gs[2 * PL];     // g1 split
  float vs[2 * PL];     // d_v split
  float as[2 * PL];     // attention output before Wo, split
  float dz[2 * DZPL];   // [dzq | dzk] split; in pass 1's finalize the row-warp sums
  float pc[6 * D];      // the pair's qm, ctx, d_skv, qm_h, d_sk_h, d_sq_h (per lane)
  float wsum[NWARP];
  float count;          // max(real site count, 1)
};

}  // namespace bt
}  // namespace pf
