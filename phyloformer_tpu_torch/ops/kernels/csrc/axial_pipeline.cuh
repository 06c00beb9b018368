// Shapes and packed weight layouts of the pipelined axial-block kernels.
//
// The kernels are specialised to the repository's one model width, d = 64
// with 4 heads (head dim 16).  The q/k projections arrive pre-expanded to
// d x d (each head's column repeated over its 16 value lanes, as
// `expand_qk_weights` does), so every attention step is a d-wide
// elementwise operation and the head count does not appear in the kernels.
//
// Every weight group is one contiguous fp32 buffer; the offsets below must
// match `ops/kernels/pipeline.py` (`ROW_SIZE`, `COL_SIZE`, `B_SIZE`,
// `HEAD_SIZE` there are checked against `pf_weight_sizes` at load time).
#pragma once

namespace pf {

constexpr int D = 64;            // model width
constexpr int F = 4 * D;         // FFN hidden width
constexpr int TS = 32;           // sites per tile
constexpr int NT = 256;          // threads per block
constexpr int NG = NT / D;       // site groups in the d-wide products (4)
constexpr int SPT = TS / NG;     // sites per thread in the d-wide products (8)
constexpr int NWARP = NT / 32;

static_assert(NT == F, "the FFN up-projection maps one thread to one hidden column");
static_assert(TS % NG == 0, "tile must split evenly over the site groups");

// Row group (row LayerNorm + row attention):
//   ln_s, ln_b, wq (D x D), bq, wk (D x D), bk, wv (D x D), bv, wo (D x D), bo
constexpr int R_LNS = 0;
constexpr int R_LNB = R_LNS + D;
constexpr int R_WQ = R_LNB + D;
constexpr int R_BQ = R_WQ + D * D;
constexpr int R_WK = R_BQ + D;
constexpr int R_BK = R_WK + D * D;
constexpr int R_WV = R_BK + D;
constexpr int R_BV = R_WV + D * D;
constexpr int R_WO = R_BV + D;
constexpr int R_BO = R_WO + D * D;
constexpr int R_SIZE = R_BO + D;

// Column-stats group (column LayerNorm + column q/k/v):
//   ln_s, ln_b, wq, bq, wk, bk, wv, bv
constexpr int C_LNS = 0;
constexpr int C_LNB = C_LNS + D;
constexpr int C_WQ = C_LNB + D;
constexpr int C_BQ = C_WQ + D * D;
constexpr int C_WK = C_BQ + D;
constexpr int C_BK = C_WK + D * D;
constexpr int C_WV = C_BK + D;
constexpr int C_BV = C_WV + D * D;
constexpr int C_SIZE = C_BV + D;

// Kernel-B group (column attention from the stats + FFN):
//   cn_s, cn_b, cwq, cbq, cwo, cbo, fn_s, fn_b, w1 (D x F), b1 (F), w2 (F x D), b2
constexpr int B_CNS = 0;
constexpr int B_CNB = B_CNS + D;
constexpr int B_CWQ = B_CNB + D;
constexpr int B_CBQ = B_CWQ + D * D;
constexpr int B_CWO = B_CBQ + D;
constexpr int B_CBO = B_CWO + D * D;
constexpr int B_FNS = B_CBO + D;
constexpr int B_FNB = B_FNS + D;
constexpr int B_W1 = B_FNB + D;
constexpr int B_B1 = B_W1 + D * F;
constexpr int B_W2 = B_B1 + F;
constexpr int B_B2 = B_W2 + F * D;
constexpr int B_SIZE = B_B2 + D;

// Head group: hw (D), hb (1)
constexpr int H_W = 0;
constexpr int H_B = D;
constexpr int H_SIZE = D + 1;

// Shared memory of one block: one tile of TS sites of one pair row.
struct Smem {
  float xs[TS * D];     // residual stream of the tile
  float hs[TS * D];     // LayerNorm output
  float as[TS * D];     // attention output before its projection
  float fs[TS * F];     // FFN hidden
  float red[3 * NG * D];  // per-group row sums, combined in a fixed order
  float wsum[NWARP];
  float count;          // max(real site count, 1) of the block's batch element
};

}  // namespace pf
