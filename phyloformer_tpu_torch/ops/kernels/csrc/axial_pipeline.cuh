// Shapes and packed weight layouts of the axial-block kernels.
//
// The kernels are specialised to the repository's one model width, d = 64
// with 4 heads (head dim 16).  The q/k projections arrive pre-expanded to
// d x d (each head's column repeated over its 16 value lanes, as
// `expand_qk_weights` does), so every attention step is a d-wide
// elementwise operation and the head count does not appear in the kernels.
//
// Every weight group is one contiguous fp32 buffer (the "flat" layout
// below); the forward kernels also take the group's matrices packed for the
// tensor cores (the "mma" layout below, made once per group by
// `pipeline.pack_mma`).  The offsets must match `ops/kernels/pipeline.py`
// (`ROW_SIZE`, `COL_SIZE`, `B_SIZE`, `HEAD_SIZE`, `ROW_MMA_SIZE`,
// `COL_MMA_SIZE`, `B_MMA_SIZE`, `TILE_SITES`, `FWD_TILE_SITES` there are
// checked against `pf_weight_sizes` at load time, and by a CPU test that
// parses this file).
#pragma once

namespace pf {

constexpr int D = 64;            // model width
constexpr int F = 4 * D;         // FFN hidden width
constexpr int NT = 256;          // threads per block
constexpr int NWARP = NT / 32;

// Variant codes of the forward kernels' host entries, as the wrappers pass
// them (ops/kernels/pipeline.py: GELU_MODES' index, STORAGE_CODES, PASSES):
// the FFN's activation, the storage type of x1 between the pipeline's
// kernels, and the TF32 passes of every product.
constexpr int GELU_EXACT = 0;
constexpr int GELU_TANH = 1;
constexpr int GELU_SIGMOID = 2;
constexpr int GELU_RELU = 3;
constexpr int STORE_F32 = 0;
constexpr int STORE_BF16 = 1;
constexpr int PASSES_SPLIT = 3;  // split TF32: within ~2^-22 of the fp32 product
constexpr int PASSES_ONE = 1;    // one TF32 pass: tf32(a) tf32(w), fp32 accumulation

// Kernel E1 (axial_bwd.cu): sites per tile of its stream.
constexpr int TS = 16;

static_assert(NT == F, "the FFN up-projection maps one thread to one hidden column");

// The forward kernels (P0, A-only, A, M, Z, A1, A2, B): split-TF32
// tensor-core products on 64-site tiles.
constexpr int FT = 64;           // sites per tile
constexpr int XS = D + 4;        // row stride of a tile in shared memory (floats):
                                 // fragment loads of 8 rows x 4 columns hit 32 banks
// A product's FT x 64 output is split over the 8 warps in WM x WN tiles of
// MI x NI fragments of 16 x 8.
constexpr int WM = 32;           // output rows of a warp
constexpr int MG = FT / WM;      // warps along the rows
constexpr int NGW = NWARP / MG;  // warps along the columns
constexpr int WN = D / NGW;      // output columns of a warp
constexpr int MI = WM / 16;
constexpr int NI = WN / 8;
static_assert(WM == 32 || WM == 16, "the epilogues are written for warp tiles of 32 x 16 or 16 x 32");

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

// The mma layout: each K x N matrix of a group as 2 K N floats, for k-step
// j < K/8 and n-tile n < N/8 the 32 lanes' B fragments of
// mma.m16n8k8.tf32, one float4 a lane: (big b0, big b1, small b0, small b1)
// with b0 = W[8j + t][8n + g], b1 = W[8j + t + 4][8n + g] for lane 4g + t,
// big = tf32_rna(W), small = tf32_rna(W - big).  Offsets in floats.
constexpr int MM_D = 2 * D * D;  // one packed d x d matrix
constexpr int RM_WQ = 0;
constexpr int RM_WK = RM_WQ + MM_D;
constexpr int RM_WV = RM_WK + MM_D;
constexpr int RM_WO = RM_WV + MM_D;
constexpr int RM_SIZE = RM_WO + MM_D;
constexpr int CM_WQ = 0;
constexpr int CM_WK = CM_WQ + MM_D;
constexpr int CM_WV = CM_WK + MM_D;
constexpr int CM_SIZE = CM_WV + MM_D;
constexpr int BM_CWQ = 0;
constexpr int BM_CWO = BM_CWQ + MM_D;
constexpr int BM_W1 = BM_CWO + MM_D;
constexpr int BM_W2 = BM_W1 + 2 * D * F;
constexpr int BM_SIZE = BM_W2 + 2 * F * D;

// Kernel M's weight planes (axial_pipeline_m.cu; made once per group by
// `pipeline.pack_wg`): each 64 x 64 K x N block of a group's matrices as
// the shared-memory image its warpgroup MMA reads, big TF32 image then
// small, WG_PLANE floats.  Image element (n, k) is float
// (k / 4) 256 + (n / 8) 32 + (n % 8) 4 + k % 4 of each half.  The w2 planes
// follow an accumulator used as the A operand from registers, so their
// rows are permuted: physical k = 8j + s holds logical 8j + 2 (s % 4) + s / 4.
// Offsets in planes.
constexpr int WG_PLANE = 2 * D * D;
constexpr int BG_CWQ = 0;
constexpr int BG_CWO = 1;
constexpr int BG_W1 = 2;         // four planes: w1's columns 64c .. 64c + 63
constexpr int BG_W2 = 6;         // four planes: w2's rows 64c .. 64c + 63, permuted
constexpr int BG_PLANES = 10;
constexpr int RG_WQ = 0;
constexpr int RG_WK = 1;
constexpr int RG_WV = 2;
constexpr int RG_WO = 3;
constexpr int RG_PLANES = 4;
constexpr int CG_WQ = 0;
constexpr int CG_WK = 1;
constexpr int CG_WV = 2;
constexpr int CG_PLANES = 3;
constexpr int BG_SIZE = BG_PLANES * WG_PLANE;
constexpr int RG_SIZE = RG_PLANES * WG_PLANE;
constexpr int CG_SIZE = CG_PLANES * WG_PLANE;
// Kernel M's consumer warpgroups a block: each writes its own row-sum and
// column-partial slots.
constexpr int M_CONSUMERS = 2;

// Shared memory of one forward block (~104 KB: two blocks an SM).  The
// products' A operands are kept split, a big and a small TF32 plane each.
struct Smem {
  float xs[FT * XS];        // residual stream of the tile
  float hs[2][FT * XS];     // LayerNorm output
  float as[2][FT * XS];     // attention output before its projection; a 64-wide
                            // chunk of the FFN hidden
  float stage[FT * XS];     // the next tile, in flight (cp.async); a bf16 tile takes
                            // the first FT x D x 2 bytes
  float red[3 * MG * D];    // the row-warp groups' row sums, combined in a fixed order
  float wsum[NWARP];
  float count;              // max(real site count, 1) of the block's batch element
};

}  // namespace pf
