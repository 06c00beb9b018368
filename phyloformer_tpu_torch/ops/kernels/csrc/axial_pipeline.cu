// Pipelined Phyloformer axial-block kernels for Hopper (sm_90a): split-TF32
// products on the tensor cores.
//
// Hand-written CUDA counterparts of the Pallas TPU kernels of
// phyloformer_tpu/ops/pallas/pipeline.py and of the resident kernel A of
// phyloformer_tpu/ops/pallas/axial_block.py:
//
//   pf_kernel_p0      <- _kernel_p0      (pipeline.py:100): pair gather + block-0 kernel A
//   pf_kernel_a_only  <- _kernel_a_only  (pipeline.py:145): kernel A on a gathered pair tensor
//   pf_kernel_a       <- _kernel_a       (axial_block.py:252): the same function, out of place
//   pf_kernel_m       <- _kernel_m       (pipeline.py:176): kernel B of block i + kernel A of i+1
//                        (axial_pipeline_m.cu: x1 fp32, on warpgroup MMA, its own design note;
//                        axial_pipeline_m_bf16.cu: x1 bf16, on the bodies and design below)
//   pf_kernel_z       <- _kernel_z       (pipeline.py:214): last kernel B + softplus head + site mean
//
// The stats accumulation across sequential grid steps (pl.when(pi == 0) init,
// then +=; pipeline.py:136-142) is pf_reduce_slots of slot_reduce.cu, the
// slot reduction it shares with the backward's partials.
//
// They are built from the device bodies of axial_bodies.cuh, which mirror
// phyloformer_tpu/ops/pallas/axial_block.py: row attention (_body_row_attn,
// :172), column-stats partial sums (_body_col_stats, :204) and kernel B
// (_body_b, :224).  The plain PyTorch versions of the same functions are in
// ops/kernels/axial_block.py and ops/kernels/pipeline.py.  The L-tiled
// kernels A1, A2 and the standalone kernel B are in axial_fused.cu.
//
// What bounds them on the card.  Per pair-site, kernel A does 7 d x d
// products (57,344 FLOP), kernel B 2 d x d + 2 d x 4d (81,920), M both
// (139,264), while each moves 512 B of activations (M, A-only in place;
// x is read twice by A, once per pass).  The products run on the TF32
// tensor cores in three passes, so the card does 3x those FLOPs: at 495
// TFLOP/s (dense TF32) A needs 0.35 ns a pair-site, B 0.50, M 0.84, against
// 0.15 ns for 512 B at 3.35 TB/s.  Tensor-core arithmetic stays the bound,
// and the stages around the products (LayerNorm, phi, GELU's erff, the
// masks, the operand feed) are what the kernels spend most time on.
//
// Why three passes.  The tensor cores read TF32 (10 mantissa bits); one pass
// on fp32 operands rounded to TF32 keeps about 3 decimal digits (~3e-4
// relative on these products), far outside the port's fp32 bars (kernel vs
// plain 2e-5, distances vs the eager model 1e-4).  Each operand is split
// into big = cvt.rna.tf32(x) and small = cvt.rna.tf32(x - big), and the
// product is a_small·b_big + a_big·b_small + a_big·b_big accumulated in
// fp32: within ~2^-22 of the fp32 product, about as close as fp32 FMA
// itself (tests/test_torch_tf32.py).
//
// Reduced-precision variants (the JAX package's matmul_precision and
// pipeline_act_dtype, chosen by the host entries' codes):
// - One TF32 pass (NP = 1, matmul_precision "tensorfloat32" or "default"):
//   each product is tf32_rna(a)·tf32_rna(w) accumulated in fp32, a third of
//   the tensor-core work and half the weight loads; the small planes are
//   neither written nor read.  Every forward kernel has it.
// - bf16 storage of x1 (P0, A-only, M and Z): x1 is read and written as
//   __nv_bfloat16, 8 values a 16-byte cp.async, widened to fp32 in shared
//   memory; the stored value is rounded to nearest even, and the column
//   stats are taken from the rounded x1 (JAX's rule: the next kernel reads
//   what was stored).  P0 still gathers from the fp32 embedding.  Compute,
//   stats and partials stay fp32.  Kernel M at fp32 storage writes x3 in
//   place between its passes; at bf16 that would round x3 as well, so its
//   second pass runs kernel B again on the stored x1 instead (x3 is the
//   same bits both times): bf16 storage costs M a second kernel B.
// - The FFN's activation in M and Z: exact, tanh, sigmoid, relu, each at
//   both pass counts and both storage types (16 instantiations of each).
//
// Design.
// - One block of 256 threads (8 warps, two blocks an SM: ~104 KB of shared
//   memory and at most 128 registers a thread) owns a contiguous range of
//   pairs of one batch element and walks each pair row in tiles of 64 sites.
// - Products: mma.sync.m16n8k8 TF32.  A tile's product is 64 x 64 (the FFN's
//   64 x 256 in four 64-wide chunks); warp w owns 32 rows x 16 columns, 2 x 2
//   fragments; every stage ends at a block-wide barrier, so the SM's warps
//   either feed the tensor cores or run the stages around them.  Kernel M at
//   fp32 storage left this design for warpgroup MMA with two warpgroups on
//   their own tiles, the weights streamed through shared memory one 64 x 64
//   plane at a time (axial_pipeline_m.cu); the kernels here (and M at bf16
//   storage) still run mma.sync and are the next candidates for that design.
// - Operands.  A (the LayerNorm output, the attention output, a GELU chunk)
//   is split once where it is made and kept in shared memory as a big and a
//   small plane with a 68-float row stride, so each fragment load of 8 rows
//   x 4 columns hits 32 distinct banks and no warp splits it again (four
//   warps read each A fragment: splitting in the product loop cost each of
//   them the split).  The weights are packed once per weight group in the
//   wrapper (pipeline.pack_mma) in the fragment order the mma reads, already
//   split: each B fragment is one 16-byte load a lane, coalesced, served
//   from L1/L2 (all kernels share one layout, including M, whose weights
//   exceed shared memory).
// - Tiles arrive asynchronously: cp.async copies the next tile into a stage
//   buffer while the current one computes (axial_bodies.cuh, stage_load /
//   stage_take), in pass 1, pass 2 and B's item loop (P0 adds emb[j], which
//   stays in L2, as it takes the tile); a ragged last tile is zero-filled
//   and masked, so nothing is read or written past L.
// - Row attention needs sums over the whole site axis before any output.
//   Pass 1 walks a pair's row and accumulates Σq, Σk, Σk·v in registers
//   (the one-pass ctx = Σk·v / Σk, equal to Σ(k/Σk)·v up to rounding); the
//   16 row groups' sums are combined in a fixed order, the pair's raw sums
//   go to a small scratch buffer, and pass 2 finalizes them with the guards.
//   Pass 2 walks the row again and writes x1.  In kernel M the first pass
//   runs kernel B and writes x3 in place over x1, so the second pass reads
//   x3 back (a row of up to 1024 sites does not fit shared memory).  No
//   kernel here has a site cap; the engine sends buckets above 1024 sites to
//   A1/A2/B all the same, as the JAX engine does.
// - Column stats are sums over pairs, which CUDA blocks cannot carry across
//   one another.  Pass 2 runs tiles outermost and the block's pairs
//   innermost, so each thread sums its 16 (site, column) entries' stats over
//   the block's pairs in registers and writes one (L, 3d) partial per block.
//   pf_reduce_slots then sums the partials in an order fixed by the shapes
//   and the SM count (reduce.reduce_plan): no float atomics, so two runs give
//   the same bits.  The grid is 8 blocks an SM (four waves of the two that
//   fit), and the wrapper of pf_kernel_a caps the block count so that the
//   partials stay under a fixed budget (ops/kernels/fused.py).
// - x1 is updated in place (A-only and M): a block reads each tile of its
//   own pair rows before it writes that tile and never reads it again.  The
//   incoming stats are read-only; the wrapper gives every kernel a fresh
//   stats buffer (ping-pong), since other blocks still read the old one.
//   pf_kernel_a writes x1 to its own buffer and leaves x as it was.
// - Activation pointers are never marked __restrict__ or read through the
//   non-coherent cache: the in-place kernels read what the block itself
//   wrote earlier in the same launch.
//
// Numerics match the JAX bodies: masked q/k, zero-sum guards
// where(s > 0, s, 1), counts max(count, 1), the column q-mean divided by the
// number of real pairs, stats laid out [Σk | Σq | Σk·v], row sums laid out
// [Σq | Σk | Σk·v].  LayerNorm, φ, the masks, the guards and the GELU stay
// fp32 on the SIMT cores.  Exact GELU uses erff, φ(x) = x > 0 ? x + 1 :
// exp(x) with exp as exp2f(x · log2 e) (phi_f: within ~2 ulp + |x| 2^-24 of
// expf, a third of its instructions; φ is five of A's epilogues), softplus =
// max(x,0) + log1p(exp(-|x|)).

#include "axial_bodies.cuh"

namespace pf {

// ---- kernel A: row attention + column stats.  GATHER: the pair rows are
// emb[i] + emb[j] (_kernel_p0, emb fp32); else read from x (_kernel_a_only
// with x_out == x, x1 in place; axial_block.py _kernel_a with x_out != x),
// stored as TX.  x1 is written as TX. ----
template <bool GATHER, int NP, typename TX>
__global__ void __launch_bounds__(NT, 2) kernel_a(
    const void* x, const int* __restrict__ ii, const int* __restrict__ jj, TX* x_out,
    const float* __restrict__ smask, const float* __restrict__ pmask,
    const float* __restrict__ rw, const float* __restrict__ rm, const float* __restrict__ cw,
    const float* __restrict__ cm, float* rowsum, float* partial, int n, int P, int L, int S_,
    float eps) {
  using TI = std::conditional_t<GATHER, float, TX>;
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  set_site_count(smask_b, L, S);
  const float* emb_b = GATHER ? static_cast<const float*>(x) + (size_t)b * n * L * D : nullptr;
  const TI* x_b = GATHER ? nullptr : static_cast<const TI*>(x) + (size_t)b * P * L * D;
  float* rowsum_b = rowsum + (size_t)b * P * 3 * D;

  row_pass1<NP>(S, x_b, emb_b, ii, jj, rw, rm, smask_b, p0, p1, L, eps, rowsum_b);
  pass2<NP>(S, x_b, emb_b, ii, jj, x_out + (size_t)b * P * L * D, smask_b,
            pmask + (size_t)b * P, rw, rm, cw, cm, rowsum_b,
            partial + ((size_t)b * S_ + blockIdx.x) * L * 3 * D, p0, p1, 0, n_ftiles_of(L), L,
            eps);
}

// ---- kernel Z: last kernel B + head (d -> 1, fp32 on the SIMT cores at
// every pass count) + softplus + masked site mean ----
template <int GELU, int NP, typename TX>
__global__ void __launch_bounds__(NT, 2) kernel_z(
    const TX* x, const float* __restrict__ stats, const float* __restrict__ smask,
    const float* __restrict__ pair_count, const float* __restrict__ bw,
    const float* __restrict__ bm, const float* __restrict__ hw, float* out, int P, int L,
    int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  const float count = fmaxf(block_sum(smask_b, L, S), 1.f);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const TX* x_b = x + (size_t)b * P * L * D;
  const float h0 = hw[H_W + lane], h1 = hw[H_W + lane + 32], hb = hw[H_B];

  const int nt = n_ftiles_of(L), items = (p1 - p0) * nt;
  float sum = 0.f;
  if (items > 0) stage_load(S, row_src<TX>(x_b, nullptr, nullptr, nullptr, p0, 0, L));
  for (int i = 0; i < items; ++i) {
    const int p = p0 + i / nt, t = i % nt, l0 = t * FT;
    const TileSrc<TX> cur = row_src<TX>(x_b, nullptr, nullptr, nullptr, p, t, L);
    const int nv = cur.nv;
    stage_take(S, cur);
    __syncthreads();
    if (i + 1 < items) {
      stage_load(S, row_src<TX>(x_b, nullptr, nullptr, nullptr, p0 + (i + 1) / nt, (i + 1) % nt,
                                L));
    }
    if (t == 0) sum = 0.f;
    body_b<GELU, NP>(S, bw, bm, stats_b, l0, nv, n_pairs, eps, nullptr);
    for (int s = warp; s < nv; s += NWARP) {
      const float h = warp_sum(S.xs[s * XS + lane] * h0 + S.xs[s * XS + lane + 32] * h1) + hb;
      sum += softplus(h) * smask_b[l0 + s];
    }
    __syncthreads();
    if (t == nt - 1) {
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
}

}  // namespace pf

using namespace pf;

extern "C" {

// The layout the kernels were built with, for the wrapper to check its own
// against: the flat and mma weight-group sizes and the tile sizes.
int pf_weight_sizes(int* out) {
  out[0] = R_SIZE;
  out[1] = C_SIZE;
  out[2] = B_SIZE;
  out[3] = H_SIZE;
  out[4] = RM_SIZE;
  out[5] = CM_SIZE;
  out[6] = BM_SIZE;
  out[7] = TS;
  out[8] = FT;
  out[9] = RG_SIZE;
  out[10] = CG_SIZE;
  out[11] = BG_SIZE;
  out[12] = M_CONSUMERS;
  return 0;
}

int pf_kernel_p0(const float* emb, const int* ii, const int* jj, void* x1,
                 const float* smask, const float* pmask, const float* rw, const float* rm,
                 const float* cw, const float* cm, float* rowsum, float* partial, int B, int n,
                 int P, int L, int S_, float eps, int passes, int storage, void* stream) {
  return with_passes(passes, [&](auto np) {
    return with_storage(storage, [&](auto tag) {
      using TX = typename std::decay_t<decltype(tag)>::type;
      return launch(kernel_a<true, std::decay_t<decltype(np)>::value, TX>, S_, B, stream,
                    static_cast<const void*>(emb), ii, jj, static_cast<TX*>(x1), smask, pmask,
                    rw, rm, cw, cm, rowsum, partial, n, P, L, S_, eps);
    });
  });
}

int pf_kernel_a_only(void* x, const float* smask, const float* pmask, const float* rw,
                     const float* rm, const float* cw, const float* cm, float* rowsum,
                     float* partial, int B, int P, int L, int S_, float eps, int passes,
                     int storage, void* stream) {
  return with_passes(passes, [&](auto np) {
    return with_storage(storage, [&](auto tag) {
      using TX = typename std::decay_t<decltype(tag)>::type;
      return launch(kernel_a<false, std::decay_t<decltype(np)>::value, TX>, S_, B, stream,
                    static_cast<const void*>(x), (const int*)nullptr, (const int*)nullptr,
                    static_cast<TX*>(x), smask, pmask, rw, rm, cw, cm, rowsum, partial, 0, P, L,
                    S_, eps);
    });
  });
}

int pf_kernel_a(const float* x, float* x1, const float* smask, const float* pmask,
                const float* rw, const float* rm, const float* cw, const float* cm,
                float* rowsum, float* partial, int B, int P, int L, int S_, float eps,
                int passes, void* stream) {
  return with_passes(passes, [&](auto np) {
    return launch(kernel_a<false, std::decay_t<decltype(np)>::value, float>, S_, B, stream,
                  static_cast<const void*>(x), (const int*)nullptr, (const int*)nullptr, x1,
                  smask, pmask, rw, rm, cw, cm, rowsum, partial, 0, P, L, S_, eps);
  });
}

int pf_kernel_z(const void* x, const float* stats, const float* smask,
                const float* pair_count, const float* bw, const float* bm, const float* hw,
                float* out, int B, int P, int L, int S_, float eps, int gelu, int passes,
                int storage, void* stream) {
  return with_variant(gelu, passes, storage, [&](auto g, auto np, auto tag) {
    using TX = typename std::decay_t<decltype(tag)>::type;
    constexpr int G = std::decay_t<decltype(g)>::value, NP = std::decay_t<decltype(np)>::value;
    return launch(kernel_z<G, NP, TX>, S_, B, stream,
                  static_cast<const TX*>(x), stats, smask, pair_count, bw, bm, hw, out, P, L,
                  S_, eps);
  });
}

const char* pf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
