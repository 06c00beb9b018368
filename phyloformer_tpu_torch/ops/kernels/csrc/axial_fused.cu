// The two-kernel fused block and its L-tiled form for Hopper (sm_90a):
// split-TF32 products on the tensor cores.
//
// Hand-written CUDA counterparts of the Pallas TPU kernels of
// phyloformer_tpu/ops/pallas/axial_block.py that the fused forward runs when
// the pipeline does not (forward_fused; L-tiled above 1024 sites):
//
//   pf_kernel_a1  <- _kernel_a1 (axial_block.py:314): per-pair raw row sums
//                    [Σq | Σk | Σk·v] (B, P, 3d) of the row attention
//   pf_kernel_a2  <- _kernel_a2 (axial_block.py:353): row attention finalized
//                    from those sums, x1, and the column-stat partials
//   pf_kernel_b   <- _kernel_b  (axial_block.py:294): column attention from the
//                    global stats + FFN (exact GELU): x1 -> x3, out of place
//
// Each takes the products' TF32 passes (three, or one for the
// reduced-precision forward); storage stays fp32 and the activation exact
// GELU, as in JAX's forward_fused.
//
// Kernel A of the two-kernel form (_kernel_a, :252) is pf_kernel_a in
// axial_pipeline.cu: the pipeline's kernel A, written out of place.  The
// column-stat partials are summed by pf_reduce_slots (slot_reduce.cu).  The
// device bodies are those of axial_bodies.cuh, shared with the pipeline; the
// products, their three TF32 passes, the packed weights and the tile
// staging are described in the note of axial_pipeline.cu.  The plain
// PyTorch versions are row_sums, row_finalize_col_stats and body_b in
// ops/kernels/axial_block.py.
//
// What bounds them on the card.  Per pair-site, A1 does 3 d x d products
// (24,576 FLOP) and reads 256 B, A2 5 d x d products (40,960 FLOP) and moves
// 512 B, B 2 d x d + 2 d x 4d (81,920 FLOP) and moves 512 B.  At three TF32
// passes on 495 TFLOP/s that is 0.15, 0.25 and 0.50 ns a pair-site, against
// 0.08, 0.15 and 0.15 ns of HBM traffic at 3.35 TB/s: all three are bound by
// tensor-core arithmetic, and in practice by the fp32 stages and operand
// feed around it.
//
// Design.
// - A1: one block of 256 threads owns a contiguous range of pairs and walks
//   each pair's whole row in 64-site tiles (the pipeline's pass 1).  The site
//   axis is never split across blocks, so each pair's sums come from one
//   block in one order: no float atomics, no second reduction.  The raw sums
//   are written, not the guarded q-mean and ctx: A2 guards them.
// - A2: the row sums are known, so a pair row no longer has to be walked
//   whole by one block.  The grid is (pair slots x site chunks, B): a block
//   owns a contiguous range of pairs and a contiguous range of site tiles,
//   and runs the pipeline's pass 2 over them (tiles outermost, pairs
//   innermost), writing x1 and one (L, 3d) column-stat partial per pair slot
//   (each block fills its chunk's rows).  pf_reduce_slots sums the slots in a
//   fixed order.  The partials are what limits the grid at long L: the 1056
//   blocks of the pipeline's rule would need 1.2 GB at L = 1536 and 3.3 GB at
//   L = 4096 (B = 1), all of which the reduction reads.  The wrapper
//   (ops/kernels/fused.py) therefore takes at most 64 pair slots and at most
//   what keeps the partials under 256 MiB, and fills the card with site
//   chunks instead.  Slot and chunk counts depend only on the shapes, so the
//   result is deterministic.
// - B is local to each pair-site: a block owns a contiguous range of
//   (pair, site tile) items and runs the kernel-B body on each, the next
//   item's tile in flight (cp.async) while this one computes, reading the
//   tile's slice of the column stats (a batch element's stats are 3 MB at
//   L = 4096, more than shared memory) and writing x3 to its own buffer, so
//   x1 survives for the residual contract (fused_axial_block_res).
// - Every kernel here is out of place: x, x1 and x3 are distinct buffers.
//   A ragged last tile is zero-filled on load and masked, so nothing is read
//   or written past L.  Activation offsets are size_t: B·P·L·d passes 2^31
//   from (200 tips, 2048 sites) on.

#include "axial_bodies.cuh"

namespace pf {

// ---- A1: raw row sums of each pair over the whole site axis ----
template <int NP>
__global__ void __launch_bounds__(NT, 2) kernel_a1(const float* __restrict__ x,
                                                   const float* __restrict__ smask,
                                                   const float* __restrict__ rw,
                                                   const float* __restrict__ rm,
                                                   float* __restrict__ rowstats, int P, int L,
                                                   int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  row_pass1<NP>(S, x + (size_t)b * P * L * D, nullptr, nullptr, nullptr, rw, rm,
            smask + (size_t)b * L, p0, p1, L, eps, rowstats + (size_t)b * P * 3 * D);
}

// ---- A2: x1 and column-stat partials of pair slot / site chunk ----
template <int NP>
__global__ void __launch_bounds__(NT, 2) kernel_a2(
    const float* __restrict__ x, const float* __restrict__ rowstats,
    const float* __restrict__ smask, const float* __restrict__ pmask,
    const float* __restrict__ rw, const float* __restrict__ rm, const float* __restrict__ cw,
    const float* __restrict__ cm, float* x1, float* partial, int P, int L, int SP, int SC,
    float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y, slot = blockIdx.x / SC, chunk = blockIdx.x % SC;
  int p0, p1, t0, t1;
  split_range(slot, P, SP, p0, p1);
  split_range(chunk, n_ftiles_of(L), SC, t0, t1);
  const float* smask_b = smask + (size_t)b * L;
  set_site_count(smask_b, L, S);
  pass2<NP>(S, x + (size_t)b * P * L * D, nullptr, nullptr, nullptr, x1 + (size_t)b * P * L * D,
        smask_b, pmask + (size_t)b * P, rw, rm, cw, cm, rowstats + (size_t)b * P * 3 * D,
        partial + ((size_t)b * SP + slot) * L * 3 * D, p0, p1, t0, t1, L, eps);
}

// ---- B: x3 of a contiguous range of (pair, site tile) items ----
template <int NP>
__global__ void __launch_bounds__(NT, 2) kernel_b(const float* __restrict__ x1,
                                                  const float* __restrict__ stats,
                                                  const float* __restrict__ pair_count,
                                                  const float* __restrict__ bw,
                                                  const float* __restrict__ bm,
                                                  float* __restrict__ x3, int P, int L, int S_,
                                                  float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y, nt = n_ftiles_of(L);
  int i0, i1;
  split_range(blockIdx.x, P * nt, S_, i0, i1);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const float* x1_b = x1 + (size_t)b * P * L * D;
  if (i0 < i1) stage_load(S, row_src(x1_b, nullptr, nullptr, nullptr, i0 / nt, i0 % nt, L));
  for (int i = i0; i < i1; ++i) {
    const int p = i / nt, l0 = (i % nt) * FT;
    const TileSrc<float> cur = row_src(x1_b, nullptr, nullptr, nullptr, p, i % nt, L);
    const int nv = cur.nv;
    stage_take(S, cur);
    __syncthreads();
    if (i + 1 < i1) {
      stage_load(S, row_src(x1_b, nullptr, nullptr, nullptr, (i + 1) / nt, (i + 1) % nt, L));
    }
    body_b<GELU_EXACT, NP>(S, bw, bm, stats_b, l0, nv, n_pairs, eps,
              x3 + ((size_t)b * P + p) * L * D + (size_t)l0 * D);
  }
}

}  // namespace pf

using namespace pf;

extern "C" {

int pf_kernel_a1(const float* x, const float* smask, const float* rw, const float* rm,
                 float* rowstats, int B, int P, int L, int S_, float eps, int passes,
                 void* stream) {
  return with_passes(passes, [&](auto np) {
    return launch(kernel_a1<std::decay_t<decltype(np)>::value>, S_, B, stream, x, smask, rw, rm,
                  rowstats, P, L, S_, eps);
  });
}

int pf_kernel_a2(const float* x, const float* rowstats, const float* smask, const float* pmask,
                 const float* rw, const float* rm, const float* cw, const float* cm, float* x1,
                 float* partial, int B, int P, int L, int SP, int SC, float eps, int passes,
                 void* stream) {
  return with_passes(passes, [&](auto np) {
    return launch(kernel_a2<std::decay_t<decltype(np)>::value>, SP * SC, B, stream, x,
                  rowstats, smask, pmask, rw, rm, cw, cm, x1, partial, P, L, SP, SC, eps);
  });
}

int pf_kernel_b(const float* x1, const float* stats, const float* pair_count, const float* bw,
                const float* bm, float* x3, int B, int P, int L, int S_, float eps, int passes,
                void* stream) {
  return with_passes(passes, [&](auto np) {
    return launch(kernel_b<std::decay_t<decltype(np)>::value>, S_, B, stream, x1, stats,
                  pair_count, bw, bm, x3, P, L, S_, eps);
  });
}

}  // extern "C"
