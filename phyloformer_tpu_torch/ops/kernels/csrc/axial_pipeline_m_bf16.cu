// Kernel M at bf16 storage of x1 (sm_90a): kernel B of block i, then kernel
// A of block i+1, on the mma.sync bodies of axial_bodies.cuh (the design in
// the note of axial_pipeline.cu).  Kernel M at fp32 storage runs on
// warpgroup MMA (axial_pipeline_m.cu); at bf16 its second pass runs kernel B
// again on the stored x1, so that x3 is never rounded, and kernel B's state
// beside the column sums does not fit the registers of that design's
// warpgroups.  The wrapper routes on x1's dtype and counts these launches
// under their own key (pipeline.LAUNCHES["kernel_m_bf16"]).

#include "axial_bodies.cuh"

namespace pf {

// ---- kernel M at bf16 storage: pass 1 runs kernel B and the row sums on
// x1, pass 2 runs kernel B again on the stored x1, then the row output and
// the column stats ----
template <int GELU, int NP>
__global__ void __launch_bounds__(NT, 2) kernel_m(
    bf16* x, const float* __restrict__ stats, const float* __restrict__ smask,
    const float* __restrict__ pmask, const float* __restrict__ pair_count,
    const float* __restrict__ bw, const float* __restrict__ bm, const float* __restrict__ rw,
    const float* __restrict__ rm, const float* __restrict__ cw, const float* __restrict__ cm,
    float* rowsum, float* partial, int P, int L, int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  set_site_count(smask_b, L, S);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  bf16* x_b = x + (size_t)b * P * L * D;
  float* rowsum_b = rowsum + (size_t)b * P * 3 * D;

  const int nt = n_ftiles_of(L), items = (p1 - p0) * nt;
  float rq[RC], rk[RC], rkv[RC];
  if (items > 0) stage_load(S, row_src<bf16>(x_b, nullptr, nullptr, nullptr, p0, 0, L));
  for (int i = 0; i < items; ++i) {
    const int p = p0 + i / nt, t = i % nt, l0 = t * FT;
    const TileSrc<bf16> cur = row_src<bf16>(x_b, nullptr, nullptr, nullptr, p, t, L);
    const int nv = cur.nv;
    stage_take(S, cur);
    __syncthreads();
    if (i + 1 < items) {
      stage_load(S, row_src<bf16>(x_b, nullptr, nullptr, nullptr, p0 + (i + 1) / nt,
                                  (i + 1) % nt, L));
    }
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < RC; ++c) rq[c] = rk[c] = rkv[c] = 0.f;
    }
    body_b<GELU, NP>(S, bw, bm, stats_b, l0, nv, n_pairs, eps, nullptr);
    row_sums<NP>(S, rw, rm, smask_b, l0, nv, eps, rq, rk, rkv);
    if (t == nt - 1) store_row_sums(S, rq, rk, rkv, rowsum_b + (size_t)p * 3 * D);
  }
  pass2<NP, bf16, bf16, GELU>(S, x_b, nullptr, nullptr, nullptr, x_b, smask_b,
                              pmask + (size_t)b * P, rw, rm, cw, cm, rowsum_b,
                              partial + ((size_t)b * S_ + blockIdx.x) * L * 3 * D, p0, p1, 0, nt,
                              L, eps, BArgs{bw, bm, stats_b, n_pairs});
}

}  // namespace pf

using namespace pf;

extern "C" {

int pf_kernel_m_bf16(void* x, const float* stats, const float* smask, const float* pmask,
                     const float* pair_count, const float* bw, const float* bm, const float* rw,
                     const float* rm, const float* cw, const float* cm, float* rowsum,
                     float* partial, int B, int P, int L, int S_, float eps, int gelu,
                     int passes, void* stream) {
  return with_variant(gelu, passes, STORE_BF16, [&](auto g, auto np, auto) {
    constexpr int G = std::decay_t<decltype(g)>::value, NP = std::decay_t<decltype(np)>::value;
    return launch(kernel_m<G, NP>, S_, B, stream, static_cast<bf16*>(x), stats, smask, pmask,
                  pair_count, bw, bm, rw, rm, cw, cm, rowsum, partial, P, L, S_, eps);
  });
}

}  // extern "C"
