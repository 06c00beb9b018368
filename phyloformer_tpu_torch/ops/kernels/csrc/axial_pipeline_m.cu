// Kernel M of the pipelined forward for Hopper (sm_90a), the counterpart of
// _kernel_m (phyloformer_tpu/ops/pallas/pipeline.py:176): kernel B of block
// i, then kernel A of block i+1, x1 in place.  Its design, bounds and
// variants are described in the note of axial_pipeline.cu; it lives in a
// source of its own so that its sixteen variants build beside the other
// kernels (one nvcc per source, in parallel).

#include "axial_bodies.cuh"

namespace pf {

// ---- kernel M: kernel B of block i, then kernel A of block i+1 on x3.  At
// fp32 storage x3 is written in place over x1 between the passes; at bf16
// storage pass 2 runs kernel B again on the stored x1 (x3 never rounded) ----
template <int GELU, int NP, typename TX>
__global__ void __launch_bounds__(NT, 2) kernel_m(
    TX* x, const float* __restrict__ stats, const float* __restrict__ smask,
    const float* __restrict__ pmask, const float* __restrict__ pair_count,
    const float* __restrict__ bw, const float* __restrict__ bm, const float* __restrict__ rw,
    const float* __restrict__ rm, const float* __restrict__ cw, const float* __restrict__ cm,
    float* rowsum, float* partial, int P, int L, int S_, float eps) {
  constexpr bool X3_IN_PLACE = std::is_same<TX, float>::value;
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  set_site_count(smask_b, L, S);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  TX* x_b = x + (size_t)b * P * L * D;
  float* rowsum_b = rowsum + (size_t)b * P * 3 * D;

  const int nt = n_ftiles_of(L), items = (p1 - p0) * nt;
  float rq[RC], rk[RC], rkv[RC];
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
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < RC; ++c) rq[c] = rk[c] = rkv[c] = 0.f;
    }
    float* x3_dst = nullptr;
    if constexpr (X3_IN_PLACE) x3_dst = x_b + ((size_t)p * L + l0) * D;
    body_b<GELU, NP>(S, bw, bm, stats_b, l0, nv, n_pairs, eps, x3_dst);
    row_sums<NP>(S, rw, rm, smask_b, l0, nv, eps, rq, rk, rkv);
    if (t == nt - 1) store_row_sums(S, rq, rk, rkv, rowsum_b + (size_t)p * 3 * D);
  }
  float* partial_bs = partial + ((size_t)b * S_ + blockIdx.x) * L * 3 * D;
  if constexpr (X3_IN_PLACE) {
    pass2<NP>(S, x_b, nullptr, nullptr, nullptr, x_b, smask_b, pmask + (size_t)b * P, rw, rm, cw,
              cm, rowsum_b, partial_bs, p0, p1, 0, nt, L, eps);
  } else {
    pass2<NP, TX, TX, GELU>(S, x_b, nullptr, nullptr, nullptr, x_b, smask_b,
                            pmask + (size_t)b * P, rw, rm, cw, cm, rowsum_b, partial_bs, p0, p1,
                            0, nt, L, eps, BArgs{bw, bm, stats_b, n_pairs});
  }
}

}  // namespace pf

using namespace pf;

extern "C" {

int pf_kernel_m(void* x, const float* stats, const float* smask, const float* pmask,
                const float* pair_count, const float* bw, const float* bm, const float* rw,
                const float* rm, const float* cw, const float* cm, float* rowsum,
                float* partial, int B, int P, int L, int S_, float eps, int gelu, int passes,
                int storage, void* stream) {
  return with_variant(gelu, passes, storage, [&](auto g, auto np, auto tag) {
    using TX = typename std::decay_t<decltype(tag)>::type;
    constexpr int G = std::decay_t<decltype(g)>::value, NP = std::decay_t<decltype(np)>::value;
    return launch(kernel_m<G, NP, TX>, S_, B, stream,
                  static_cast<TX*>(x), stats, smask, pmask, pair_count, bw, bm, rw, rm, cw, cm,
                  rowsum, partial, P, L, S_, eps);
  });
}

}  // extern "C"
