// Kernel E1 of the fused backward of one axial block for Hopper (sm_90a),
// fp32 SIMT.
//
// Hand-written CUDA counterpart of the Pallas TPU kernel
//
//   pf_kernel_e1 <- _kernel_e1 (phyloformer_tpu/ops/pallas/axial_block_bwd.py:492):
//                   above 1024 sites, each pair's raw row sums
//                   [Σq | Σk | Σk·v | Σd_attn·q] (B, P, 4d)
//
// which kernel E2 (axial_bwd_tc.cu) finalizes into the row backward.  The
// other backward kernels, C, D, E and E2, run their products on the tensor
// cores in axial_bwd_tc.cu; their fp32 SIMT form is in the git history.
// The plain PyTorch version is kernel_e1_plain in
// ops/kernels/axial_block_bwd.py.  The device helpers (LayerNorm, the d-wide
// products, tile loads) are those of axial_bodies.cuh.
//
// What bounds it on the card.  Per pair-site E1 does 2 d x d + 2 d x H
// products (~17 kFLOP) on 512 B of activations: fp32 arithmetic, not HBM,
// is the bound.
//
// Design.
// - Blocks of 256 threads own a contiguous range of pairs of one batch
//   element (grid: pair slots x B, as A1) and walk each pair's whole row in
//   32-site tiles held in shared memory.  The d-wide products use the
//   forward's SIMT mapping (thread (c, g): column c of sites g, g+4, ...).
// - Each pair's sums come from one block, in registers, combined over the
//   four site groups in a fixed order: no atomics, and two runs give the
//   same bits.
// - A ragged last tile is zero-filled on load and masked by the site mask.

#include "axial_bwd.cuh"

namespace pf {

struct SmemE1 {
  float xs[TS * D];  // x
  float hs[TS * D];  // row LN output
  float gs[TS * D];  // g1
  float red[4 * NG * D];  // the site groups' sums
};

// The masked sums of column c over the thread's site group of one pair's
// whole row (x_row, g_row: L x D), r = [q, k, k*v, d_attn*q].
__device__ __forceinline__ void row_bwd_sums(SmemE1& S, const float* x_row, const float* g_row,
                                             const float* __restrict__ smask_b,
                                             const float* __restrict__ w, int L, float eps,
                                             float (&r)[4]) {
  const int c = threadIdx.x & (D - 1);
  const float bq = w[AG_BQE + c], bk = w[AG_BKE + c], bv = w[AG_BV + c];
  for (int l0 = 0; l0 < L; l0 += TS) {
    const int nv = min(TS, L - l0);
    load_tile(S.xs, x_row + (size_t)l0 * D, nv);
    load_tile(S.gs, g_row + (size_t)l0 * D, nv);
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

}  // namespace pf

using namespace pf;

extern "C" {

// E1's flat group and one pair's row sums, for the wrapper to check its layout.
int pf_bwd_sizes(int* out) {
  out[0] = AG_SIZE;
  out[1] = 4 * D;  // floats of one pair's row sums (E1 -> E2)
  return 0;
}

int pf_kernel_e1(const float* x, const float* g1, const float* smask, const float* w,
                 float* rowsums, int B, int P, int L, int S_, float eps, void* stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel_e1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(SmemE1));
  if (e != cudaSuccess) return (int)e;
  kernel_e1<<<dim3(S_, B), NT, sizeof(SmemE1), (cudaStream_t)stream>>>(x, g1, smask, w,
                                                                       rowsums, P, L, S_, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
