// Pipelined Phyloformer axial-block kernels for Hopper (sm_90a), fp32 SIMT.
//
// Hand-written CUDA counterparts of the Pallas TPU kernels of
// phyloformer_tpu/ops/pallas/pipeline.py and of the resident kernel A of
// phyloformer_tpu/ops/pallas/axial_block.py:
//
//   pf_kernel_p0      <- _kernel_p0      (pipeline.py:100): pair gather + block-0 kernel A
//   pf_kernel_a_only  <- _kernel_a_only  (pipeline.py:145): kernel A on a gathered pair tensor
//   pf_kernel_a       <- _kernel_a       (axial_block.py:252): the same function, out of place
//   pf_kernel_m       <- _kernel_m       (pipeline.py:176): kernel B of block i + kernel A of i+1
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
// products (~57 kFLOP), kernel B 2 d x d + 2 d x 4d (~82 kFLOP), M both
// (~139 kFLOP), while M moves ~1 KB of activations per pair-site: fp32
// arithmetic, not HBM, is the bound (the card's fp32 SIMT peak).  The stats
// reduction is the exception: it reads each (B, S, L, 3d) partial once, up to
// 209 MB, for one add per 4 bytes, so device memory bounds it.  It keeps
// enough 16-byte loads in flight to reach that bound: 128-column tiles, the
// slots split over the warps of a block, four accumulators a thread
// (slot_reduce.cu).
//
// Design.
// - One block of 256 threads owns a contiguous range of pairs of one batch
//   element and walks each pair row in tiles of 32 sites held in shared
//   memory.  In the d-wide products thread (c, g) computes output column c
//   for 8 sites (g, g+4, ...): a warp shares one site, so activation reads
//   are shared-memory broadcasts (float4 along k) and weight reads are one
//   coalesced 128-byte line per k, served from L1/L2 (the ~272 KB of weights
//   of kernel M exceed a block's shared memory, so they stay in the cache).
// - Row attention needs sums over the whole site axis before any output.
//   Pass 1 walks a pair's row and accumulates Σq, Σk, Σk·v in registers
//   (the one-pass ctx = Σk·v / Σk, equal to Σ(k/Σk)·v up to rounding); the
//   pair's raw sums go to a small scratch buffer, and pass 2 finalizes them
//   with the guards.  Pass 2 walks the row again and writes x1.  In kernel M
//   the first pass runs kernel B and writes x3 in place over x1, so the
//   second pass reads x3 back (the TPU kept x3 in VMEM; here a row of up to
//   1024 sites does not fit shared memory, and the re-read is cheap next to
//   the arithmetic).  The row is walked in tiles, so no kernel here has a
//   site cap; the engine sends buckets above 1024 sites to A1/A2/B all the
//   same, as the JAX engine does.
// - Column stats are sums over pairs, which CUDA blocks cannot carry across
//   one another.  Pass 2 runs tiles outermost and the block's pairs
//   innermost, so each thread sums its sites' stats over the block's pairs
//   in registers and writes one (L, 3d) partial per block.  pf_reduce_slots
//   then sums the partials in an order fixed by the shapes and the SM count
//   (reduce.reduce_plan): no float atomics, so two runs give the same bits,
//   equal to reduce.reduce_slots_ordered's.  The wrapper of pf_kernel_a caps
//   the block count so that the partials stay under a fixed budget
//   (ops/kernels/fused.py).
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
// [Σq | Σk | Σk·v].  Exact GELU uses erff, φ(x) = x > 0 ? x + 1 : exp(x),
// softplus = max(x,0) + log1p(exp(-|x|)).

#include "axial_bodies.cuh"

namespace pf {

// ---- kernel A: row attention + column stats.  GATHER: the pair rows are
// emb[i] + emb[j] (_kernel_p0); else read from x (_kernel_a_only with
// x_out == x, x1 in place; axial_block.py _kernel_a with x_out != x). ----
template <bool GATHER>
__global__ void __launch_bounds__(NT) kernel_a(const float* x, const int* __restrict__ ii,
                                               const int* __restrict__ jj, float* x_out,
                                               const float* __restrict__ smask,
                                               const float* __restrict__ pmask,
                                               const float* __restrict__ rw,
                                               const float* __restrict__ cw, float* rowsum,
                                               float* partial, int n, int P, int L, int S_,
                                               float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  set_site_count(smask_b, L, S);
  const float* emb_b = GATHER ? x + (size_t)b * n * L * D : nullptr;
  const float* x_b = GATHER ? nullptr : x + (size_t)b * P * L * D;
  float* rowsum_b = rowsum + (size_t)b * P * 3 * D;

  for (int p = p0; p < p1; ++p) {
    if (GATHER) {
      row_pass1(S, nullptr, emb_b + (size_t)ii[p] * L * D, emb_b + (size_t)jj[p] * L * D, rw,
                smask_b, L, eps, rowsum_b + (size_t)p * 3 * D);
    } else {
      row_pass1(S, x_b + (size_t)p * L * D, nullptr, nullptr, rw, smask_b, L, eps,
                rowsum_b + (size_t)p * 3 * D);
    }
  }
  pass2(S, x_b, emb_b, ii, jj, x_out + (size_t)b * P * L * D, smask_b, pmask + (size_t)b * P,
        rw, cw, rowsum_b, partial + ((size_t)b * S_ + blockIdx.x) * L * 3 * D, p0, p1,
        0, n_tiles_of(L), L, eps);
}

// ---- kernel M: kernel B of block i (x3 written in place over x1), then
// kernel A of block i+1 on x3 ----
template <int GELU>
__global__ void __launch_bounds__(NT) kernel_m(float* x, const float* __restrict__ stats,
                                               const float* __restrict__ smask,
                                               const float* __restrict__ pmask,
                                               const float* __restrict__ pair_count,
                                               const float* __restrict__ bw,
                                               const float* __restrict__ rw,
                                               const float* __restrict__ cw, float* rowsum,
                                               float* partial, int P, int L, int S_,
                                               float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  set_site_count(smask_b, L, S);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  float* x_b = x + (size_t)b * P * L * D;
  float* rowsum_b = rowsum + (size_t)b * P * 3 * D;

  for (int p = p0; p < p1; ++p) {
    float rq = 0.f, rk = 0.f, rkv = 0.f;
    for (int l0 = 0; l0 < L; l0 += TS) {
      const int nv = min(TS, L - l0);
      float* row = x_b + ((size_t)p * L + l0) * D;
      load_tile(S.xs, row, nullptr, nv);
      __syncthreads();
      body_b<GELU>(S, bw, stats_b, l0, nv, n_pairs, eps, row);
      row_sums(S, rw, smask_b, l0, nv, eps, rq, rk, rkv);
      __syncthreads();
    }
    store_row_sums(S, rq, rk, rkv, rowsum_b + (size_t)p * 3 * D);
  }
  pass2(S, x_b, nullptr, nullptr, nullptr, x_b, smask_b, pmask + (size_t)b * P, rw, cw,
        rowsum_b, partial + ((size_t)b * S_ + blockIdx.x) * L * 3 * D, p0, p1, 0,
        n_tiles_of(L), L, eps);
}

// ---- kernel Z: last kernel B + head (d -> 1) + softplus + masked site mean ----
template <int GELU>
__global__ void __launch_bounds__(NT) kernel_z(const float* x, const float* __restrict__ stats,
                                               const float* __restrict__ smask,
                                               const float* __restrict__ pair_count,
                                               const float* __restrict__ bw,
                                               const float* __restrict__ hw, float* out,
                                               int P, int L, int S_, float eps) {
  extern __shared__ float4 smem_raw[];
  Smem& S = *reinterpret_cast<Smem*>(smem_raw);
  const int b = blockIdx.y, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int p0, p1;
  split_range(blockIdx.x, P, S_, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  const float count = fmaxf(block_sum(smask_b, L, S), 1.f);
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const float* x_b = x + (size_t)b * P * L * D;
  const float h0 = hw[H_W + lane], h1 = hw[H_W + lane + 32], hb = hw[H_B];

  for (int p = p0; p < p1; ++p) {
    float sum = 0.f;
    for (int l0 = 0; l0 < L; l0 += TS) {
      const int nv = min(TS, L - l0);
      load_tile(S.xs, x_b + ((size_t)p * L + l0) * D, nullptr, nv);
      __syncthreads();
      body_b<GELU>(S, bw, stats_b, l0, nv, n_pairs, eps, nullptr);
      for (int s = warp; s < nv; s += NWARP) {
        const float h = warp_sum(S.xs[s * D + lane] * h0 + S.xs[s * D + lane + 32] * h1) + hb;
        sum += softplus(h) * smask_b[l0 + s];
      }
      __syncthreads();
    }
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

}  // namespace pf

using namespace pf;

extern "C" {

// Packed weight sizes, for the wrapper to check its layout against.
int pf_weight_sizes(int* out) {
  out[0] = R_SIZE;
  out[1] = C_SIZE;
  out[2] = B_SIZE;
  out[3] = H_SIZE;
  return 0;
}

int pf_kernel_p0(const float* emb, const int* ii, const int* jj, float* x1,
                 const float* smask, const float* pmask, const float* rw, const float* cw,
                 float* rowsum, float* partial, int B, int n, int P, int L, int S_, float eps,
                 void* stream) {
  cudaError_t e = allow_smem(kernel_a<true>);
  if (e != cudaSuccess) return (int)e;
  kernel_a<true><<<dim3(S_, B), NT, sizeof(Smem), (cudaStream_t)stream>>>(
      emb, ii, jj, x1, smask, pmask, rw, cw, rowsum, partial, n, P, L, S_, eps);
  return (int)cudaGetLastError();
}

int pf_kernel_a_only(float* x, const float* smask, const float* pmask, const float* rw,
                     const float* cw, float* rowsum, float* partial, int B, int P, int L,
                     int S_, float eps, void* stream) {
  cudaError_t e = allow_smem(kernel_a<false>);
  if (e != cudaSuccess) return (int)e;
  kernel_a<false><<<dim3(S_, B), NT, sizeof(Smem), (cudaStream_t)stream>>>(
      x, nullptr, nullptr, x, smask, pmask, rw, cw, rowsum, partial, 0, P, L, S_, eps);
  return (int)cudaGetLastError();
}

int pf_kernel_a(const float* x, float* x1, const float* smask, const float* pmask,
                const float* rw, const float* cw, float* rowsum, float* partial, int B, int P,
                int L, int S_, float eps, void* stream) {
  cudaError_t e = allow_smem(kernel_a<false>);
  if (e != cudaSuccess) return (int)e;
  kernel_a<false><<<dim3(S_, B), NT, sizeof(Smem), (cudaStream_t)stream>>>(
      x, nullptr, nullptr, x1, smask, pmask, rw, cw, rowsum, partial, 0, P, L, S_, eps);
  return (int)cudaGetLastError();
}

int pf_kernel_m(float* x, const float* stats, const float* smask, const float* pmask,
                const float* pair_count, const float* bw, const float* rw, const float* cw,
                float* rowsum, float* partial, int B, int P, int L, int S_, float eps,
                int gelu, void* stream) {
  cudaError_t e = gelu == 0 ? allow_smem(kernel_m<0>) : allow_smem(kernel_m<1>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S_, B);
  if (gelu == 0) {
    kernel_m<0><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pmask, pair_count, bw, rw, cw, rowsum, partial, P, L, S_, eps);
  } else {
    kernel_m<1><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pmask, pair_count, bw, rw, cw, rowsum, partial, P, L, S_, eps);
  }
  return (int)cudaGetLastError();
}

int pf_kernel_z(const float* x, const float* stats, const float* smask,
                const float* pair_count, const float* bw, const float* hw, float* out, int B,
                int P, int L, int S_, float eps, int gelu, void* stream) {
  cudaError_t e = gelu == 0 ? allow_smem(kernel_z<0>) : allow_smem(kernel_z<1>);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(S_, B);
  if (gelu == 0) {
    kernel_z<0><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pair_count, bw, hw, out, P, L, S_, eps);
  } else {
    kernel_z<1><<<grid, NT, sizeof(Smem), (cudaStream_t)stream>>>(
        x, stats, smask, pair_count, bw, hw, out, P, L, S_, eps);
  }
  return (int)cudaGetLastError();
}

const char* pf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
