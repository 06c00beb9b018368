// Fixed-order slot reduction for Hopper (sm_90a), fp32:
//
//   out[g, n] = sum_s partial[g, s, n]   over a contiguous (G, S, N) layout.
//
// pf_reduce_slots is the one kernel behind pipeline.reduce_stats (the
// column-stat partials of P0, A-only, M, A and A2: G = B, N = L * 3d) and
// axial_block_bwd.reduce_partials (A1 and the weight gradients of C, D, E and
// E2).  Pallas accumulates those sums over sequential grid steps
// (pl.when(first) init, then +=; phyloformer_tpu/ops/pallas/pipeline.py:
// 136-142, axial_block_bwd.py:241-274, :340-365, :450-476, :610-639).  CUDA
// blocks run in parallel, so each kernel writes one partial per block
// ("slot") and this sums the slots.
//
// What bounds it: bytes.  Every partial is read once (8 to 209 MB on the
// paths) for one add per 4 bytes, so device memory at 3.35 TB/s is the
// bound, or L2 where the producer has just left a partial of at most 50 MB
// there.  Reaching it takes enough bytes in flight: about 3.35 TB/s x ~0.7 us
// = 2.3 MB over the card, ~18 KB per SM.
//
// Design.
// - The launch plan, column tiles x G blocks of W warps, is chosen on the
//   host by reduce_plan (ops/kernels/reduce.py) from (G, S, N) and the SM
//   count alone.  The order of every sum follows from the plan, so two runs
//   give the same bits; reduce_slots_ordered there adds in exactly this order
//   with torch ops, and since a sum of adds has no multiply to contract into
//   an FMA, the kernel equals it bit for bit.
// - A block owns a tile of 128 columns (32 lanes x 4) of one g; its W warps
//   split the slots into contiguous runs.  Each thread loads 16 bytes per
//   slot and keeps 4 independent accumulators (slot r of its run goes to
//   accumulator r % 4), so 4 loads per thread, 2 KB per warp, are in flight.
//   The accumulators are added as ((a0 + a1) + a2) + a3, and the warps' sums
//   in shared memory in warp order.
// - The slots are not split over blocks: at the narrowest partials of the
//   paths (D's and E's weight gradients, 38 and 71 tiles on 132 SMs) a split
//   over a cluster of blocks measured no faster on the H100, since those
//   partials come from L2 (PERF.md).
// - A partial above 32 MiB is read with streaming loads (evict first), a
//   smaller one, which its producer has just left in the 50 MB L2, through
//   the read-only path; the plan says which.  The hint does not touch the
//   order.
// - N not a multiple of 4, or a partial or output not 16-byte aligned: the
//   same kernel takes a scalar path, lane l loading columns l, l + 32, l + 64
//   and l + 96 of the tile, in the same order per column.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;     // columns per block: 32 lanes x 4 (reduce.TILE_COLS)
constexpr int ACC = 4;        // independent accumulators per thread (reduce.ACCS)
constexpr int MAX_WARPS = 8;  // warps per block at most (reduce.MAX_WARPS)

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// One slot row's 4 columns of the lane: one float4 at c (VEC: c = c0 + 4 lane,
// c < N checked by the caller), else c, c + 32, c + 64, c + 96 (c = c0 + lane),
// columns at or past N reading 0.  STREAM: streaming loads (evict first);
// else through the read-only path.
template <bool VEC, bool STREAM>
__device__ __forceinline__ float4 load_slot(const float* row, int c, int N) {
  if (VEC) {
    const float4* p = reinterpret_cast<const float4*>(row + c);
    return STREAM ? __ldcs(p) : __ldg(p);
  }
  float v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cj = c + 32 * j;
    v[j] = cj < N ? (STREAM ? __ldcs(row + cj) : __ldg(row + cj)) : 0.f;
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

template <bool VEC>
__device__ __forceinline__ void store_cols(float* row, int c, int N, float4 v) {
  if (VEC) {
    *reinterpret_cast<float4*>(row + c) = v;
    return;
  }
  const float u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (c + 32 * j < N) row[c + 32 * j] = u[j];
  }
}

// One block: column tile blockIdx.x, g = blockIdx.y.  Warp w sums slots
// [w S / W, (w + 1) S / W).
template <bool VEC, bool STREAM>
__device__ __forceinline__ void reduce_tile(const float* __restrict__ partial,
                                            float* __restrict__ out, int S, int N,
                                            float4 (&wsum)[MAX_WARPS][32]) {
  const int g = blockIdx.y;
  const int W = blockDim.x >> 5, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * TILE + (VEC ? 4 * lane : lane);
  const bool live = c < N;  // the lane has columns in this tile
  const int r0 = warp * S / W, r1 = (warp + 1) * S / W;
  const float* p = partial + (size_t)g * S * N;

  // Slot r0 + r goes to accumulator r % ACC.
  float4 acc[ACC];
#pragma unroll
  for (int j = 0; j < ACC; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live) {
    int s = r0;
    for (; s + ACC <= r1; s += ACC) {
      float4 x[ACC];
#pragma unroll
      for (int j = 0; j < ACC; ++j) x[j] = load_slot<VEC, STREAM>(p + (size_t)(s + j) * N, c, N);
#pragma unroll
      for (int j = 0; j < ACC; ++j) acc[j] = add4(acc[j], x[j]);
    }
#pragma unroll
    for (int j = 0; j < ACC; ++j) {
      if (s + j < r1) acc[j] = add4(acc[j], load_slot<VEC, STREAM>(p + (size_t)(s + j) * N, c, N));
    }
  }
  wsum[warp][lane] = add4(add4(add4(acc[0], acc[1]), acc[2]), acc[3]);
  __syncthreads();
  if (warp == 0 && live) {
    float4 t = wsum[0][lane];
    for (int w = 1; w < W; ++w) t = add4(t, wsum[w][lane]);
    store_cols<VEC>(out + (size_t)g * N, c, N, t);
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
    reduce_slots(const float* __restrict__ partial, float* __restrict__ out, int S, int N,
                 bool vec, bool stream) {
  __shared__ float4 wsum[MAX_WARPS][32];
  if (vec && stream) {
    reduce_tile<true, true>(partial, out, S, N, wsum);
  } else if (vec) {
    reduce_tile<true, false>(partial, out, S, N, wsum);
  } else if (stream) {
    reduce_tile<false, true>(partial, out, S, N, wsum);
  } else {
    reduce_tile<false, false>(partial, out, S, N, wsum);
  }
}

}  // namespace

extern "C" {

// out (G, N) = sum over the slots of partial (G, S, N) on the plan of
// reduce.reduce_plan: grid (tiles, G), W warps a block, streaming loads where
// stream_loads.  Returns a cudaError_t.
int pf_reduce_slots(const float* partial, float* out, int G, int S, int N, int W,
                    int stream_loads, void* stream) {
  if (G < 1 || S < 1 || N < 1 || W < 1 || W > MAX_WARPS) return (int)cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && (uintptr_t)partial % 16 == 0 && (uintptr_t)out % 16 == 0;
  const int tiles = (N + TILE - 1) / TILE;
  reduce_slots<<<dim3(tiles, G), 32 * W, 0, (cudaStream_t)stream>>>(partial, out, S, N, vec,
                                                                    stream_loads != 0);
  return (int)cudaGetLastError();
}

}  // extern "C"
