// Kernel E1 of the fused backward of one axial block for Hopper (sm_90a):
// each pair's raw row sums in one streaming pass, bound by its bytes.
//
// Hand-written CUDA counterpart of the Pallas TPU kernel
//
//   pf_kernel_e1 <- _kernel_e1 (phyloformer_tpu/ops/pallas/axial_block_bwd.py:492):
//                   above 1024 sites, each pair's raw row sums
//                   [Σq_e | Σk_e | Σk_e·v | Σd_attn·q_e] (B, P, 4d)
//
// which kernel E2 (axial_bwd_tc.cu) finalizes into the row backward.  The
// plain PyTorch version, in the TPU kernel's association, is
// kernel_e1_plain in ops/kernels/axial_block_bwd.py; kernel_e1_factored
// there is this kernel's association, written eagerly.
//
// Another association than the TPU kernel's.  q_e and k_e are per-head
// values broadcast over each head's HD lanes (q_e[l, c] = qH[l, c / HD]),
// so the four sums over the sites l factor through two d x H matrices a
// pair:
//   Σ_l d_attn[l,c] q_e[l,c] = Σ_j Wo^T[j,c] M[j, c/HD],  M = Σ_l g1[l,:]^T qH[l,:]
//   Σ_l k_e[l,c] v[l,c]      = Σ_j Wv[j,c] N[j, c/HD] + bv[c] Σ_l kH[l, c/HD],
//                                                    N = Σ_l h[l,:]^T kH[l,:]
//   Σ_l q_e, Σ_l k_e         = the per-head sums Σ_l qH, Σ_l kH, expanded
// (h the row LayerNorm of x, qH, kH = φ(h [Wq | Wk] + [bq | bk]) times the
// site mask).  The TPU kernel forms v = h Wv and d_attn = g1 Wo^T at every
// site and sums the products; here the sums over the sites come first and
// the d x d contractions once a pair.  The same function in exact algebra,
// rounded otherwise.
//
// What bounds it on the card.  A pair-site is 512 B of activations (x and
// g1) and, in this association, about 2.6 kFLOP (LayerNorm, the d x 2H
// product and the rank-one updates of M and N): 5 FLOP a byte, far below
// the card's ridge, so HBM bounds it (0.576 ms at 2 x 1225 x 1536).  The
// products stay exact fp32 FFMA on the SIMT cores; the tensor cores would
// buy nothing.  (The SIMT kernel this replaces ran v, d_attn and q, k on
// the head-expanded d x d weights at every site: 32.8 kFLOP a pair-site.)
//
// Design.
// - Work: the (pair row, 16-site tile) list, flattened, split into
//   contiguous ranges of tpw tiles, one a warp, over the card's
//   BLOCKS_PER_SM x E1_WARPS warps an SM (the wrapper's e1_plan): B = 1
//   and a few pairs fill the card, and no warp has more than one tile above
//   the mean.  A row that spans warps leaves one partial a warp (M, N,
//   ΣqH, ΣkH: E1_PART floats); kernel_e1_fin adds a row's partials in warp
//   order, then contracts M and N with Wo^T and Wv (read once a block into
//   shared memory).  No atomics: two runs give the same bits.
// - Streaming: each warp copies its own tiles of x and g1 with cp.async
//   into a ring of E1_RING tiles (two in flight while one computes: 16 KB a
//   warp, 128 KB an SM), zero-filled past a row's end.  No block barrier: a
//   warp waits only for its own copies.
// - Lane 8s + g takes site s of the four a warp holds at once and channels
//   4g .. 4g+3, 32+4g .. 32+4g+3 (conflict-free float4 reads).  LayerNorm
//   by butterfly sums over the site's 8 lanes; the lane's share of
//   [zq | zk] from its channels' rows of [Wq | Wk], held in registers, then
//   summed over the 8 lanes by a reduce-scatter that leaves output g in
//   lane g; φ and the site mask there; the eight values gathered back to
//   every lane, which adds its channels' rank-one updates to M and N (64
//   accumulators in registers, summed over the four site slots at the end
//   of a row segment).

#include "axial_bwd.cuh"

namespace pf {

static_assert(D == 64 && 2 * H == 8, "a site's 8 lanes own 8 channels and one of [zq | zk] each");

constexpr int E1_TILE = TS * D;                 // floats of a tile of x (or of g1)
constexpr int E1_SLOT = 2 * E1_TILE;            // a ring slot: x, then g1
constexpr int E1_COPIES = E1_TILE / 4 / 32;     // 16-byte chunks of a tile a lane copies
constexpr int E1_FIN_THREADS = 4 * D;           // kernel_e1_fin: one thread an output column

// The lane's copies of rows [0, nv) of a tile of x and of g1 (row-major,
// stride D) into a ring slot; rows [nv, TS) are zero-filled.  The walk
// commits one group a tile, empty past the warp's last, so that its wait
// counts stay fixed.
__device__ __forceinline__ void e1_issue(float* slot, const float* x, const float* g, int nv,
                                         int lane) {
#pragma unroll
  for (int k = 0; k < E1_COPIES; ++k) {
    const int e = lane + 32 * k, r = e / (D / 4), c = 4 * (e % (D / 4));
    const bool in = r < nv;
    cp_async16_zfill(slot + r * D + c, in ? x + r * D + c : x, in ? 16 : 0);
    cp_async16_zfill(slot + E1_TILE + r * D + c, in ? g + r * D + c : g, in ? 16 : 0);
  }
}

// The sum over a site's 8 lanes (the same bits in each).
__device__ __forceinline__ float site_sum(float v) {
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Channel of the lane's value i (g = lane % 8).
__device__ __forceinline__ int e1_channel(int g, int i) { return (i < 4 ? 0 : 32 - 4) + 4 * g + i; }

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}

// ---- kernel E1: per warp, per row segment, the partial [M | N | ΣqH | ΣkH] ----
__global__ void __launch_bounds__(E1_WARPS * 32, 2) kernel_e1(
    const float* __restrict__ x, const float* __restrict__ g1, const float* __restrict__ smask,
    const float* __restrict__ w, float* __restrict__ part, int P, int L, int n_tiles, int tpw,
    int K, float eps) {
  extern __shared__ float4 smem_raw[];
  SmemE1& S = *reinterpret_cast<SmemE1*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gw = blockIdx.x * E1_WARPS + warp;
  const int t0 = gw * tpw;
  if (t0 >= n_tiles) return;
  const int t1 = min(t0 + tpw, n_tiles);
  const int tr = (L + TS - 1) / TS;  // tiles a row
  const int sl = lane >> 3, g = lane & 7;
  float* ring = S.tile + warp * E1_RING * E1_SLOT;

  auto issue = [&](int t) {
    const int row = t / tr, l0 = (t - row * tr) * TS;
    const size_t off = ((size_t)row * L + l0) * D;
    e1_issue(ring + ((t - t0) % E1_RING) * E1_SLOT, x + off, g1 + off, min(TS, L - l0), lane);
  };
#pragma unroll
  for (int i = 0; i < E1_RING - 1; ++i) {
    if (t0 + i < t1) issue(t0 + i);
    cp_commit();
  }

  // the lane's rows of [Wq | Wk] and its LayerNorm scale and bias
  float wz[8][8], sc[8], bi[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int j = e1_channel(g, i);
    sc[i] = __ldg(w + AG_LNS + j);
    bi[i] = __ldg(w + AG_LNB + j);
#pragma unroll
    for (int o = 0; o < H; ++o) {
      wz[i][o] = __ldg(w + AG_WQ + j * H + o);
      wz[i][H + o] = __ldg(w + AG_WK + j * H + o);
    }
  }
  const float bz = __ldg(w + (g < H ? AG_BQ + g : AG_BK + g - H));
  const bool b2 = g & 4, b1 = g & 2, b0 = g & 1;

  float am[8][H], an[8][H], csum = 0.f;  // M, N (the lane's channels) and Σ of output g
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int o = 0; o < H; ++o) am[i][o] = an[i][o] = 0.f;

  for (int t = t0; t < t1; ++t) {
    asm volatile("cp.async.wait_group %0;" ::"n"(E1_RING - 2) : "memory");
    __syncwarp();  // every lane's copies of tile t landed; tile t - 1's slot is free
    if (t + E1_RING - 1 < t1) issue(t + E1_RING - 1);
    cp_commit();
    const float* xs = ring + ((t - t0) % E1_RING) * E1_SLOT;
    const float* gs = xs + E1_TILE;
    const int row = t / tr, l0 = (t - row * tr) * TS;
    const float* sm = smask + (size_t)(row / P) * L;
    float tsum = 0.f;
#pragma unroll 2
    for (int s = sl; s < TS; s += 4) {
      float a[8], gv[8];
      ld4(xs + s * D + 4 * g, a);
      ld4(xs + s * D + 32 + 4 * g, a + 4);
      ld4(gs + s * D + 4 * g, gv);
      ld4(gs + s * D + 32 + 4 * g, gv + 4);
      const float m = l0 + s < L ? __ldg(sm + l0 + s) : 0.f;
      // LayerNorm of the site's row
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) sum += a[i];
      const float mu = site_sum(sum) * (1.f / D);
      float sq = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i] -= mu;
        sq += a[i] * a[i];
      }
      const float r = 1.f / sqrtf(site_sum(sq) * (1.f / D) + eps);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = a[i] * r * sc[i] + bi[i];
      // the lane's share of [zq | zk], then the sum over the 8 lanes:
      // reduce-scatter by halves (partner lanes 4, 2, 1), output g in lane g
      float z[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) {
        z[o] = 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i) z[o] = fmaf(a[i], wz[i][o], z[o]);
      }
      float y[4], u[2];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        y[k] = (b2 ? z[k + 4] : z[k]) + __shfl_xor_sync(0xffffffffu, b2 ? z[k] : z[k + 4], 4);
#pragma unroll
      for (int k = 0; k < 2; ++k)
        u[k] = (b1 ? y[k + 2] : y[k]) + __shfl_xor_sync(0xffffffffu, b1 ? y[k] : y[k + 2], 2);
      const float zg = (b0 ? u[1] : u[0]) + __shfl_xor_sync(0xffffffffu, b0 ? u[0] : u[1], 1);
      const float qk = phi(zg + bz) * m;  // qH (g < H) or kH of the site
      tsum += qk;
      float c[8];
#pragma unroll
      for (int o = 0; o < 8; ++o) c[o] = __shfl_sync(0xffffffffu, qk, (lane & 24) | o);
      // M += g1^T qH, N += h^T kH on the lane's channels
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int o = 0; o < H; ++o) {
          am[i][o] = fmaf(gv[i], c[o], am[i][o]);
          an[i][o] = fmaf(a[i], c[H + o], an[i][o]);
        }
    }
    csum += tsum;
    if (t < t1 - 1 && l0 + TS < L) continue;
    // end of the warp's segment of this row: the four site slots' sums
    // (lanes g, g + 8, g + 16, g + 24; the same bits in each), then lanes
    // 0-7 write the partial
#pragma unroll
    for (int o = 8; o < 32; o <<= 1) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < H; ++h) {
          am[i][h] += __shfl_xor_sync(0xffffffffu, am[i][h], o);
          an[i][h] += __shfl_xor_sync(0xffffffffu, an[i][h], o);
        }
      csum += __shfl_xor_sync(0xffffffffu, csum, o);
    }
    if (sl == 0) {
      float* dst = part + ((size_t)row * K + (gw - row * tr / tpw)) * E1_PART;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int j = e1_channel(g, i);
        *reinterpret_cast<float4*>(dst + j * H) =
            make_float4(am[i][0], am[i][1], am[i][2], am[i][3]);
        *reinterpret_cast<float4*>(dst + D * H + j * H) =
            make_float4(an[i][0], an[i][1], an[i][2], an[i][3]);
      }
      dst[2 * D * H + g] = csum;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int o = 0; o < H; ++o) am[i][o] = an[i][o] = 0.f;
    csum = 0.f;
  }
}

// ---- the finalize: per row, the partials in warp order, then the
// contractions with Wv and Wo^T into [Σq_e | Σk_e | Σk_e·v | Σd_attn·q_e] ----
__global__ void __launch_bounds__(E1_FIN_THREADS) kernel_e1_fin(
    const float* __restrict__ part, const float* __restrict__ w, float* __restrict__ rowsums,
    int rows, int tr, int tpw, int K) {
  __shared__ float4 wv4[D * D / 4], wot4[D * D / 4];
  __shared__ float ps[E1_PART];
  for (int e = threadIdx.x; e < D * D / 4; e += E1_FIN_THREADS) {
    wv4[e] = __ldg(reinterpret_cast<const float4*>(w + AG_WV) + e);
    wot4[e] = __ldg(reinterpret_cast<const float4*>(w + AG_WOT) + e);
  }
  const float* wv = reinterpret_cast<const float*>(wv4);
  const float* wot = reinterpret_cast<const float*>(wot4);
  const int c = threadIdx.x & (D - 1), q = threadIdx.x / D, hc = c / HD;
  const float bv = __ldg(w + AG_BV + c);
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int first = row * tr / tpw, nseg = ((row + 1) * tr - 1) / tpw - first + 1;
    const float* src = part + (size_t)row * K * E1_PART;
    __syncthreads();  // the weights are in; the previous row's reads of ps are done
    for (int e = threadIdx.x; e < E1_PART; e += E1_FIN_THREADS) {
      float s = 0.f;
      for (int k = 0; k < nseg; ++k) s += src[k * E1_PART + e];
      ps[e] = s;
    }
    __syncthreads();
    const float* M = ps;
    const float* N = ps + D * H;
    const float* sums = ps + 2 * D * H;  // [ΣqH | ΣkH]
    float out;
    if (q < 2) {
      out = sums[q * H + hc];
    } else if (q == 2) {
      out = 0.f;
#pragma unroll 8
      for (int j = 0; j < D; ++j) out = fmaf(wv[j * D + c], N[j * H + hc], out);
      out = fmaf(bv, sums[H + hc], out);
    } else {
      out = 0.f;
#pragma unroll 8
      for (int j = 0; j < D; ++j) out = fmaf(wot[j * D + c], M[j * H + hc], out);
    }
    rowsums[(size_t)row * 4 * D + q * D + c] = out;
  }
}

}  // namespace pf

using namespace pf;

extern "C" {

// E1's flat group, one pair's row sums, the tile, the warps of a block and
// a partial, then the shared memory of a block, for the wrapper to check
// its layout.
int pf_bwd_sizes(int* out) {
  out[0] = AG_SIZE;
  out[1] = 4 * D;  // floats of one pair's row sums (E1 -> E2)
  out[2] = TS;
  out[3] = E1_WARPS;
  out[4] = E1_PART;
  out[5] = (int)sizeof(SmemE1);
  return 0;
}

// tpw: tiles a warp; K: partials a row (the most warps a row spans);
// fin_blocks: blocks of the finalize.
int pf_kernel_e1(const float* x, const float* g1, const float* smask, const float* w,
                 float* part, float* rowsums, int B, int P, int L, int tpw, int K,
                 int fin_blocks, float eps, void* stream) {
  const int tr = (L + TS - 1) / TS, rows = B * P, n_tiles = rows * tr;
  const int warps = (n_tiles + tpw - 1) / tpw, blocks = (warps + E1_WARPS - 1) / E1_WARPS;
  cudaError_t e = cudaFuncSetAttribute(kernel_e1, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)sizeof(SmemE1));
  if (e != cudaSuccess) return (int)e;
  kernel_e1<<<blocks, E1_WARPS * 32, sizeof(SmemE1), (cudaStream_t)stream>>>(
      x, g1, smask, w, part, P, L, n_tiles, tpw, K, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  kernel_e1_fin<<<fin_blocks, E1_FIN_THREADS, 0, (cudaStream_t)stream>>>(part, w, rowsums, rows,
                                                                          tr, tpw, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
