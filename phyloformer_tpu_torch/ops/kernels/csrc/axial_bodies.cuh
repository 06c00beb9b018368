// Device bodies of the Phyloformer axial-block kernels, shared by
// axial_pipeline.cu (P0, A-only, A, M, Z) and axial_fused.cu (A1, A2, B);
// the backward's sources take the scalar helpers (warp_sum, phi, ...).
//
// The forward bodies mirror phyloformer_tpu/ops/pallas/axial_block.py: row
// attention (_body_row_attn, :172), column-stats partial sums
// (_body_col_stats, :204) and kernel B (_body_b, :224).  Each works on one
// tile of FT = 64 sites of one pair row held in shared memory (Smem), and
// runs every product on the tensor cores in split TF32 (mma_rows, three
// passes) or, in the reduced-precision variants, in one TF32 pass; see the
// design note at the top of axial_pipeline.cu.  x1 between the kernels is
// stored fp32 or bf16 (the storage type T of the tile loads and stores).
// Everything here has internal linkage, so each source that includes this
// header gets its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "axial_pipeline.cuh"

namespace pf {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float phi(float x) { return x > 0.f ? x + 1.f : expf(x); }

// φ of the forward kernels: exp through exp2f(x · log2 e), about a third of
// expf's instructions, within ~2 ulp + |x| 2^-24 of it.
__device__ __forceinline__ float phi_f(float x) {
  return x > 0.f ? x + 1.f : exp2f(x * 1.4426950408889634f);
}

// The FFN's activation, by its code (axial_pipeline.cuh): exact (erf), tanh
// approximation, x·sigmoid(1.702 x) with sigmoid = 1 / (1 + expf(-1.702 x))
// (expf, not __expf), relu.
template <int GELU>
__device__ __forceinline__ float gelu(float x) {
  if (GELU == GELU_EXACT) return 0.5f * x * (1.f + erff(x * 0.7071067811865476f));
  if (GELU == GELU_SIGMOID) return x * (1.f / (1.f + expf(-1.702f * x)));
  if (GELU == GELU_RELU) return fmaxf(x, 0.f);
  const float u = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(u));
}

__device__ __forceinline__ float softplus(float x) {
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// [lo, hi) of part `idx` when n items are split into `parts` contiguous parts.
__device__ __forceinline__ void split_range(int idx, int n, int parts, int& lo, int& hi) {
  lo = (int)(((long long)idx * n) / parts);
  hi = (int)(((long long)(idx + 1) * n) / parts);
}

// ============ the forward: split-TF32 products on the tensor cores ============

__device__ __forceinline__ int n_ftiles_of(int L) { return (L + FT - 1) / FT; }

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small to about 2^-22 of |x|, both TF32 values.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// d += a · b on the tensor cores: a 16 x 8 TF32 fragment times an 8 x 8 one,
// accumulated in fp32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The products' output tile is FT x 64; warp w owns rows [WM (w / NGW), +WM)
// and columns [WN (w % NGW), +WN): MI x NI fragments of 16 x 8.  Element
// [mi][ni][2h + e] of a thread's accumulator is row frag_row(mi, h), column
// frag_col(ni) + e.
__device__ __forceinline__ int warp_m() { return (int)(threadIdx.x >> 5) / NGW; }
__device__ __forceinline__ int frag_row(int mi, int h) {
  return WM * warp_m() + 16 * mi + 8 * h + ((threadIdx.x >> 2) & 7);
}
__device__ __forceinline__ int frag_col(int ni) {
  return WN * ((int)(threadIdx.x >> 5) % NGW) + 8 * ni + 2 * (threadIdx.x & 3);
}

constexpr int RC = 2 * NI;       // output columns of a thread
constexpr int CE = 4 * MI * NI;  // output elements of a thread (16)

template <int NW>
__device__ __forceinline__ void zero(float (&acc)[NW][MI][NI][4]) {
#pragma unroll
  for (int w = 0; w < NW; ++w)
#pragma unroll
    for (int i = 0; i < MI * NI * 4; ++i) (&acc[w][0][0][0])[i] = 0.f;
}

// acc[w] += A · W_w for NW packed weights (the mma layout of
// axial_pipeline.cuh, w_nt n-tiles wide), over their k-steps [k0, k0 + KS)
// and the warp's NI n-tiles from n0 + NI (warp % NGW).  A is an (FT x 8 KS)
// tile in shared memory, row stride XS, already split (st_split): its big
// plane at A, its small plane at A + FT XS.  NP = 3, split TF32:
// a_small·b_big + a_big·b_small + a_big·b_big, accumulated in fp32; the
// small·small term (~2^-22 of the product) is left out.  NP = 1, one TF32
// pass: a_big·b_big alone (tf32_rna(a)·tf32_rna(w), accumulated in fp32);
// the small planes are not read, and each B fragment is the float2 of its
// big halves.  Each A fragment is shared by the NW weights and NI n-tiles;
// each B fragment arrives split, one 16-byte load a lane.
template <int KS, int NW, int NP = PASSES_SPLIT>
__device__ __forceinline__ void mma_rows(const float* A, const float* __restrict__ w0,
                                         const float* __restrict__ w1, int w_nt, int k0, int n0,
                                         float (&acc)[NW][MI][NI][4]) {
  static_assert(NP == PASSES_SPLIT || NP == PASSES_ONE, "three TF32 passes or one");
  const float4* W[2] = {reinterpret_cast<const float4*>(w0),
                        reinterpret_cast<const float4*>(w1)};
  const int lane = threadIdx.x & 31;
  const float* a_base = A + (WM * warp_m() + (lane >> 2)) * XS + (lane & 3);
  const int nt = n0 + NI * ((int)(threadIdx.x >> 5) % NGW);
#pragma unroll 2
  for (int j = 0; j < KS; ++j) {
    uint32_t ab[MI][4], as[MI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      const float* a = a_base + 16 * mi * XS + 8 * j;
      const int at[4] = {0, 8 * XS, 4, 8 * XS + 4};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        ab[mi][r] = __float_as_uint(a[at[r]]);
        if constexpr (NP == PASSES_SPLIT) as[mi][r] = __float_as_uint(a[FT * XS + at[r]]);
      }
    }
#pragma unroll
    for (int w = 0; w < NW; ++w) {
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        if constexpr (NP == PASSES_SPLIT) {
          const float4 b = __ldg(W[w] + ((k0 + j) * w_nt + nt + ni) * 32 + lane);
          const uint32_t bb0 = __float_as_uint(b.x), bb1 = __float_as_uint(b.y);
          const uint32_t bs0 = __float_as_uint(b.z), bs1 = __float_as_uint(b.w);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) {
            mma_tf32(acc[w][mi][ni], as[mi], bb0, bb1);
            mma_tf32(acc[w][mi][ni], ab[mi], bs0, bs1);
            mma_tf32(acc[w][mi][ni], ab[mi], bb0, bb1);
          }
        } else {
          const float2 b = __ldg(reinterpret_cast<const float2*>(
              W[w] + ((k0 + j) * w_nt + nt + ni) * 32 + lane));
          const uint32_t bb0 = __float_as_uint(b.x), bb1 = __float_as_uint(b.y);
#pragma unroll
          for (int mi = 0; mi < MI; ++mi) mma_tf32(acc[w][mi][ni], ab[mi], bb0, bb1);
        }
      }
    }
  }
}

__device__ __forceinline__ float2 ld2(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// An operand of the products, split once where it is made: (a, b) at
// element i of the big plane P and of the small plane P + FT XS.  One pass
// (NP = 1) reads the big plane alone, so only it is written.
template <int NP = PASSES_SPLIT>
__device__ __forceinline__ void st_split(float* P, int i, float a, float b) {
  if constexpr (NP == PASSES_ONE) {
    st2(P + i, __uint_as_float(to_tf32(a)), __uint_as_float(to_tf32(b)));
  } else {
    uint32_t ba, sa, bb, sb;
    split_tf32(a, ba, sa);
    split_tf32(b, bb, sb);
    st2(P + i, __uint_as_float(ba), __uint_as_float(bb));
    st2(P + FT * XS + i, __uint_as_float(sa), __uint_as_float(sb));
  }
}

// LayerNorm over the D channels of each of the FT tile rows of X, one warp
// per row, written split (st_split) to the planes Y.
template <int NP>
static __device__ void ln_split(const float* X, float* Y, const float* __restrict__ scale,
                                const float* __restrict__ bias, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float2 sc = ld2(scale + 2 * lane), bi = ld2(bias + 2 * lane);
  for (int s = warp; s < FT; s += NWARP) {
    const float2 x = ld2(X + s * XS + 2 * lane);
    const float mu = warp_sum(x.x + x.y) * (1.f / D);
    const float da = x.x - mu, db = x.y - mu;
    const float var = warp_sum(da * da + db * db) * (1.f / D);
    const float r = 1.f / sqrtf(var + eps);
    st_split<NP>(Y, s * XS + 2 * lane, da * r * sc.x + bi.x, db * r * sc.y + bi.y);
  }
}

// ---- tile staging: the next tile is copied in (cp.async) while this one
// computes.  A tile is stored as T (float, or bf16 for the reduced storage
// of x1) and held as fp32 in S.xs.  Thread t owns the 16-byte chunks
// e = t + k NT of a tile of T (row e / (D / V), columns V (e % (D / V)) .. +V,
// V = 16 / sizeof(T) values a chunk); stage_load, stage_take and store_tile
// all use these chunks, so a thread waits for, reads and overwrites only its
// own.  A walk over items i runs
//   stage_load(src(first));
//   per item: stage_take(); __syncthreads(); stage_load(src(next)); body
// so the copy of the next tile overlaps the body, and a barrier separates
// every read of the stage from the copy that overwrites it. ----
using bf16 = __nv_bfloat16;

template <typename T>
constexpr int CHUNK_VALUES = 16 / (int)sizeof(T);
template <typename T>
constexpr int CHUNKS = FT * D / CHUNK_VALUES<T> / NT;
// Row stride of the staged tile, in values of T: fp32 tiles as in S.xs,
// bf16 tiles packed (half the stage buffer).
template <typename T>
constexpr int STAGE_STRIDE = std::is_same<T, float>::value ? XS : D;

// x as the storage type T holds it: itself for fp32, rounded to the nearest
// bf16 (ties to even, as __float2bfloat16_rn and torch's .to(bfloat16)) for
// bf16.
template <typename T>
__device__ __forceinline__ float stored(float x) {
  if constexpr (std::is_same<T, bf16>::value) return __bfloat162float(__float2bfloat16_rn(x));
  return x;
}

template <typename T>
struct TileSrc {
  const T* a;       // rows [0, nv) of a (·, D) row-major source
  const float* b;   // a second source added to it (the pair gather, fp32), or nullptr
  int nv;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src) : "memory");
}

// The same copy of `bytes` (0 or 16) bytes, the rest of the 16 zero-filled
// (the backward's tiles past a row's end).
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <typename T>
__device__ __forceinline__ void stage_load(Smem& S, const TileSrc<T>& src) {
  constexpr int V = CHUNK_VALUES<T>;
  T* stage = reinterpret_cast<T*>(S.stage);
#pragma unroll
  for (int k = 0; k < CHUNKS<T>; ++k) {
    const int e = threadIdx.x + k * NT, r = e / (D / V), c = V * (e % (D / V));
    if (r < src.nv) cp_async16(&stage[r * STAGE_STRIDE<T> + c], src.a + r * D + c);
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// xs <- the staged tile of src (plus src.b, read here from the L2-resident
// embedding), widened to fp32, rows [nv, FT) zero, so a ragged last tile
// reads nothing past the end of the row.
template <typename T>
__device__ __forceinline__ void stage_take(Smem& S, const TileSrc<T>& src) {
  constexpr int V = CHUNK_VALUES<T>;
  const T* stage = reinterpret_cast<const T*>(S.stage);
  asm volatile("cp.async.wait_group 0;" ::: "memory");
#pragma unroll
  for (int k = 0; k < CHUNKS<T>; ++k) {
    const int e = threadIdx.x + k * NT, r = e / (D / V), c = V * (e % (D / V));
    if constexpr (std::is_same<T, float>::value) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (r < src.nv) {
        v = *reinterpret_cast<const float4*>(&stage[r * XS + c]);
        if (src.b != nullptr) {
          const float4 u = *reinterpret_cast<const float4*>(src.b + r * D + c);
          v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
        }
      }
      *reinterpret_cast<float4*>(&S.xs[r * XS + c]) = v;
    } else {
      float f[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (r < src.nv) {
        const uint4 raw = *reinterpret_cast<const uint4*>(&stage[r * D + c]);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 g = __bfloat1622float2(h[q]);
          f[2 * q] = g.x;
          f[2 * q + 1] = g.y;
        }
      }
      *reinterpret_cast<float4*>(&S.xs[r * XS + c]) = make_float4(f[0], f[1], f[2], f[3]);
      *reinterpret_cast<float4*>(&S.xs[r * XS + c + 4]) = make_float4(f[4], f[5], f[6], f[7]);
    }
  }
}

// rows [0, nv) of xs -> dst (·, D) as T, 16-byte stores; after a
// __syncthreads that follows the last write of xs.  For bf16 the values in
// xs are already stored<bf16>, so the conversion is exact.
template <typename T>
__device__ __forceinline__ void store_tile(const Smem& S, T* dst, int nv) {
  constexpr int V = CHUNK_VALUES<T>;
#pragma unroll
  for (int k = 0; k < CHUNKS<T>; ++k) {
    const int e = threadIdx.x + k * NT, r = e / (D / V), c = V * (e % (D / V));
    if (r < nv) {
      if constexpr (std::is_same<T, float>::value) {
        *reinterpret_cast<float4*>(dst + r * D + c) =
            *reinterpret_cast<const float4*>(&S.xs[r * XS + c]);
      } else {
        uint4 raw;
        __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          h[q] = __floats2bfloat162_rn(S.xs[r * XS + c + 2 * q], S.xs[r * XS + c + 2 * q + 1]);
        }
        *reinterpret_cast<uint4*>(dst + r * D + c) = raw;
      }
    }
  }
}

// Tile t of pair p: x_b[p] (·, D), or emb_b[ii[p]] + emb_b[jj[p]] when
// emb_b is given (the in-kernel pair gather, fp32: T is float there).
template <typename T>
__device__ __forceinline__ TileSrc<T> row_src(const T* x_b, const float* emb_b, const int* ii,
                                              const int* jj, int p, int t, int L) {
  const int l0 = t * FT;
  TileSrc<T> s;
  s.nv = min(FT, L - l0);
  if constexpr (std::is_same<T, float>::value) {
    if (emb_b != nullptr) {
      s.a = emb_b + ((size_t)ii[p] * L + l0) * D;
      s.b = emb_b + ((size_t)jj[p] * L + l0) * D;
    } else {
      s.a = x_b + ((size_t)p * L + l0) * D;
      s.b = nullptr;
    }
  } else {
    s.a = x_b + ((size_t)p * L + l0) * D;
    s.b = nullptr;
  }
  return s;
}

// Sum of the first L entries of m over the block, in a fixed order.
static __device__ float block_sum(const float* __restrict__ m, int L, Smem& S) {
  float v = 0.f;
  for (int l = threadIdx.x; l < L; l += NT) v += m[l];
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) S.wsum[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < NWARP; ++w) total += S.wsum[w];
  __syncthreads();
  return total;
}

// S.count <- max(real site count, 1); visible after the next __syncthreads.
// Kept in shared memory rather than a register through the row passes.
__device__ __forceinline__ void set_site_count(const float* __restrict__ smask_b, int L,
                                               Smem& S) {
  const float count = fmaxf(block_sum(smask_b, L, S), 1.f);
  if (threadIdx.x == 0) S.count = count;
}

// ---- body: kernel B (_body_b) on the tile in S.xs, in place: x1 -> x3 ----
// bw: the group's flat weights (norms, biases), bm: its matrices in the mma
// layout.  stats_b: (L, 3D) global column stats of this batch element, read
// one site tile at a time; n_pairs is max(real pair count, 1).  If dst is
// given, x3 is also written there.  The FFN's hidden never leaves the chip:
// it runs in four 64-wide chunks, each up-projected into S.as and
// down-projected into registers that persist over the chunks.  NP: the
// products' TF32 passes (mma_rows).
template <int GELU, int NP>
static __device__ void body_b(Smem& S, const float* __restrict__ bw,
                              const float* __restrict__ bm, const float* __restrict__ stats_b,
                              int l0, int nv, float n_pairs, float eps, float* dst) {
  ln_split<NP>(S.xs, S.hs[0], bw + B_CNS, bw + B_CNB, eps);
  __syncthreads();
  {
    float acc[1][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 1, NP>(S.hs[0], bm + BM_CWQ, nullptr, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int s = frag_row(mi, h), c = frag_col(ni);
          float2 ks = make_float2(1.f, 1.f), qs = ks, kv = make_float2(0.f, 0.f);
          if (s < nv) {
            const float* st = stats_b + (size_t)(l0 + s) * 3 * D;
            ks = ld2(st + c);
            qs = ld2(st + D + c);
            kv = ld2(st + 2 * D + c);
          }
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float qm = (e ? qs.y : qs.x) / n_pairs;
            qm = qm > 0.f ? qm : 1.f;
            float ksum = e ? ks.y : ks.x;
            ksum = ksum > 0.f ? ksum : 1.f;
            const float ctx = (e ? kv.y : kv.x) / ksum;
            out[e] = (phi_f(acc[0][mi][ni][2 * h + e] + bw[B_CBQ + c + e]) / qm) * ctx;
          }
          st_split<NP>(S.as[0], s * XS + c, out[0], out[1]);
        }
  }
  __syncthreads();
  {
    float acc[1][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 1, NP>(S.as[0], bm + BM_CWO, nullptr, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int s = frag_row(mi, h), c = frag_col(ni);
          const float2 x = ld2(&S.xs[s * XS + c]);
          st2(&S.xs[s * XS + c], x.x + (acc[0][mi][ni][2 * h] + bw[B_CBO + c]),
              x.y + (acc[0][mi][ni][2 * h + 1] + bw[B_CBO + c + 1]));  // x2
        }
  }
  __syncthreads();
  ln_split<NP>(S.xs, S.hs[0], bw + B_FNS, bw + B_FNB, eps);
  __syncthreads();
  float out[1][MI][NI][4];
  zero(out);
#pragma unroll 1
  for (int ch = 0; ch < F / D; ++ch) {
    float acc[1][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 1, NP>(S.hs[0], bm + BM_W1, nullptr, F / 8, 0, ch * (D / 8), acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int s = frag_row(mi, h), c = frag_col(ni);
          const float* b1 = bw + B_B1 + ch * D + c;
          st_split<NP>(S.as[0], s * XS + c, gelu<GELU>(acc[0][mi][ni][2 * h] + b1[0]),
                   gelu<GELU>(acc[0][mi][ni][2 * h + 1] + b1[1]));
        }
    __syncthreads();
    mma_rows<D / 8, 1, NP>(S.as[0], bm + BM_W2, nullptr, D / 8, ch * (D / 8), 0, out);
    __syncthreads();
  }
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const int s = frag_row(mi, h), c = frag_col(ni);
        const float2 x = ld2(&S.xs[s * XS + c]);
        st2(&S.xs[s * XS + c], x.x + (out[0][mi][ni][2 * h] + bw[B_B2 + c]),
            x.y + (out[0][mi][ni][2 * h + 1] + bw[B_B2 + c + 1]));  // x3
      }
  __syncthreads();
  if (dst != nullptr) store_tile(S, dst, nv);
}

// ---- body: row attention pass 1 (_body_row_attn sums, _kernel_a1) on S.xs ----
// Adds this tile's masked Σq, Σk, Σk·v of the thread's RC columns
// (frag_col(ni) + e, index 2 ni + e) over its rows to its sums.
// Sites at or past nv have mask 0, so a ragged tile adds nothing for them.
template <int NP>
static __device__ void row_sums(Smem& S, const float* __restrict__ rw,
                                const float* __restrict__ rm,
                                const float* __restrict__ smask_b, int l0, int nv, float eps,
                                float (&rq)[RC], float (&rk)[RC], float (&rkv)[RC]) {
  ln_split<NP>(S.xs, S.hs[0], rw + R_LNS, rw + R_LNB, eps);
  __syncthreads();
  float m[2][2];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int s = frag_row(mi, h);
      m[mi][h] = s < nv ? smask_b[l0 + s] : 0.f;
    }
  {
    float acc[1][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 1, NP>(S.hs[0], rm + RM_WQ, nullptr, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            rq[2 * ni + e] += phi_f(acc[0][mi][ni][2 * h + e] + rw[R_BQ + frag_col(ni) + e]) *
                              m[mi][h];
  }
  {
    float acc[2][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 2, NP>(S.hs[0], rm + RM_WK, rm + RM_WV, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = frag_col(ni) + e;
            const float k = phi_f(acc[0][mi][ni][2 * h + e] + rw[R_BK + c]) * m[mi][h];
            const float v = acc[1][mi][ni][2 * h + e] + rw[R_BV + c];
            rk[2 * ni + e] += k;
            rkv[2 * ni + e] += k * v;
          }
  }
}

// Combine the row sums in a fixed order, first over the 8 fragment rows of
// a warp (shuffles), then over the MG row warps, and store the pair's raw
// sums [Σq | Σk | Σk·v] (3 x D, _kernel_a1's rowstats layout).
static __device__ void store_row_sums(Smem& S, float (&rq)[RC], float (&rk)[RC],
                                      float (&rkv)[RC], float* rowsum_p) {
#pragma unroll
  for (int i = 0; i < RC; ++i)
#pragma unroll
    for (int o = 4; o < 32; o <<= 1) {
      rq[i] += __shfl_xor_sync(0xffffffffu, rq[i], o);
      rk[i] += __shfl_xor_sync(0xffffffffu, rk[i], o);
      rkv[i] += __shfl_xor_sync(0xffffffffu, rkv[i], o);
    }
  if ((threadIdx.x & 31) < 4) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = frag_col(ni) + e;
        S.red[(0 * MG + warp_m()) * D + c] = rq[2 * ni + e];
        S.red[(1 * MG + warp_m()) * D + c] = rk[2 * ni + e];
        S.red[(2 * MG + warp_m()) * D + c] = rkv[2 * ni + e];
      }
  }
  __syncthreads();
  if (threadIdx.x < 3 * D) {
    const int v = threadIdx.x / D, c = threadIdx.x % D;
    float sum = 0.f;
#pragma unroll
    for (int m = 0; m < MG; ++m) sum += S.red[(v * MG + m) * D + c];
    rowsum_p[v * D + c] = sum;
  }
  __syncthreads();
}

// Row walk of pass 1 over the pairs [p0, p1) (each row whole, tile by tile)
// of x_b, or of emb_b[i] + emb_b[j] (the in-kernel pair gather); stores
// each pair's raw sums.  x_b is stored as T.
template <int NP, typename T>
static __device__ void row_pass1(Smem& S, const T* x_b, const float* emb_b, const int* ii,
                                 const int* jj, const float* __restrict__ rw,
                                 const float* __restrict__ rm,
                                 const float* __restrict__ smask_b, int p0, int p1, int L,
                                 float eps, float* rowsum_b) {
  const int nt = n_ftiles_of(L), n = (p1 - p0) * nt;
  float rq[RC], rk[RC], rkv[RC];
  if (n > 0) stage_load(S, row_src(x_b, emb_b, ii, jj, p0, 0, L));
  for (int i = 0; i < n; ++i) {
    const int p = p0 + i / nt, t = i % nt;
    const TileSrc<T> cur = row_src(x_b, emb_b, ii, jj, p, t, L);
    const int nv = cur.nv;
    stage_take(S, cur);
    __syncthreads();
    if (i + 1 < n) stage_load(S, row_src(x_b, emb_b, ii, jj, p0 + (i + 1) / nt, (i + 1) % nt, L));
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < RC; ++c) rq[c] = rk[c] = rkv[c] = 0.f;
    }
    row_sums<NP>(S, rw, rm, smask_b, t * FT, nv, eps, rq, rk, rkv);
    if (t == nt - 1) store_row_sums(S, rq, rk, rkv, rowsum_b + (size_t)p * 3 * D);
  }
}

// ---- bodies: row attention pass 2 (_body_row_attn output, _kernel_a2) and
// the column stats (_body_col_stats) on S.xs.  rs holds the pair's raw row
// sums [Σq | Σk | Σk·v], finalized here with the guards where(s > 0, s, 1)
// and the site count S.count (_kernel_a2's q_mean and ctx = Σk·v / Σk);
// x1 goes to dst and the pair's masked column sums are added to the
// thread's ck/cq/ckv (element RC (2 mi + h) + 2 ni + e: row frag_row(mi, h),
// column frag_col(ni) + e).  x1 is stored as TO; the column stats are taken
// from the stored (for bf16, rounded) x1, as the next kernel reads it ----
template <int NP, typename TO>
static __device__ void row_out_col_stats(Smem& S, const float* __restrict__ rw,
                                         const float* __restrict__ rm,
                                         const float* __restrict__ cw,
                                         const float* __restrict__ cm,
                                         const float* __restrict__ smask_b, float pm, int l0,
                                         int nv, float eps, const float* rs, TO* dst,
                                         float (&ck)[CE], float (&cq)[CE], float (&ckv)[CE]) {
  float qm[RC], ctx[RC];
#pragma unroll
  for (int ni = 0; ni < NI; ++ni)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = frag_col(ni) + e;
      float q = rs[c] / S.count;
      qm[2 * ni + e] = q > 0.f ? q : 1.f;
      float ks = rs[D + c];
      ks = ks > 0.f ? ks : 1.f;
      ctx[2 * ni + e] = rs[2 * D + c] / ks;
    }
  ln_split<NP>(S.xs, S.hs[0], rw + R_LNS, rw + R_LNB, eps);
  __syncthreads();
  {
    float acc[1][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 1, NP>(S.hs[0], rm + RM_WQ, nullptr, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int s = frag_row(mi, h);
        const float m = s < nv ? smask_b[l0 + s] : 0.f;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int c = frag_col(ni);
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            out[e] = (phi_f(acc[0][mi][ni][2 * h + e] + rw[R_BQ + c + e]) * m / qm[2 * ni + e]) *
                     ctx[2 * ni + e];
          st_split<NP>(S.as[0], s * XS + c, out[0], out[1]);
        }
      }
  }
  __syncthreads();
  {
    float acc[1][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 1, NP>(S.as[0], rm + RM_WO, nullptr, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int s = frag_row(mi, h), c = frag_col(ni);
          const float2 x = ld2(&S.xs[s * XS + c]);
          st2(&S.xs[s * XS + c], stored<TO>(x.x + (acc[0][mi][ni][2 * h] + rw[R_BO + c])),
              stored<TO>(x.y + (acc[0][mi][ni][2 * h + 1] + rw[R_BO + c + 1])));  // x1
        }
  }
  __syncthreads();
  store_tile(S, dst, nv);
  ln_split<NP>(S.xs, S.hs[0], cw + C_LNS, cw + C_LNB, eps);
  __syncthreads();
  {
    float acc[1][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 1, NP>(S.hs[0], cm + CM_WQ, nullptr, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            cq[RC * (2 * mi + h) + 2 * ni + e] +=
                phi_f(acc[0][mi][ni][2 * h + e] + cw[C_BQ + frag_col(ni) + e]) * pm;
  }
  {
    float acc[2][MI][NI][4];
    zero(acc);
    mma_rows<D / 8, 2, NP>(S.hs[0], cm + CM_WK, cm + CM_WV, D / 8, 0, 0, acc);
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int ni = 0; ni < NI; ++ni)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = frag_col(ni) + e, i = RC * (2 * mi + h) + 2 * ni + e;
            const float kc = phi_f(acc[0][mi][ni][2 * h + e] + cw[C_BK + c]) * pm;
            const float vc = acc[1][mi][ni][2 * h + e] + cw[C_BV + c];
            ck[i] += kc;
            ckv[i] += kc * vc;
          }
  }
}

// Kernel B's arguments, for a pass 2 that runs B on each tile first (kernel
// M at bf16 storage: x3 stays fp32, recomputed from the stored x1).
struct BArgs {
  const float* bw;
  const float* bm;
  const float* stats_b;
  float n_pairs;
};

// Pass 2 shared by kernels A, M and A2: site tiles [t0, t1) outermost, the
// pairs [p0, p1) innermost.  The row source is x_in (stored as TI; or
// emb[i] + emb[j]), x1 goes to x_out (stored as TO); with GELU_B >= 0 each
// tile first runs kernel B (ba) and the row attention takes its x3.
// rowsum_b holds each pair's raw row sums [Σq | Σk | Σk·v] (3 x D) and
// S.count the site count (set_site_count).  The column stats of the block's
// pairs go to rows [t0·FT, t1·FT) ∩ [0, L) of its (L, 3D) partial.
template <int NP, typename TI, typename TO, int GELU_B = -1>
static __device__ void pass2(Smem& S, const TI* x_in, const float* emb_b, const int* ii,
                             const int* jj, TO* x_out, const float* __restrict__ smask_b,
                             const float* __restrict__ pmask_b, const float* __restrict__ rw,
                             const float* __restrict__ rm, const float* __restrict__ cw,
                             const float* __restrict__ cm, const float* rowsum_b,
                             float* partial_bs, int p0, int p1, int t0, int t1, int L,
                             float eps, BArgs ba = BArgs{}) {
  const int np = p1 - p0, n = (t1 - t0) * np;
  float ck[CE], cq[CE], ckv[CE];
  if (n > 0) stage_load(S, row_src(x_in, emb_b, ii, jj, p0, t0, L));
  for (int i = 0; i < n; ++i) {
    const int t = t0 + i / np, p = p0 + i % np, l0 = t * FT;
    const TileSrc<TI> cur = row_src(x_in, emb_b, ii, jj, p, t, L);
    const int nv = cur.nv;
    stage_take(S, cur);
    __syncthreads();
    if (i + 1 < n) {
      stage_load(S, row_src(x_in, emb_b, ii, jj, p0 + (i + 1) % np, t0 + (i + 1) / np, L));
    }
    if (p == p0) {
#pragma unroll
      for (int k = 0; k < CE; ++k) ck[k] = cq[k] = ckv[k] = 0.f;
    }
    if constexpr (GELU_B >= 0) {
      body_b<GELU_B, NP>(S, ba.bw, ba.bm, ba.stats_b, l0, nv, ba.n_pairs, eps, nullptr);
    }
    row_out_col_stats<NP>(S, rw, rm, cw, cm, smask_b, pmask_b[p], l0, nv, eps,
                      rowsum_b + (size_t)p * 3 * D, x_out + ((size_t)p * L + l0) * D, ck, cq,
                      ckv);
    if (p == p1 - 1) {
#pragma unroll
      for (int mi = 0; mi < MI; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int s = frag_row(mi, h);
          if (s < nv) {
            float* pp = partial_bs + (size_t)(l0 + s) * 3 * D;
#pragma unroll
            for (int ni = 0; ni < NI; ++ni) {
              const int c = frag_col(ni), i0 = RC * (2 * mi + h) + 2 * ni;
              st2(pp + c, ck[i0], ck[i0 + 1]);
              st2(pp + D + c, cq[i0], cq[i0 + 1]);
              st2(pp + 2 * D + c, ckv[i0], ckv[i0 + 1]);
            }
          }
        }
    }
  }
}

template <typename K>
static cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem));
}

// Launch a forward kernel on the (gx, B) grid with the forward's block and
// shared memory; the launch's error code.
template <typename K, typename... Args>
static int launch(K kernel, int gx, int B, void* stream, Args... args) {
  cudaError_t e = allow_smem(kernel);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(gx, B), NT, sizeof(Smem), (cudaStream_t)stream>>>(args...);
  return (int)cudaGetLastError();
}

// ---- host side: the entries' variant codes -> template arguments ----
template <int V>
using Int = std::integral_constant<int, V>;
template <typename T>
struct Tag {
  using type = T;
};

// f(Int<NP>{}) for `passes` TF32 passes (PASSES_SPLIT or PASSES_ONE); an
// invalid-value error for any other count.
template <typename F>
static int with_passes(int passes, F&& f) {
  if (passes == PASSES_SPLIT) return f(Int<PASSES_SPLIT>{});
  if (passes == PASSES_ONE) return f(Int<PASSES_ONE>{});
  return (int)cudaErrorInvalidValue;
}

// f(Tag<T>{}) for the storage code of x1 (STORE_F32 or STORE_BF16).
template <typename F>
static int with_storage(int storage, F&& f) {
  if (storage == STORE_F32) return f(Tag<float>{});
  if (storage == STORE_BF16) return f(Tag<bf16>{});
  return (int)cudaErrorInvalidValue;
}

// f(Int<GELU>{}, Int<NP>{}, Tag<T>{}) for the codes of kernels M and Z (every
// activation at both pass counts and both storage types).
template <typename F>
static int with_variant(int gelu, int passes, int storage, F&& f) {
  return with_passes(passes, [&](auto np) {
    return with_storage(storage, [&](auto tag) -> int {
      switch (gelu) {
        case GELU_EXACT: return f(Int<GELU_EXACT>{}, np, tag);
        case GELU_TANH: return f(Int<GELU_TANH>{}, np, tag);
        case GELU_SIGMOID: return f(Int<GELU_SIGMOID>{}, np, tag);
        case GELU_RELU: return f(Int<GELU_RELU>{}, np, tag);
        default: return (int)cudaErrorInvalidValue;
      }
    });
  });
}

}  // namespace pf
