// Kernel M of the pipelined forward on Hopper's warpgroup MMA (sm_90a), x1
// stored fp32: kernel B of block i, then kernel A of block i+1, x1 in place.
//
// It replaces _kernel_m (phyloformer_tpu/ops/pallas/pipeline.py:176).  Per
// pair-site it runs 18 chained products of K = 64 (kernel B's column q and
// o, the FFN's four chunks of w1 and w2; the row attention's q, k, v, then
// q and o again in the second pass; the column q, k, v), 139,264 FLOP at
// d x d q/k, three times that on the TF32 tensor cores at three passes,
// against 512 B of activations: tensor-core arithmetic bounds it (0.84 ns a
// pair-site at 495 TFLOP/s against 0.15 ns for its bytes).  What held the
// mma.sync design (axial_pipeline_m_bf16.cu, the note of axial_pipeline.cu)
// far from that bound is that 8 warps shared one tile and every stage
// between two products (LayerNorm five times a tile, φ, the exact GELU's
// erff, the masks, the TF32 splits) ended at a block-wide barrier: the
// SM's warps either fed the tensor cores or ran SIMT code.
//
// Design.
// - One block an SM (the grid is at most the SM count), three warpgroups:
//   two consumers, each walking 64-site tiles of its own, and a producer
//   (one thread of it copies; setmaxnreg gives its registers to the
//   consumers).  The products are wgmma.m64n64k8 TF32, asynchronous; the
//   consumers take turns issuing them (FlashAttention-3's ping-pong), so
//   one's products run on the tensor cores while the other runs its
//   LayerNorm, φ, GELU and splits.  Barriers are per warpgroup (named
//   barriers) and mbarriers, never block-wide inside a pass.
// - The producer brings each consumer's next 64-site tile (one bulk copy a
//   site row, cp.async.bulk, into a padded stage that the consumers read
//   without bank conflicts) and every product's weight plane, in the order
//   both consumers run them, into a ring of three 32 KB slots (six of
//   16 KB at one pass).  A slot is refilled once both consumers have
//   released it.  M's weights (272 KB in fp32, twice that split) do not fit
//   shared memory; a 64 x 64 plane does, pre-arranged on the host in the
//   image wgmma reads (pipeline.pack_wg), so one 1-D bulk copy lands it.
// - The residual stream of a tile lives in registers in the accumulator
//   layout (row 16 warp + lane / 4 and + 8, columns 8j + 2 (lane % 4) + e),
//   so LayerNorm is a sum over a quad of lanes and every residual add is
//   local.  LayerNorm outputs and the attention outputs are written split
//   (big and small TF32 planes) into the warpgroup's A buffer in shared
//   memory (wgmma's A from shared memory, each warp writing its own rows);
//   the GELU chunk stays in registers as wgmma's A operand, which is why
//   w2's rows are permuted (axial_pipeline.cuh).
// - Work: the block's pairs [p0, p1) form n = pairs x tiles items a pass;
//   consumer w takes items w, w + 2, ...  Pass 1 (pair-major) runs kernel B,
//   writes x3 in place and sums the row's Σq, Σk, Σk·v over its own tiles
//   into its own slot of the row sums (zeros for a row it has no tile of);
//   pass 2 (tile-major) finalizes them from both slots, writes x1 in place
//   and sums the column stats over its own pairs of each tile into its own
//   partial slot, which pf_reduce_slots adds in its fixed order.  Both consumers
//   walk every step of the plane sequence, a consumer without an item
//   releasing the planes unread, so the ring stays shared.
// - Three passes: a_small·b_big + a_big·b_small + a_big·b_big a k-step,
//   accumulated in fp32, as the mma.sync kernels; one pass a_big·b_big.
//   Numerics as kernel_m_plain: the guards, counts and masks of the JAX
//   bodies; only the order of some sums differs (LayerNorm's, the row and
//   column sums').

#include "axial_bodies.cuh"

namespace pf {
namespace wg {

constexpr int NC = M_CONSUMERS;     // consumer warpgroups
constexpr int WGT = 128;            // threads of a warpgroup
constexpr int NTM = (NC + 1) * WGT;  // the block: consumers, then the producer's warpgroup
// setmaxnreg: the block starts at 168 registers a thread (65,536 / 384,
// rounded down to 8); the producer's warpgroup gives 128 x (168 - 40) up and
// the consumers take exactly that, 256 x (232 - 168).  setmaxnreg.inc waits
// for registers the block's own warps released, so a consumer count above
// what the producer frees never starts.
constexpr int LAUNCH_REGS = 168;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert(WGT * (LAUNCH_REGS - PRODUCER_REGS) >= NC * WGT * (CONSUMER_REGS - LAUNCH_REGS),
              "the consumers take no more registers than the producer releases");
constexpr int XSTR = D + 8;         // row stride of a staged tile (floats)
constexpr int RING_FLOATS = 3 * WG_PLANE;
constexpr int B_LBO = 1024;         // bytes between the K chunks of a weight plane
constexpr int A_LBO = 1088;         // ... of an A plane: the split stores hit 32 banks
constexpr int A_PLANE = 16 * A_LBO / 4;  // floats of one A plane
constexpr int CORE_SBO = 128;       // bytes between 8-row groups (core matrices)
constexpr int PASS1_PLANES = 13;    // cwq, cwo, 4 x (w1, w2), row wq, wk, wv
constexpr int PASS2_PLANES = 5;     // row wq, wo, column wq, wk, wv
// The products an item issues, one turn each, the last one of a pass
// reading two planes (k and v).
constexpr int PASS1_TURNS = 12;
constexpr int PASS2_TURNS = 4;
static_assert(PASS1_PLANES == PASS1_TURNS + 1 && PASS2_PLANES == PASS2_TURNS + 1,
              "each pass's last product reads two planes");
constexpr int BAR_BOTH = 1 + NC;    // named barrier of both consumer warpgroups
constexpr int BAR_TURN = 2 + NC;    // + w: consumer w's turn to issue products

static_assert(NC == 2, "consumer w takes every second item");

template <int NP>
__host__ __device__ constexpr int slot_floats() {
  return NP == PASSES_SPLIT ? WG_PLANE : WG_PLANE / 2;
}
template <int NP>
__host__ __device__ constexpr int n_slots() { return RING_FLOATS / slot_floats<NP>(); }

struct SmemM {
  float ring[RING_FLOATS];         // weight planes in flight
  float hs[NC][2 * A_PLANE];       // each consumer's A operand: big plane, small plane
  float stage[NC][FT * XSTR];      // each consumer's next tile (cp.async.bulk)
  float qm[NC][D];                 // the pair's row q-mean and ctx (pass 2)
  float ctx[NC][D];
  float red[NC][4][3 * D];         // a row's sums by warp, combined in a fixed order
  float wsum[NTM / 32];
  float count;                     // max(real site count, 1)
  unsigned long long full[6], empty[6], xfull[NC], xempty[NC], pass1;
};

static_assert(sizeof(SmemM) <= 232448, "one block's shared memory on an H100");

// ---- Hopper primitives ----
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(b)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(b)) : "memory");
}

// Arrive and expect `bytes` more of bulk-copy transactions on this phase.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* b, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(b)),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* b, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@!P1 bra WAIT;\n"
      "}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}

// `bytes` from global src to shared dst, completing on mbarrier bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Named barrier `id` of `count` threads (id 0 is __syncthreads').
template <int COUNT>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(COUNT) : "memory");
}

// Generic-proxy writes of shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// wgmma's descriptor of a K-major operand without swizzle: core matrices of
// 8 rows x 16 bytes, `lbo` bytes apart along K, CORE_SBO along the rows.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(CORE_SBO >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from moving reads or writes of an accumulator across
// the asynchronous products.
template <int N, typename T>
__device__ __forceinline__ void pin(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value) {
      asm volatile("" : "+f"(r[i])::"memory");
    } else {
      asm volatile("" : "+r"(r[i])::"memory");
    }
  }
}

#define PF_D32(d)                                                                             \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define PF_D32_LIST                                                                  \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d += A B, a 64 x 8 A and an 8 x 64 B, both from shared memory.
__device__ __forceinline__ void mma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PF_D32_LIST
      ", %32, %33, p, 1, 1;\n}\n"
      : PF_D32(d)
      : "l"(a), "l"(b), "r"(1));
}

// d += A B, A from registers (this thread's fragment of a 64 x 8 tile).
__device__ __forceinline__ void mma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PF_D32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : PF_D32(d)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(b), "r"(1));
}

// d += A W over K = 64 (issued, not waited): A the split planes at shared
// address a, W the plane at shared address w.
template <int NP>
__device__ __forceinline__ void issue_ss(float (&d)[32], uint32_t a, uint32_t w) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint64_t ab = desc(a + 2 * j * A_LBO, A_LBO), wb = desc(w + 2 * j * B_LBO, B_LBO);
    if constexpr (NP == PASSES_SPLIT) {
      const uint64_t as = desc(a + 4 * A_PLANE + 2 * j * A_LBO, A_LBO);
      const uint64_t ws = desc(w + 4 * D * D + 2 * j * B_LBO, B_LBO);
      mma_ss(d, as, wb);
      mma_ss(d, ab, ws);
      mma_ss(d, ab, wb);
    } else {
      mma_ss(d, ab, wb);
    }
  }
}

// The same with A from registers: k-step j's fragment is ab[4j .. 4j + 3]
// (big) and as[...] (small).
template <int NP>
__device__ __forceinline__ void issue_rs(float (&d)[32], const uint32_t (&ab)[32],
                                         const uint32_t (&as)[32], uint32_t w) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const uint64_t wb = desc(w + 2 * j * B_LBO, B_LBO);
    if constexpr (NP == PASSES_SPLIT) {
      const uint64_t ws = desc(w + 4 * D * D + 2 * j * B_LBO, B_LBO);
      mma_rs(d, as[4 * j], as[4 * j + 1], as[4 * j + 2], as[4 * j + 3], wb);
      mma_rs(d, ab[4 * j], ab[4 * j + 1], ab[4 * j + 2], ab[4 * j + 3], ws);
    }
    mma_rs(d, ab[4 * j], ab[4 * j + 1], ab[4 * j + 2], ab[4 * j + 3], wb);
  }
}

__device__ __forceinline__ void zero32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// ---- the weight ring: use u of the plane sequence sits in slot u % n_slots ----
template <int NP>
struct Ring {
  SmemM& S;
  int u = 0;
  __device__ Ring(SmemM& s) : S(s) {}
  // Shared address of use u + k, once it has landed.
  __device__ uint32_t take(int k) {
    const int v = u + k, q = v % n_slots<NP>();
    mbar_wait(&S.full[q], (v / n_slots<NP>()) & 1);
    return smem_u32(S.ring + q * slot_floats<NP>());
  }
  // This consumer is done with the next k uses (one arrival a warpgroup).
  __device__ void release(int k, bool leader) {
    for (int i = 0; i < k; ++i, ++u)
      if (leader) mbar_arrive(&S.empty[u % n_slots<NP>()]);
  }
  // A step without an item: its products' turns, each one's planes taken
  // and released unread.
  __device__ void skip(int turns, int w, bool leader) {
    for (int i = 0; i < turns; ++i) {
      const int k = i + 1 < turns ? 1 : 2;
      if (leader)
        for (int j = 0; j < k; ++j) take(j);
      turn_begin(w);
      turn_end(w);
      release(k, leader);
    }
  }
  // The consumers take turns on the tensor cores: consumer w issues its
  // next product only after the other one issued its own (waiting here) ...
  static __device__ void turn_begin(int w) { bar_sync<NC * WGT>(BAR_TURN + w); }
  // ... and hands the next turn over once it has issued.
  static __device__ void turn_end(int w) {
    asm volatile("bar.arrive %0, %1;" ::"r"(BAR_TURN + 1 - w), "n"(NC * WGT) : "memory");
  }
};

// The plane that product k of pass `pass` reads, in pack_wg's groups.
__device__ __forceinline__ const float* plane_of(int pass, int k, const float* bg,
                                                 const float* rg, const float* cg) {
  if (pass == 0) {
    if (k < 2) return bg + (k == 0 ? BG_CWQ : BG_CWO) * WG_PLANE;
    if (k < 10) return bg + (((k - 2) & 1) ? BG_W2 : BG_W1) * WG_PLANE + ((k - 2) >> 1) * WG_PLANE;
    return rg + (RG_WQ + (k - 10)) * WG_PLANE;
  }
  if (k == 0) return rg + RG_WQ * WG_PLANE;
  if (k == 1) return rg + RG_WO * WG_PLANE;
  return cg + (CG_WQ + (k - 2)) * WG_PLANE;
}

// Item i of a pass: pass 1 pair-major, pass 2 tile-major.
__device__ __forceinline__ void item_of(int pass, int i, int nt, int np, int p0, int& p, int& t) {
  if (pass == 0) {
    p = p0 + i / nt;
    t = i % nt;
  } else {
    t = i / np;
    p = p0 + i % np;
  }
}

// ---- the producer: one thread ----
template <int NP>
__device__ void produce(SmemM& S, const float* x_b, const float* bg, const float* rg,
                        const float* cg, int p0, int p1, int L) {
  constexpr uint32_t PLANE_BYTES = 4 * slot_floats<NP>();
  const int nt = n_ftiles_of(L), np = p1 - p0, n = np * nt, steps = (n + 1) / 2;
  int u = 0, xj[NC] = {};
  for (int pass = 0; pass < 2; ++pass) {
    // pass 2 reads the x3 that pass 1 wrote in place
    if (pass == 1) mbar_wait(&S.pass1, 0);
    const int planes = pass == 0 ? PASS1_PLANES : PASS2_PLANES;
    for (int s = 0; s < steps; ++s) {
      for (int w = 0; w < NC; ++w) {
        const int i = 2 * s + w;
        if (i >= n) continue;
        int p, t;
        item_of(pass, i, nt, np, p0, p, t);
        const int l0 = t * FT, nv = min(FT, L - l0);
        if (xj[w] > 0) mbar_wait(&S.xempty[w], (xj[w] - 1) & 1);
        mbar_expect_tx(&S.xfull[w], (uint32_t)(nv * D * 4));
        const float* src = x_b + ((size_t)p * L + l0) * D;
        for (int r = 0; r < nv; ++r) bulk_load(S.stage[w] + r * XSTR, src + r * D, D * 4, &S.xfull[w]);
        ++xj[w];
      }
      for (int k = 0; k < planes; ++k, ++u) {
        const int q = u % n_slots<NP>(), use = u / n_slots<NP>();
        if (use > 0) mbar_wait(&S.empty[q], (use - 1) & 1);
        mbar_expect_tx(&S.full[q], PLANE_BYTES);
        bulk_load(S.ring + q * slot_floats<NP>(), plane_of(pass, k, bg, rg, cg), PLANE_BYTES,
                  &S.full[q]);
      }
    }
  }
}

// ---- the consumers' stages, on a tile held in registers: element 4j + 2h + e
// of a thread's 32 is row 16 warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e ----
struct Lane {
  int w, ltid, warp, g, t, r0;
  bool leader;  // the thread that arrives for its warpgroup
  __device__ Lane() {
    w = threadIdx.x / WGT;
    ltid = threadIdx.x & (WGT - 1);
    leader = ltid == 0;
    warp = ltid >> 5;
    g = (threadIdx.x & 31) >> 2;
    t = threadIdx.x & 3;
    r0 = 16 * warp + g;
  }
  __device__ int col(int j) const { return 8 * j + 2 * t; }
  // float index of A element (row, k) in an A plane
  __device__ int a_index(int row, int k) const {
    return (k >> 2) * (A_LBO / 4) + (row >> 3) * 32 + (row & 7) * 4 + (k & 3);
  }
};

// An operand element pair (columns c, c + 1 of row `row`) split into the A
// planes at hs: big at hs, small at hs + A_PLANE (one pass: big alone).
template <int NP>
__device__ __forceinline__ void put_split(float* hs, int idx, float a, float b) {
  if constexpr (NP == PASSES_ONE) {
    st2(hs + idx, __uint_as_float(to_tf32(a)), __uint_as_float(to_tf32(b)));
  } else {
    uint32_t ba, sa, bb, sb;
    split_tf32(a, ba, sa);
    split_tf32(b, bb, sb);
    st2(hs + idx, __uint_as_float(ba), __uint_as_float(bb));
    st2(hs + A_PLANE + idx, __uint_as_float(sa), __uint_as_float(sb));
  }
}

// LayerNorm of the tile x (registers) into the A planes hs, split; then the
// fence and the warpgroup barrier that make it visible to the products.
template <int NP>
__device__ __forceinline__ void ln_to_a(const Lane& ln, int bar, const float (&x)[32], float* hs,
                                        const float* __restrict__ scale,
                                        const float* __restrict__ bias, float eps) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s += x[4 * j + 2 * h] + x[4 * j + 2 * h + 1];
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    const float mu = s * (1.f / D);
    float v = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float da = x[4 * j + 2 * h] - mu, db = x[4 * j + 2 * h + 1] - mu;
      v += da * da + db * db;
    }
    v += __shfl_xor_sync(0xffffffffu, v, 1);
    v += __shfl_xor_sync(0xffffffffu, v, 2);
    const float r = 1.f / sqrtf(v * (1.f / D) + eps);
    const int row = ln.r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = ln.col(j);
      const float2 sc = ld2(scale + c), bi = ld2(bias + c);
      put_split<NP>(hs, ln.a_index(row, c), (x[4 * j + 2 * h] - mu) * r * sc.x + bi.x,
                    (x[4 * j + 2 * h + 1] - mu) * r * sc.y + bi.y);
    }
  }
  fence_async_shared();
  bar_sync<WGT>(bar);
}

// acc = A W for the A planes at hs and the ring's next plane: issued in
// this consumer's turn, then waited and the plane released.
template <int NP>
__device__ __forceinline__ void issue_product(const Lane& ln, Ring<NP>& ring, float (&acc)[32],
                                              uint32_t hs) {
  zero32(acc);
  const uint32_t w = ring.take(0);
  pin(acc);
  Ring<NP>::turn_begin(ln.w);
  wg_fence();
  issue_ss<NP>(acc, hs, w);
  wg_commit();
  Ring<NP>::turn_end(ln.w);
}

template <int NP>
__device__ __forceinline__ void finish_product(const Lane& ln, Ring<NP>& ring, float (&acc)[32]) {
  wg_wait();
  pin(acc);
  ring.release(1, ln.leader);
}

template <int NP>
__device__ __forceinline__ void product(const Lane& ln, Ring<NP>& ring, float (&acc)[32],
                                        uint32_t hs) {
  issue_product(ln, ring, acc, hs);
  finish_product(ln, ring, acc);
}

template <int NP, int GELU>
__device__ void body_b_wg(const Lane& ln, int bar, Ring<NP>& ring, float (&x)[32], float* hs,
                          const float* __restrict__ bw, const float* __restrict__ stats_b,
                          int l0, int nv, float n_pairs, float eps) {
  const uint32_t hsa = smem_u32(hs);
  float acc[32];
  // column attention from the stats: q, then (φ(q) / q-mean) ctx, then o;
  // the stats of the tile load while q is on the tensor cores
  ln_to_a<NP>(ln, bar, x, hs, bw + B_CNS, bw + B_CNB, eps);
  issue_product(ln, ring, acc, hsa);
  // (its q-mean and ctx of each element, guarded: rows past nv read 1, 1, 0)
  float qm[32], ctx[32];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = ln.r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 ks = make_float2(1.f, 1.f), qs = ks, kv = make_float2(0.f, 0.f);
      if (s < nv) {
        const float* st = stats_b + (size_t)(l0 + s) * 3 * D + ln.col(j);
        ks = ld2(st);
        qs = ld2(st + D);
        kv = ld2(st + 2 * D);
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 4 * j + 2 * h + e;
        qm[k] = (e ? qs.y : qs.x) / n_pairs;
        qm[k] = qm[k] > 0.f ? qm[k] : 1.f;
        float ksum = e ? ks.y : ks.x;
        ksum = ksum > 0.f ? ksum : 1.f;
        ctx[k] = (e ? kv.y : kv.x) / ksum;
      }
    }
  }
  finish_product(ln, ring, acc);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = ln.r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = ln.col(j), k = 4 * j + 2 * h;
      put_split<NP>(hs, ln.a_index(s, c),
                    (phi_f(acc[k] + bw[B_CBQ + c]) / qm[k]) * ctx[k],
                    (phi_f(acc[k + 1] + bw[B_CBQ + c + 1]) / qm[k + 1]) * ctx[k + 1]);
    }
  }
  fence_async_shared();
  bar_sync<WGT>(bar);
  product(ln, ring, acc, hsa);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 bo = ld2(bw + B_CBO + ln.col(j));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[4 * j + 2 * h] += acc[4 * j + 2 * h] + bo.x;  // x2
      x[4 * j + 2 * h + 1] += acc[4 * j + 2 * h + 1] + bo.y;
    }
  }
  // FFN: four 64-wide chunks of the hidden, each GELU'd in registers and
  // taken as the A operand of its w2 chunk
  ln_to_a<NP>(ln, bar, x, hs, bw + B_FNS, bw + B_FNB, eps);
  float out[32];
  zero32(out);
#pragma unroll 1
  for (int ch = 0; ch < F / D; ++ch) {
    product(ln, ring, acc, hsa);
    uint32_t ab[32], as[32];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b1 = ld2(bw + B_B1 + ch * D + ln.col(j));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // accumulator element i = 2h + e (row + 8h, column 8j + 2t + e) ->
        // A register 2e + h (row + 8h, k slot 8j + t + 4e)
        const int a = 4 * j + ((i & 1) << 1) + (i >> 1);
        const float v = gelu<GELU>(acc[4 * j + i] + ((i & 1) ? b1.y : b1.x));
        if constexpr (NP == PASSES_SPLIT) {
          split_tf32(v, ab[a], as[a]);
        } else {
          ab[a] = to_tf32(v);
          as[a] = 0u;
        }
      }
    }
    const uint32_t w = ring.take(0);
    pin(out);
    pin(ab);
    pin(as);
    Ring<NP>::turn_begin(ln.w);
    wg_fence();
    issue_rs<NP>(out, ab, as, w);
    wg_commit();
    Ring<NP>::turn_end(ln.w);
    wg_wait();
    pin(out);
    pin(ab);
    pin(as);
    ring.release(1, ln.leader);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 b2 = ld2(bw + B_B2 + ln.col(j));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      x[4 * j + 2 * h] += out[4 * j + 2 * h] + b2.x;  // x3
      x[4 * j + 2 * h + 1] += out[4 * j + 2 * h + 1] + b2.y;
    }
  }
}

template <int NP>
__device__ __forceinline__ void finish_kv(const Lane& ln, Ring<NP>& ring, float (&ak)[32],
                                          float (&av)[32]) {
  wg_wait();
  pin(ak);
  pin(av);
  ring.release(2, ln.leader);
}

// ak = A Wk and av = A Wv for the ring's next two planes, in one turn.
template <int NP>
__device__ __forceinline__ void product_kv(const Lane& ln, Ring<NP>& ring, float (&ak)[32],
                                           float (&av)[32], uint32_t hs) {
  zero32(ak);
  zero32(av);
  const uint32_t wk = ring.take(0), wv = ring.take(1);
  pin(ak);
  pin(av);
  Ring<NP>::turn_begin(ln.w);
  wg_fence();
  issue_ss<NP>(ak, hs, wk);
  issue_ss<NP>(av, hs, wv);
  wg_commit();
  Ring<NP>::turn_end(ln.w);
  finish_kv(ln, ring, ak, av);
}

// x (registers) -> rows [0, nv) of the tile at dst.
__device__ __forceinline__ void store_x(const Lane& ln, const float (&x)[32], float* dst, int nv) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = ln.r0 + 8 * h;
    if (s < nv) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        st2(dst + s * D + ln.col(j), x[4 * j + 2 * h], x[4 * j + 2 * h + 1]);
    }
  }
}

// The staged tile (rows [nv, FT) as zeros) into registers; the stage is
// released to the producer.
__device__ __forceinline__ void take_x(const Lane& ln, SmemM& S, int w, int& xj, float (&x)[32],
                                       int nv) {
  mbar_wait(&S.xfull[w], xj & 1);
  ++xj;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = ln.r0 + 8 * h;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 v = make_float2(0.f, 0.f);
      if (s < nv) v = ld2(S.stage[w] + s * XSTR + ln.col(j));
      x[4 * j + 2 * h] = v.x;
      x[4 * j + 2 * h + 1] = v.y;
    }
  }
  mbar_arrive(&S.xempty[w]);
}

// ---- a consumer warpgroup's two passes over its items ----
template <int GELU, int NP>
__device__ __forceinline__ void consume(
    const Lane& ln, SmemM& S, float* x_b, const float* __restrict__ stats,
    const float* __restrict__ smask_b, const float* __restrict__ pmask,
    const float* __restrict__ pair_count, const float* __restrict__ bw,
    const float* __restrict__ rw, const float* __restrict__ cw, float* rowsum, float* partial,
    int p0, int p1, int P, int L, int G, float eps) {
  const int b = blockIdx.y, w = ln.w;
  const int bar = 1 + w;  // this consumer's named barrier
  Ring<NP> ring(S);
  float* hs = S.hs[w];
  const uint32_t hsa = smem_u32(hs);
  const float* stats_b = stats + (size_t)b * L * 3 * D;
  const float n_pairs = fmaxf(pair_count[b], 1.f);
  const int nt = n_ftiles_of(L), np = p1 - p0, n = np * nt, steps = (n + 1) / 2;
  int xj = 0;
  float xr[32], acc[32];
  // consumer 0 takes the first turn on the tensor cores
  if (w == 1) Ring<NP>::turn_end(w);

  // ---- pass 1: kernel B (x3 in place), then the row sums of x3 ----
  {
    float rq[16], rk[16], rkv[16];
    float* rowsum_b = rowsum + (size_t)b * P * NC * 3 * D;
    for (int s = 0; s < steps; ++s) {
      const int i = 2 * s + w;
      if (i >= n) {
        ring.skip(PASS1_TURNS, w, ln.leader);
        continue;
      }
      const int p = p0 + i / nt, t = i % nt, l0 = t * FT, nv = min(FT, L - l0);
      if (i < nt * (i / nt) + 2) {  // this warpgroup's first tile of row p
#pragma unroll
        for (int c = 0; c < 16; ++c) rq[c] = rk[c] = rkv[c] = 0.f;
      }
      take_x(ln, S, w, xj, xr, nv);
      body_b_wg<NP, GELU>(ln, bar, ring, xr, hs, bw, stats_b, l0, nv, n_pairs, eps);
      store_x(ln, xr, x_b + ((size_t)p * L + l0) * D, nv);
      ln_to_a<NP>(ln, bar, xr, hs, rw + R_LNS, rw + R_LNB, eps);
      float m[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.r0 + 8 * h;
        m[h] = r < nv ? smask_b[l0 + r] : 0.f;
      }
      product(ln, ring, acc, hsa);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bq = rw[R_BQ + ln.col(j) + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) rq[2 * j + e] += phi_f(acc[4 * j + 2 * h + e] + bq) * m[h];
        }
      {
        float av[32];
        product_kv(ln, ring, acc, av, hsa);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = ln.col(j) + e;
            const float bk = rw[R_BK + c], bv = rw[R_BV + c];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float k = phi_f(acc[4 * j + 2 * h + e] + bk) * m[h];
              rk[2 * j + e] += k;
              rkv[2 * j + e] += k * (av[4 * j + 2 * h + e] + bv);
            }
          }
      }
      if (i + 2 >= n || (i + 2) / nt != i / nt) {
        // this warpgroup's last tile of row p: its sums over the warp's rows
        // (shuffles), then over the 4 warps in order, into its slot
#pragma unroll
        for (int c = 0; c < 16; ++c)
#pragma unroll
          for (int o = 4; o < 32; o <<= 1) {
            rq[c] += __shfl_xor_sync(0xffffffffu, rq[c], o);
            rk[c] += __shfl_xor_sync(0xffffffffu, rk[c], o);
            rkv[c] += __shfl_xor_sync(0xffffffffu, rkv[c], o);
          }
        if (ln.g == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int c = ln.col(j) + e;
              S.red[w][ln.warp][c] = rq[2 * j + e];
              S.red[w][ln.warp][D + c] = rk[2 * j + e];
              S.red[w][ln.warp][2 * D + c] = rkv[2 * j + e];
            }
        }
        bar_sync<WGT>(bar);
        float* dst = rowsum_b + ((size_t)p * NC + w) * 3 * D;
        for (int k = ln.ltid; k < 3 * D; k += WGT)
          dst[k] = ((S.red[w][0][k] + S.red[w][1][k]) + S.red[w][2][k]) + S.red[w][3][k];
        bar_sync<WGT>(bar);
      }
    }
    if (nt == 1) {
      // one tile a row: the other consumer's rows hold nothing of this one
      for (int p = p0 + 1 - w; p < p1; p += 2)
        for (int k = ln.ltid; k < 3 * D; k += WGT) rowsum_b[((size_t)p * NC + w) * 3 * D + k] = 0.f;
    }
    // x3 and the row sums of every pair written: the second pass reads them
    // (x3 through the producer's bulk copies)
    asm volatile("fence.proxy.async;" ::: "memory");
    bar_sync<NC * WGT>(BAR_BOTH);
    if (ln.w == 0 && ln.leader) mbar_arrive(&S.pass1);
  }

  // ---- pass 2: row attention out (x1 in place), then the column stats ----
  {
    float ck[32], cq[32], ckv[32];
    const float* rowsum_b = rowsum + (size_t)b * P * NC * 3 * D;
    const float* pmask_b = pmask + (size_t)b * P;
    float* part = partial + (((size_t)b * G + blockIdx.x) * NC + w) * L * 3 * D;
    for (int s = 0; s < steps; ++s) {
      const int i = 2 * s + w;
      if (i >= n) {
        ring.skip(PASS2_TURNS, w, ln.leader);
        continue;
      }
      const int t = i / np, p = p0 + i % np, l0 = t * FT, nv = min(FT, L - l0);
      if (i - 2 < t * np) {  // this consumer's first pair of tile t
#pragma unroll
        for (int k = 0; k < 32; ++k) ck[k] = cq[k] = ckv[k] = 0.f;
      }
      take_x(ln, S, w, xj, xr, nv);
      ln_to_a<NP>(ln, bar, xr, hs, rw + R_LNS, rw + R_LNB, eps);
      // the pair's q-mean and ctx from both row-sum slots, read while q is
      // on the tensor cores
      issue_product(ln, ring, acc, hsa);
      if (ln.ltid < D) {
        const int c = ln.ltid;
        const float* rs = rowsum_b + (size_t)p * NC * 3 * D;
        const float sq = rs[c] + rs[3 * D + c], sk = rs[D + c] + rs[4 * D + c];
        const float skv = rs[2 * D + c] + rs[5 * D + c];
        const float q = sq / S.count;
        S.qm[w][c] = q > 0.f ? q : 1.f;
        S.ctx[w][c] = skv / (sk > 0.f ? sk : 1.f);
      }
      finish_product(ln, ring, acc);
      bar_sync<WGT>(bar);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ln.r0 + 8 * h;
        const float m = r < nv ? smask_b[l0 + r] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = ln.col(j);
          float out[2];
#pragma unroll
          for (int e = 0; e < 2; ++e)
            out[e] = (phi_f(acc[4 * j + 2 * h + e] + rw[R_BQ + c + e]) * m / S.qm[w][c + e]) *
                     S.ctx[w][c + e];
          put_split<NP>(hs, ln.a_index(r, c), out[0], out[1]);
        }
      }
      fence_async_shared();
      bar_sync<WGT>(bar);
      product(ln, ring, acc, hsa);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bo = ld2(rw + R_BO + ln.col(j));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          xr[4 * j + 2 * h] += acc[4 * j + 2 * h] + bo.x;  // x1
          xr[4 * j + 2 * h + 1] += acc[4 * j + 2 * h + 1] + bo.y;
        }
      }
      store_x(ln, xr, x_b + ((size_t)p * L + l0) * D, nv);
      ln_to_a<NP>(ln, bar, xr, hs, cw + C_LNS, cw + C_LNB, eps);
      const float pm = pmask_b[p];
      product(ln, ring, acc, hsa);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bq = cw[C_BQ + ln.col(j) + e];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            cq[4 * j + 2 * h + e] += phi_f(acc[4 * j + 2 * h + e] + bq) * pm;
        }
      {
        float ak[32], av[32];
        product_kv(ln, ring, ak, av, hsa);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = ln.col(j) + e;
            const float bk = cw[C_BK + c], bv = cw[C_BV + c];
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int k = 4 * j + 2 * h + e;
              const float kc = phi_f(ak[k] + bk) * pm;
              ck[k] += kc;
              ckv[k] += kc * (av[k] + bv);
            }
          }
      }
      if (i + 2 >= n || (i + 2) / np != t) {
        // this consumer's last pair of tile t: its column sums into its slot
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ln.r0 + 8 * h;
          if (r < nv) {
            float* pp = part + (size_t)(l0 + r) * 3 * D;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const int c = ln.col(j), k = 4 * j + 2 * h;
              st2(pp + c, ck[k], ck[k + 1]);
              st2(pp + D + c, cq[k], cq[k + 1]);
              st2(pp + 2 * D + c, ckv[k], ckv[k + 1]);
            }
          }
        }
      }
    }
    if (np == 1) {
      // one pair: the other consumer's tiles hold nothing of this one
      for (int t = 1 - w; t < nt; t += 2) {
        const int l0 = t * FT, nv = min(FT, L - l0);
        for (int k = ln.ltid; k < nv * 3 * D; k += WGT) part[(size_t)l0 * 3 * D + k] = 0.f;
      }
    }
  }
  // the last turn consumer 1 handed over
  if (w == 0) Ring<NP>::turn_begin(w);
}

template <int GELU, int NP>
__global__ void __launch_bounds__(NTM, 1) kernel_m(
    float* x, const float* __restrict__ stats, const float* __restrict__ smask,
    const float* __restrict__ pmask, const float* __restrict__ pair_count,
    const float* __restrict__ bw, const float* __restrict__ bg, const float* __restrict__ rw,
    const float* __restrict__ rg, const float* __restrict__ cw, const float* __restrict__ cg,
    float* rowsum, float* partial, int P, int L, int G, float eps) {
  extern __shared__ float4 smem_raw[];
  SmemM& S = *reinterpret_cast<SmemM*>(smem_raw);
  const int b = blockIdx.y, tid = threadIdx.x;
  int p0, p1;
  split_range(blockIdx.x, P, G, p0, p1);
  const float* smask_b = smask + (size_t)b * L;
  float* x_b = x + (size_t)b * P * L * D;

  if (tid == 0) {
    for (int q = 0; q < 6; ++q) {
      mbar_init(&S.full[q], 1);
      mbar_init(&S.empty[q], NC);
    }
    for (int c = 0; c < NC; ++c) {
      mbar_init(&S.xfull[c], 1);
      mbar_init(&S.xempty[c], WGT);
    }
    mbar_init(&S.pass1, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the site count, summed as block_sum sums it (256 threads, 8 warps in order)
  {
    float v = 0.f;
    if (tid < NT)
      for (int l = tid; l < L; l += NT) v += smask_b[l];
    v = warp_sum(v);
    if ((tid & 31) == 0) S.wsum[tid >> 5] = v;
    __syncthreads();
    if (tid == 0) {
      float total = 0.f;
      for (int k = 0; k < NT / 32; ++k) total += S.wsum[k];
      S.count = fmaxf(total, 1.f);
    }
    __syncthreads();
  }
  const Lane ln;
  if (ln.w == NC) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (ln.ltid == 0) produce<NP>(S, x_b, bg, rg, cg, p0, p1, L);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    consume<GELU, NP>(ln, S, x_b, stats, smask_b, pmask, pair_count, bw, rw, cw, rowsum, partial,
                      p0, p1, P, L, G, eps);
  }
}

}  // namespace wg
}  // namespace pf

using namespace pf;

extern "C" {

// Kernel M at fp32 storage: G blocks per batch element (at most the SM
// count over the grid), row sums (B, P, M_CONSUMERS, 3D), partials
// (B, G M_CONSUMERS, L, 3D); the weights' flat groups and their wgmma planes.
int pf_kernel_m(float* x, const float* stats, const float* smask, const float* pmask,
                const float* pair_count, const float* bw, const float* bg, const float* rw,
                const float* rg, const float* cw, const float* cg, float* rowsum,
                float* partial, int B, int P, int L, int G, float eps, int gelu, int passes,
                void* stream) {
  return with_variant(gelu, passes, STORE_F32, [&](auto g, auto np, auto) {
    constexpr int GE = std::decay_t<decltype(g)>::value, NP = std::decay_t<decltype(np)>::value;
    auto kernel = wg::kernel_m<GE, NP>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)sizeof(wg::SmemM));
    if (e != cudaSuccess) return (int)e;
    kernel<<<dim3(G, B), wg::NTM, sizeof(wg::SmemM), (cudaStream_t)stream>>>(
        x, stats, smask, pmask, pair_count, bw, bg, rw, rg, cw, cg, rowsum, partial, P, L, G,
        eps);
    return (int)cudaGetLastError();
  });
}

}  // extern "C"
