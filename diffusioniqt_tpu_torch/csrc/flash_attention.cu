// Flash attention forward on Hopper: out = softmax(Q K^T * scale) V.
//
// Replaces diffusioniqt_tpu/ops/pallas/flash_attention.py::flash_attention
// (its _fa_kernel).
//   q   (B, Nq, D)  bf16, contiguous, B = batch * heads
//   k,v (B, Nk, D)  bf16, contiguous
//   out (B, Nq, D)  bf16
// D is 32, 64 or 128 (one template instance each).
//
// Semantics kept from the Pallas kernel: fp32 scores, running max, running
// sum and accumulator; kv columns >= Nk get the finite mask value
// -0.7 * FLT_MAX (not -inf); the probabilities are rounded to bf16 before
// the P V product while the running sum adds them in fp32; a row whose sum
// is 0 divides by 1; query rows >= Nq are not stored.
//
// Bound: operations. The two products are 4 * B * Nq * Nk * D FLOP against
// reading q, k, v and writing out once: at the main path's (64, 1728, 64)
// that is about 860 FLOP per byte, above the H100's ~295; the
// B * Nq * Nk exponentials on the SFUs cost about as much as the products
// at D = 64. Design (FlashAttention-3 shape):
//   * one CTA per (b, query tile of 64 * NWG rows): warpgroup 0 is the
//     producer (one thread issues every TMA load), the NWG consumer
//     warpgroups own 64 query rows each, NWG = 3 for D <= 64 and 2 for
//     D = 128 (whose O accumulator takes 64 registers a thread);
//     setmaxnreg moves registers from the producer to the consumers;
//   * TMA loads Q once and 128-row K and V tiles into a ring of STAGES
//     stages, each with its own "full" mbarrier for K and for V and one
//     "empty" mbarrier that the consumers arrive on when the stage is free.
//     A 3-D tensor map (D, N, B) makes rows past N zeros, never the next
//     head's rows. Tiles are stored as the TMA swizzle leaves them (128 B
//     rows, or 64 B at D = 32; D = 128 as two 64-column halves) and the
//     wgmma descriptors name the same swizzle;
//   * S = Q K^T is wgmma m64n128k16 with both operands in shared memory
//     (K stored (N, D) is K-major for B); O += P V is wgmma m64nDk16 with
//     P from registers as bf16 A fragments and V read MN-major;
//   * each consumer issues S of the next tile and P V of this one as two
//     commit groups, runs the next tile's softmax while P V is still on
//     the tensor cores, and repacks P once P V is done; with three
//     consumers the tensor cores always have another warpgroup's products
//     queued (named-barrier ping-pong between them measured no gain and
//     is left out);
//   * exponentials are ex2.approx of scores times scale * log2(e), the
//     scale folded into one FMA per score (the wrapper requires scale > 0).

#include <cuda.h>  // CUtensorMap and its enums only: libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BN = 128;  // kv rows per tile
constexpr float MASK_VALUE = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Cfg {
  // consumer warpgroups of 64 query rows each; D = 128 keeps 64 fp32
  // accumulator registers per thread for O and needs the larger budget
  static constexpr int NWG = D == 128 ? 2 : 3;
  static constexpr int BM = 64 * NWG;              // query rows per CTA
  static constexpr int THREADS = 128 * (NWG + 1);  // + the producer warpgroup
  static constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 160;  // setmaxnreg budgets:
  static constexpr int PRODUCER_REGS = 24;  // NWG*128*CONSUMER + 128*PRODUCER <= 64K
  static constexpr int SW = D == 32 ? 64 : 128;  // swizzle span = bytes per smem row
  static constexpr int COLS = SW / 2;            // bf16 per smem row (one TMA box row)
  static constexpr int PARTS = D / COLS;         // column parts per tile: 1, 1 or 2
  static constexpr int STAGES = 3;  // D = 128: 224 KB of the 227 KB a block may use
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int TILE_BYTES = BN * D * 2;  // one K or one V tile
  static constexpr uint64_t LAYOUT = D == 32 ? 2 : 1;  // wgmma descriptor: B64 / B128
  static constexpr int SMEM = 1024 + Q_BYTES + 2 * STAGES * TILE_BYTES;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers and TMA
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}
// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.b32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// ---- wgmma
// shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {  // at most N groups still running
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma window
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
// the same for A fragments that an asynchronous wgmma reads
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(r[i][e]) :: "memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory (both K-major)
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                               int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 32] += A[64 x 16] B[16 x 32], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}


template <int D>
__device__ __forceinline__ void wgmma_rs(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (D == 32) wgmma_rs_n32(o, a, db);
  else if constexpr (D == 64) wgmma_rs_n64(o, a, db);
  else wgmma_rs_n128(o, a, db);
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q K^T for this warpgroup's 64 rows and one 128-row K tile
template <int D>
__device__ __forceinline__ void gemm_qk(float (&s)[BN / 2], uint32_t q_base, uint32_t k_base) {
  using C = Cfg<D>;
  constexpr int KS = C::COLS / 16;  // k-steps per part
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk % KS) * 32;  // 16 bf16 along the swizzled row
    const uint64_t da =
        make_desc(q_base + (kk / KS) * C::BM * C::SW + off, 16, 8 * C::SW, C::LAYOUT);
    const uint64_t db = make_desc(k_base + (kk / KS) * BN * C::SW + off, 16, 8 * C::SW, C::LAYOUT);
    wgmma_ss_n128(s, da, db, kk > 0);
  }
}

// O += P V for one 128-row V tile; V (N, D) is MN-major for B: 8-row groups
// at 8 * SW bytes (SBO), column parts at BN * SW bytes (LBO)
template <int D>
__device__ __forceinline__ void gemm_pv(float (&o)[D / 2], const uint32_t (&p)[BN / 16][4],
                                        uint32_t v_base) {
  using C = Cfg<D>;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<D>(o, p[kk], make_desc(v_base + kk * 16 * C::SW, BN * C::SW, 8 * C::SW, C::LAYOUT));
}

// Online softmax of one score tile (columns col0 ... col0 + BN) in the
// wgmma accumulator layout: s[i] is row lane/4 + 8 * ((i/2) % 2) of this
// warp's 16, column (i/4) * 8 + 2 * (lane % 4) + i % 2. Leaves the
// unnormalised probabilities in s, updates the running max m (log2 domain)
// and the per-thread partial sums l, and returns in alpha the factor the
// accumulator must be scaled by. A full tile takes the max of the raw
// scores and folds the scale into one FMA per score (the scale is
// positive); the ragged last tile scales first and gives the columns >= nk
// the mask value, as the Pallas kernel does.
template <bool RAGGED>
__device__ __forceinline__ void softmax_tile(float (&s)[BN / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int col0, int nk,
                                             float scale_log2, int lane) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    if constexpr (RAGGED) {
      const bool in = col0 + (i / 4) * 8 + (lane % 4) * 2 + (i % 2) < nk;
      s[i] = in ? s[i] * scale_log2 : MASK_VALUE;
    }
    mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], s[i]);
  }
  const float sc = RAGGED ? 1.0f : scale_log2;  // s * sc is in the log2 domain
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_next = fmaxf(m[h], mx[h] * sc);
    alpha[h] = fast_exp2(m[h] - m_next);  // 0 on the first tile
    m[h] = m_next;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const float pv = fast_exp2(fmaf(s[i], sc, -m[(i / 2) % 2]));
    s[i] = pv;
    l[(i / 2) % 2] += pv;
  }
}

// probabilities -> bf16 A fragments of P V: k-block kk is score columns
// 16 kk ... 16 kk + 15
__device__ __forceinline__ void pack_p(const float (&s)[BN / 2], uint32_t (&p)[BN / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(Cfg<D>::THREADS, 1)
flash_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
             const __grid_constant__ CUtensorMap vmap, __nv_bfloat16* __restrict__ out,
             int nq, int nk, float scale_log2) {
  using C = Cfg<D>;
  constexpr int ST = C::STAGES;
  constexpr int BM = C::BM;
  constexpr int NWG = C::NWG;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t k_s = q_s + C::Q_BYTES;                // ST tiles
  const uint32_t v_s = k_s + ST * C::TILE_BYTES;        // ST tiles
  __shared__ __align__(8) uint64_t bars[1 + 3 * ST];
  const uint32_t q_full = smem_addr(&bars[0]);
  auto full_k = [&](int st) { return smem_addr(&bars[1 + st]); };
  auto full_v = [&](int st) { return smem_addr(&bars[1 + ST + st]); };
  auto empty = [&](int st) { return smem_addr(&bars[1 + 2 * ST + st]); };

  const int qtiles = (nq + BM - 1) / BM;
  const int b = blockIdx.x / qtiles;  // neighbouring CTAs share one head's K, V in L2
  const int q0 = (blockIdx.x % qtiles) * BM;
  const int tiles = (nk + BN - 1) / BN;
  // warp-uniform for the compiler too (a shuffle of lane 0's value), so
  // the role branches below are not divergent paths around the wgmma
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), 128 * NWG);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::PRODUCER_REGS));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, C::Q_BYTES);
#pragma unroll
      for (int pt = 0; pt < C::PARTS; ++pt)
        tma_load_3d(q_s + pt * BM * C::SW, &qmap, q_full, pt * C::COLS, q0, b);
      for (int j = 0; j < tiles; ++j) {
        const int st = j % ST, round = j / ST;
        if (round > 0) mbar_wait(empty(st), (round - 1) & 1);
        mbar_expect_tx(full_k(st), C::TILE_BYTES);
#pragma unroll
        for (int pt = 0; pt < C::PARTS; ++pt)
          tma_load_3d(k_s + st * C::TILE_BYTES + pt * BN * C::SW, &kmap, full_k(st),
                      pt * C::COLS, j * BN, b);
        mbar_expect_tx(full_v(st), C::TILE_BYTES);
#pragma unroll
        for (int pt = 0; pt < C::PARTS; ++pt)
          tma_load_3d(v_s + st * C::TILE_BYTES + pt * BN * C::SW, &vmap, full_v(st),
                      pt * C::COLS, j * BN, b);
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
    const int w = wg - 1;  // rows [64 w, 64 w + 64) of the query tile
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    const uint32_t q_w = q_s + 64 * w * C::SW;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.0f;
    float s[BN / 2];
    uint32_t p[BN / 16][4];
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.0f, 0.0f};  // per-thread partial sums (a quad shares a row)
    float alpha[2];
    auto softmax = [&](int col0) {
      if (col0 + BN > nk) softmax_tile<true>(s, m, l, alpha, col0, nk, scale_log2, lane);
      else softmax_tile<false>(s, m, l, alpha, col0, nk, scale_log2, lane);
    };

    mbar_wait(q_full, 0);
    mbar_wait(full_k(0), 0);
    wgmma_fence();
    gemm_qk<D>(s, q_w, k_s);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    softmax(0);  // o is still zero: nothing to rescale
    pack_p(s, p);

    // One kv tile j: S of tile j + 1 (unless j is the last) and O += P V of
    // tile j, as two commit groups. The softmax of tile j + 1 runs while
    // P V is still on the tensor cores; O is rescaled and P repacked once
    // P V is done.
    auto step = [&](int j, auto has_next) {
      constexpr bool NEXT = decltype(has_next)::value;
      const int st = j % ST;
      if (NEXT) mbar_wait(full_k((j + 1) % ST), ((j + 1) / ST) & 1);
      mbar_wait(full_v(st), (j / ST) & 1);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      if constexpr (NEXT) {
        gemm_qk<D>(s, q_w, k_s + ((j + 1) % ST) * C::TILE_BYTES);
        wgmma_commit();
      }
      gemm_pv<D>(o, p, v_s + st * C::TILE_BYTES);
      wgmma_commit();
      if constexpr (NEXT) {
        wgmma_wait<1>();  // S of tile j + 1 has landed
        fence_regs(s);
        softmax((j + 1) * BN);
      }
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(p);
      mbar_arrive(empty(st));  // K tile j was read a step earlier, V tile j now
      if constexpr (NEXT) {
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
        pack_p(s, p);
      }
    };
    for (int j = 0; j + 1 < tiles; ++j) step(j, std::true_type{});
    step(tiles - 1, std::false_type{});

    // ---- epilogue: O / l, bf16, rows < nq only
    const int warp = t / 32;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float sum = l[h];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      const float inv = sum == 0.0f ? 1.0f : 1.0f / sum;
      const int row = q0 + 64 * w + 16 * warp + lane / 4 + 8 * h;
      if (row >= nq) continue;
      __nv_bfloat16* dst = out + ((long long)b * nq + row) * D + (lane % 4) * 2;
#pragma unroll
      for (int jn = 0; jn < D / 8; ++jn)
        *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) =
            __floats2bfloat162_rn(o[4 * jn + 2 * h] * inv, o[4 * jn + 2 * h + 1] * inv);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// 3-D map over (B, N, D) (innermost first: D, N, B) with a (COLS, rows, 1)
// box: rows past N are filled with zeros, never taken from the next head
template <int D>
bool make_map(EncodeTiled encode, CUtensorMap* map, const void* ptr, int b, int n, int rows) {
  using C = Cfg<D>;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)n, (cuuint64_t)b};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)n * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)C::COLS, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(EncodeTiled encode, const void* q, const void* k, const void* v, void* out, int b,
           int nq, int nk, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!make_map<D>(encode, &qmap, q, b, nq, C::BM) || !make_map<D>(encode, &kmap, k, b, nk, BN) ||
      !make_map<D>(encode, &vmap, v, b, nk, BN))
    return (int)cudaErrorInvalidValue;
  auto kernel = flash_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return (int)err;
  const long long ctas = (long long)b * ((nq + C::BM - 1) / C::BM);
  if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)ctas, C::THREADS, C::SMEM, stream>>>(qmap, kmap, vmap,
                                                       static_cast<__nv_bfloat16*>(out), nq,
                                                       nk, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched). ``encode`` is the CUDA driver's
// cuTensorMapEncodeTiled, looked up by the caller (the library does not
// link libcuda). The Python wrapper checks shapes, dtype, contiguity and
// 16-byte alignment; d outside {32, 64, 128} is refused here too.
extern "C" int flash_attention_launch(void* encode, const void* q, const void* k,
                                      const void* v, void* out, int b, int nq, int nk, int d,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  EncodeTiled enc = reinterpret_cast<EncodeTiled>(encode);
  if (enc == nullptr || b <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 32: return launch<32>(enc, q, k, v, out, b, nq, nk, scale, st);
    case 64: return launch<64>(enc, q, k, v, out, b, nq, nk, scale, st);
    case 128: return launch<128>(enc, q, k, v, out, b, nq, nk, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
