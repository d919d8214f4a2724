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

#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

using namespace sm90;

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
    mbar_init_fence();
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
