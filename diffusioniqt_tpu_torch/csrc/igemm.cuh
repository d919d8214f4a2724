// Implicit-GEMM VALID 3x3x3 convolution over halo'd sub-volumes on Hopper
// (wgmma + TMA), shared by conv3d.cu (the plain conv, Cin > 8) and
// fused_block.cu (the conv with a fused GroupNorm-affine + Mish prologue).
//
//   xh  (B, E, E, E, Cin) bf16, E = S + 2 (channels-last, halo included)
//   w   (27, Cin, Cout) bf16, tap = (kx*3+ky)*3+kz (no padding: the TMA
//       fills channels past Cin and columns past Cout with zeros)
//   out (B, S, S, S, Cout) bf16, fp32 accumulation
//
// As a matrix product: M = B * S^3 output voxels, N = Cout, K = 27 * Cin.
//
// Bound: operations, 2 * M * 27 * Cin * Cout FLOP (1.566 TFLOP, 1.583 ms
// at the main path's (216, 32^3, 64->64)) against reading xh once.
//
// What bound the old design (mma.sync, 8 warps, a 2x4x16 or 1x4x16 brick
// per block, Cin in 32-channel chunks; 14-16% of the bound):
//   1. both operands went through ldmatrix into mma.sync: 16 KB of shared
//      memory per 262 KFLOP, about 2x the tensor time at 128 B/clk;
//   2. a __syncthreads on every tap, with two k16 steps between;
//   3. the brick was loaded and put through Mish by all 256 threads while
//      no product was in flight;
//   4. 432 halo'd voxels per 128 outputs (3.4-5x halo overhead), and every
//      block streamed the whole weight (12 GB of L2 reads per launch at
//      (216, 32^3, 64->64));
//   5. Mish (two MUFU ops a value) ran on the same warps as the product.
//
// This design: persistent CTAs walk units of work (an output brick of TX x
// TY x TZ = 4 x 8 x 8 = 256 voxels of one sub-volume and BN output channels),
// each unit in 64-channel chunks (128-byte rows, 128-byte swizzle). The
// Python side picks a plan per launch (ops/kernels/fused_block.py::brick_plan)
// and passes its fields:
//   * BN = 32, 64 or 128 output channels per unit. 32 is the narrow unit of
//     the column shards (Cout 32 or 16 under tensor parallelism): its weight
//     slice has 64-byte rows (64-byte swizzle) and the products are wgmma
//     m64n32k16, so no columns past Cout rounded up to 32 are computed;
//   * TAP (BN <= 64, Cin % 8 == 0): the consumers commit a whole tap (8
//     wgmmas) per group instead of half of one, so that the products of a
//     group cover the next group's A gathers; the base unit (the flagship's
//     Cout-64 Blocks at levels 0 and 1, every BN = 128 unit) commits half;
//   * split: CTA c takes units c, c + ctas, ... whole, so neighbouring CTAs
//     run neighbouring bricks; with split only the rounds that fill the
//     card, and the units left over (the last round's) are cut into their
//     (unit, chunk) items, spread over all CTAs in contiguous ranges that
//     differ by at most one item (range_lo), so that the last round is not
//     left part full (at 8^3 x 128 channels, 432 units of 2 chunks on 132
//     CTAs: 3 whole units and at most one chunk a CTA, 7 chunks, not 8). A
//     range cuts at most its first and last units; each piece of a cut unit
//     goes out as fp32 sums into the CTA's slot of ws (0: the unit its range
//     starts in, 1: the one it ends in), and reduce_partials, launched
//     after, sums a cut unit's pieces in the order of the CTAs. The split
//     kernels are their own instantiations (SPLIT), so the whole-unit ones
//     carry none of this;
//   * ctas: the grid, at most one CTA per SM, at most one per unit (with
//     split, per item).
// Three roles, warp-specialised, 512 threads:
//   * warp 0: one thread issues the TMA loads of the tap weight slices
//     (64 channels x BN, a 3-D map over (27, Cin, Cout)) into an mbarrier
//     ring (Cfg::STAGES: 12 at BN = 32, 6 at 64, 3 at 128);
//   * warps 1-3 and 12-15 (transform): per unit and chunk, one thread
//     issues the TMA load of the raw halo'd brick (6 x 10 x 10 voxels x 64
//     channels, 76.8 KB; a 5-D map over (B, E, E, E, Cin) whose channels
//     past Cin are zeros) into one of two brick buffers; the seven warps
//     stage the sub-volume's A, B of the chunk in shared memory, apply
//     mish(A_r * x + B_r) in place with the region r of each voxel (FUSED;
//     Cfg::BATCH 16-byte groups in flight a thread) and hand the buffer to
//     the consumers. The next brick's load and Mish run while the consumers
//     multiply this one, on other warps, so the SFUs work beside the tensor
//     cores. Cin not a multiple of 8 (rows not 16-byte strided, which TMA
//     needs) takes plain loads here instead;
//   * warpgroups 1-2 (consumers): 128 output rows each (two m64 tiles, one
//     output x-plane of 8 x 8 each), 27 taps x 4 k16 steps per chunk as
//     wgmma m64nBNk16 with A from registers and B (the weight slice,
//     MN-major) read by the tensor core through a swizzled descriptor. A
//     tap is a row shift of the brick, so the A fragments are ldmatrix
//     gathers from it (no im2col); the 128-byte swizzle's XOR uses the
//     shifted brick row. Half a tap (2 k16 steps x 2 tiles; with TAP the
//     whole tap) is one commit group; the next group's ldmatrix runs while
//     this one is on the tensor cores, and a weight stage is released as
//     soon as its last group has finished. setmaxnreg moves registers from
//     warpgroups 0 and 3 to them.
// Seven transform warps, not three: with one warp a scheduler the Mish
// (about ten dependent instructions and two MUFU ops a value) could not
// hide its latency and set the kernel's pace.
// Shared memory: two bricks (153.6 KB), the weight ring (48 KB at every
// BN) and the sub-volume's A, B coefficients of the chunk (13.5 KB) per CTA.
// Operand traffic per k16 step and consumer: 4 KB of ldmatrix for A and
// 2 x BN x 32 B of B reads, against 2 x 64 x BN x 16 x 2 FLOP. The epilogue
// stores the fp32 accumulators as bf16 pairs straight from registers.
//
// FUSED: region r = (rx*3+ry)*3+rz of a halo'd voxel is, per axis, 0 on the
// low halo plane, 2 on the high one, 1 inside. A missing neighbour has
// A = B = 0, so the halo there is mish(0) = 0, the reference's zero
// padding; channels past Cin stay exactly 0. Mish uses the one-exp identity
// with the input clamped at 20, as the Pallas kernel does.
//
// Sub-volume edges 4 and 2 have no 4 x 8 x 8 brick; the fused Block runs
// there on its own kernel, fused_block_small.cu, which reuses the Mish
// prologue and the wgmma helpers below.
//
// A build with -DBRICK_TRACE (ops/kernels/brick_trace.py, never the port's
// own build) compiles in per-CTA phase stamps and two ablations (the A
// gathers, the Mish).
#pragma once

#include "sm90.cuh"


namespace igemm {

using namespace sm90;

// Phase stamps and ablations of the trace build: each CTA writes the card's
// %globaltimer at five points into g_trace[blockIdx.x * 8 + k] (read by
// ops/kernels/brick_trace.py). g_ablate bit 0: the consumers gather each
// chunk's A fragments for its first tap only and multiply the same
// registers on every tap; bit 1: the transform warps hand the raw brick on
// without the affine + Mish. Both give wrong sums: they time the kernel
// without that work. The port's own build compiles all of it to nothing.
#ifdef BRICK_TRACE
__device__ unsigned long long* g_trace;
__device__ int g_ablate;
#define BRICK_STAMP(k, cond)                                             \
  do {                                                                   \
    if ((cond) && g_trace) {                                             \
      unsigned long long now;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));            \
      g_trace[blockIdx.x * 8 + (k)] = now;                               \
    }                                                                    \
  } while (0)
#else
#define BRICK_STAMP(k, cond) do {} while (0)
#endif

constexpr int TX = 4, TY = 8, TZ = 8;     // output brick (x, y, z)
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;
constexpr int ROWS = HX * HY * HZ;        // 600 halo'd voxels
constexpr int KC = 64;                    // input channels per chunk: one 128-byte row
constexpr int BRICK_BYTES = ROWS * KC * 2;  // 76800 = 75 * 1024
constexpr int W_PART = KC * 64 * 2;       // one 64-column part of a weight slice
constexpr int TRANSFORM_THREADS = 224;    // warps 1-3 and 12-15
constexpr int THREADS = 512;

// the FUSED coefficients of one sub-volume and chunk, A and B, [27][64] fp32
constexpr int TAB_BYTES = 2 * 27 * KC * 4;

// shared memory from a 1024-byte aligned base: the two bricks, the weight
// ring (both 1024-byte aligned, as the swizzles need), the tables. TAP is
// the consumer layout of the plans beyond the base unit (BN <= 64): a whole
// tap (8 wgmmas) per commit group, not half of one, so that each group's
// products cover the next group's A gathers.
template <int BN, bool TAP = false>
struct Cfg {
  static_assert(!TAP || BN <= 64, "the tap layout is at most 64 wide");
  // setmaxnreg budgets: they move only the registers the CTA was launched
  // with, 512 * 128 = 65536 = 256 * CONSUMER_REGS + 256 * OTHER_REGS
  // (BN = 128: the 128 accumulators and two A fragment sets need 200, and
  // the transform then keeps two 16-byte groups in flight, not four; BN =
  // 32: 32 accumulators, so the transform keeps more registers)
  static constexpr int CONSUMER_REGS = BN == 32 ? 152 : (BN == 64 ? 160 : 200);
  static constexpr int OTHER_REGS = BN == 32 ? 104 : (BN == 64 ? 96 : 56);
  static constexpr int BATCH = BN == 128 ? 2 : 4;  // transform groups in flight a thread
  static constexpr int KS = TAP ? 4 : 2;           // k16 steps per commit group
  // a weight slice is 64 K rows of BN columns: 128-byte rows in 64-column
  // parts W_PART apart (128-byte swizzle), or at BN = 32 one part of
  // 64-byte rows (64-byte swizzle)
  static constexpr int ROW_BYTES = BN == 32 ? 64 : 128;
  static constexpr int PARTS = BN == 32 ? 1 : BN / 64;
  static constexpr int STAGES = BN == 32 ? 12 : (BN == 64 ? 6 : 3);
  static constexpr int STAGE_BYTES = KC * BN * 2;
  static constexpr int TAB_OFFSET = 2 * BRICK_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + TAB_OFFSET + TAB_BYTES;
  static_assert(SMEM <= 227 * 1024 - 256, "shared memory");
};

struct Params {
  const __nv_bfloat16* xh;  // read directly only when Cin % 8 != 0
  const float* a_tab;       // (B, 27, Cin), FUSED only
  const float* b_tab;
  __nv_bfloat16* out;
  float* ws;    // (ctas, 2, 256, BN) fp32: the CTAs' pieces of cut units, SPLIT only
  int nb, s, cin, cout;
  int nchunks;  // ceil(Cin / 64)
  int units;    // B * bricks per sub-volume * ceil(Cout / BN)
};

// With split, the first of the tail items that CTA c's range holds: items *
// c / ctas (items < units * nchunks < 2^31, so the product fits in 64 bits)
__host__ __device__ __forceinline__ int range_lo(int items, int ctas, int c) {
  return (int)((long long)items * c / ctas);
}

__device__ __forceinline__ float mish1(float v) {
  const float u = __expf(fminf(v, 20.0f));
  const float t = u * (u + 2.0f);
  return __fdividef(v * t, t + 2.0f);
}

__device__ __forceinline__ int region(int p, int e) {
  return p == 0 ? 0 : (p == e - 1 ? 2 : 1);
}

// 8 bf16 values of channels [c, c+8) -> mish(a * x + b), 8 bf16
__device__ __forceinline__ uint4 affine_mish8(uint4 raw, const float* ap, const float* bp) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float4 a = reinterpret_cast<const float4*>(ap)[q];
    const float4 b = reinterpret_cast<const float4*>(bp)[q];
    const float2 f0 = __bfloat1622float2(h[2 * q]);
    const float2 f1 = __bfloat1622float2(h[2 * q + 1]);
    o[2 * q] = __floats2bfloat162_rn(mish1(fmaf(a.x, f0.x, b.x)), mish1(fmaf(a.y, f0.y, b.y)));
    o[2 * q + 1] =
        __floats2bfloat162_rn(mish1(fmaf(a.z, f1.x, b.z)), mish1(fmaf(a.w, f1.y, b.w)));
  }
  return res;
}

// keeps the A fragments of half a tap live until its wgmma has finished
__device__ __forceinline__ void fence_frags(uint32_t (&f)[2][2][4]) {
  fence_regs(f[0]);
  fence_regs(f[1]);
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (BN == 32) wgmma_rs_n32(d, a, db);
  else if constexpr (BN == 64) wgmma_rs_n64(d, a, db);
  else wgmma_rs_n128(d, a, db);
}

// The unit u -> n tile, sub-volume, brick origin. Units run n tile by n
// tile, then sub-volume by sub-volume, bricks in x, y, z order, so the CTAs
// in flight share one weight and neighbouring bricks in L2.
struct Unit {
  int nt, b, x0, y0, z0;
  __device__ __forceinline__ Unit(int u, int nb, int s) {
    const int by = s / TY, bz = s / TZ;
    const int per_sub = (s / TX) * by * bz;
    nt = u / (nb * per_sub);
    int r = u % (nb * per_sub);
    b = r / per_sub;
    r %= per_sub;
    x0 = (r / (by * bz)) * TX;
    y0 = ((r / bz) % by) * TY;
    z0 = (r % bz) * TZ;
  }
};

// This CTA's pieces of work, k = 0 .. count - 1: unit(k) and its chunks
// [chunk_lo(k), chunk_hi(k)). Units blockIdx.x, blockIdx.x + ctas, ...
// whole; with SPLIT only the rounds that fill the card (units below tail0 =
// ctas * floor(units / ctas)), and then this CTA's range [lo, hi) of the
// remaining units' (unit, chunk) items (tail items, range_lo).
template <bool SPLIT>
struct Walk {
  int count, whole, tail0, lo, hi, nch, c, ctas;
  __device__ __forceinline__ explicit Walk(const Params& p)
      : nch(p.nchunks), c((int)blockIdx.x), ctas((int)gridDim.x) {
    if constexpr (SPLIT) {
      whole = p.units / ctas;
      tail0 = whole * ctas;
      const int items = (p.units - tail0) * nch;
      lo = range_lo(items, ctas, c);
      hi = range_lo(items, ctas, c + 1);
      count = whole + (hi > lo ? (hi - 1) / nch - lo / nch + 1 : 0);
    } else {
      whole = count = (p.units - c + ctas - 1) / ctas;
    }
  }
  // the tail unit of piece k (k >= whole), counted from tail0
  __device__ __forceinline__ int tail_unit(int k) const { return lo / nch + k - whole; }
  __device__ __forceinline__ int unit(int k) const {
    if constexpr (SPLIT)
      if (k >= whole) return tail0 + tail_unit(k);
    return c + k * ctas;
  }
  __device__ __forceinline__ int chunk_lo(int k) const {
    if constexpr (SPLIT)
      if (k >= whole) return max(lo - tail_unit(k) * nch, 0);
    return 0;
  }
  __device__ __forceinline__ int chunk_hi(int k) const {
    if constexpr (SPLIT)
      if (k >= whole) return min(hi - tail_unit(k) * nch, nch);
    return nch;
  }
};

template <bool FUSED, bool TMA_A, int BN, bool TAP, bool SPLIT>
__global__ void __launch_bounds__(THREADS, 1)
conv_sm90(const Params p, const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap wmap) {
  using C = Cfg<BN, TAP>;
  constexpr int ST = C::STAGES, KS = C::KS, NT = TRANSFORM_THREADS;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw_addr);
  const uint32_t w_s = base + 2 * BRICK_BYTES;
  __shared__ __align__(8) uint64_t bars[2 * ST + 6];
  auto full_w = [&](int st) { return smem_addr(&bars[st]); };
  auto empty_w = [&](int st) { return smem_addr(&bars[ST + st]); };
  auto raw_full = [&](int buf) { return smem_addr(&bars[2 * ST + buf]); };
  auto ready = [&](int buf) { return smem_addr(&bars[2 * ST + 2 + buf]); };
  auto brick_empty = [&](int buf) { return smem_addr(&bars[2 * ST + 4 + buf]); };

  const int S = p.s, E = S + 2, cin = p.cin;
  const Walk<SPLIT> wk(p);
  // warp-uniform for the compiler too, so the role branches are not
  // divergent paths around the wgmma
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_w(st), 1);
      mbar_init(empty_w(st), 256);  // every consumer thread
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(raw_full(buf), 1);
      mbar_init(ready(buf), NT);
      mbar_init(brick_empty(buf), 256);
    }
    mbar_init_fence();
  }
  __syncthreads();
  BRICK_STAMP(0, threadIdx.x == 0);  // start

  if (wg == 0 || wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::OTHER_REGS));
    // transform thread, 0 ... 223: warps 1-3, then warpgroup 3
    const int t = wg == 0 ? (int)threadIdx.x - 32 : (int)threadIdx.x - 384 + 96;
    if (threadIdx.x == 0) {
      // ------------------------------------------------ weight producer
      int g = 0;
      for (int k = 0; k < wk.count; ++k) {
        const Unit un(wk.unit(k), p.nb, S);
        for (int chunk = wk.chunk_lo(k); chunk < wk.chunk_hi(k); ++chunk)
          for (int tap = 0; tap < 27; ++tap, ++g) {
            const int st = g % ST, round = g / ST;
            if (round > 0) mbar_wait(empty_w(st), (round - 1) & 1);
            mbar_expect_tx(full_w(st), C::STAGE_BYTES);
#pragma unroll
            for (int part = 0; part < C::PARTS; ++part)
              tma_load_3d(w_s + st * C::STAGE_BYTES + part * W_PART, &wmap, full_w(st),
                          un.nt * BN + part * 64, chunk * KC, tap);
          }
      }
    } else if (t >= 0) {
      // ------------------------------------------------------ transform
      float* tab_a = reinterpret_cast<float*>(base_ptr + C::TAB_OFFSET);  // [27][64]
      float* tab_b = tab_a + 27 * KC;
      int item = 0;
      for (int k = 0; k < wk.count; ++k) {
        const Unit un(wk.unit(k), p.nb, S);
        for (int chunk = wk.chunk_lo(k); chunk < wk.chunk_hi(k); ++chunk, ++item) {
          const int buf = item & 1, use = item >> 1;
          if (use > 0) mbar_wait(brick_empty(buf), (use - 1) & 1);
          unsigned char* bp = base_ptr + buf * BRICK_BYTES;
          const int c_base = chunk * KC;
          if (TMA_A && t == 0) {
            mbar_expect_tx(raw_full(buf), BRICK_BYTES);
            tma_load_5d(base + buf * BRICK_BYTES, &xmap, raw_full(buf), c_base, un.z0, un.y0,
                        un.x0, un.b);
          }
          if constexpr (FUSED) {
            // this sub-volume's coefficients of the chunk's channels -> shared
            // memory, [region][channel]; entries past Cin are never read
            named_bar_sync(1, NT);  // the previous chunk is done with them
            const long long t0 = (long long)un.b * 27 * cin + c_base;
            if constexpr (TMA_A) {  // Cin % 8 == 0: 16-byte copies, all in flight
              for (int id = t; id < 2 * 27 * (KC / 4); id += NT) {
                const int tab = id / (27 * (KC / 4)), r = (id / (KC / 4)) % 27, q = id % (KC / 4);
                const bool in = c_base + 4 * q < cin;
                const float* src = (tab ? p.b_tab : p.a_tab) + t0 + r * cin + 4 * q;
                cp_async16(smem_addr(tab_a + tab * 27 * KC + r * KC + 4 * q), in ? src : p.a_tab,
                           in ? 16 : 0);
              }
              cp_async_commit();
              cp_async_wait_all();
            } else {
              for (int id = t; id < 27 * KC; id += NT) {
                const int r = id / KC, c = id % KC;
                const bool in = c_base + c < cin;
                tab_a[id] = in ? p.a_tab[t0 + r * cin + c] : 0.0f;
                tab_b[id] = in ? p.b_tab[t0 + r * cin + c] : 0.0f;
              }
            }
            named_bar_sync(1, NT);
          }
          if constexpr (TMA_A) mbar_wait(raw_full(buf), use & 1);
          BRICK_STAMP(1, t == 0 && item == 0);  // the first brick has landed
          if (FUSED || !TMA_A) {
            // 16-byte groups of 8 channels, BATCH per thread in flight; group
            // pc of row r holds channels 8 (pc ^ (r & 7)) of the chunk
            // (128-byte swizzle)
            constexpr int BATCH = C::BATCH;
            for (int id0 = t; id0 < ROWS * 8; id0 += BATCH * NT) {
              uint4 v[BATCH];
#pragma unroll
              for (int q = 0; q < BATCH; ++q) {
                const int id = id0 + q * NT;
                if (id >= ROWS * 8) break;
                const int row = id >> 3, pc = id & 7;
                const int c = c_base + 8 * (pc ^ (row & 7));
                if constexpr (TMA_A) {
                  v[q] = *reinterpret_cast<const uint4*>(bp + row * 128 + pc * 16);
                } else {
                  v[q] = make_uint4(0u, 0u, 0u, 0u);
                  __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[q]);
                  const int hz = row % HZ, hy = (row / HZ) % HY, hx = row / (HZ * HY);
                  const long long g =
                      ((((long long)un.b * E + un.x0 + hx) * E + un.y0 + hy) * E + un.z0 + hz) *
                          cin + c;
#pragma unroll
                  for (int j = 0; j < 8; ++j)
                    if (c + j < cin) e[j] = p.xh[g + j];
                }
              }
#pragma unroll
              for (int q = 0; q < BATCH; ++q) {
                const int id = id0 + q * NT;
                if (id >= ROWS * 8) break;
                const int row = id >> 3, pc = id & 7;
                const int j8 = 8 * (pc ^ (row & 7));
                uint4 val = v[q];
                if constexpr (FUSED) {
                  bool in = c_base + j8 < cin;
#ifdef BRICK_TRACE
                  in = in && !(g_ablate & 2);  // the raw brick, stored back as it is
#endif
                  if (in) {
                    const int hz = row % HZ, hy = (row / HZ) % HY, hx = row / (HZ * HY);
                    const int r = (region(un.x0 + hx, E) * 3 + region(un.y0 + hy, E)) * 3 +
                                  region(un.z0 + hz, E);
                    val = affine_mish8(val, tab_a + r * KC + j8, tab_b + r * KC + j8);
                  }
                }
                *reinterpret_cast<uint4*>(bp + row * 128 + pc * 16) = val;
              }
            }
          }
          fence_proxy_async();  // before a later TMA load refills this buffer
          mbar_arrive(ready(buf));
        }
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
    const int cw = wg - 1;  // output x-planes 2 cw, 2 cw + 1 of the brick
    const int t = threadIdx.x % 128;
    const int warp = t / 32, lane = t % 32;
    // ldmatrix: lane l gives the address of row l % 16 of its warp's 16
    // rows (y = 2 warp + (l % 16) / 8, z = l % 8) at k offset 8 (l / 16)
    int row0[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      row0[i] = ((2 * cw + i) * HY + 2 * warp + (lane % 16) / 8) * HZ + lane % 8;
    const int khalf = lane / 16;
#ifdef BRICK_TRACE
    const int ablate = g_ablate;
#endif

    float acc[2][BN / 2];
    // A fragments: [buffer][m tile][k16 step][fragment]; a commit group is
    // KS k16 steps of a tap (half of it, or with TAP all of it)
    uint32_t a[2][2][KS][4];

    // A fragments of k16 steps [k0, k0 + KS) of one tap
    auto load_a = [&](uint32_t (&frag)[2][KS][4], uint32_t brick, int tap, int k0) {
#ifdef BRICK_TRACE
      if ((ablate & 1) && tap > 0) return;  // the first tap's gathers, multiplied again
#endif
      const int kx = tap / 9, ky = (tap / 3) % 3, kz = tap % 3;
      const int toff = (kx * HY + ky) * HZ + kz;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0[i] + toff;
#pragma unroll
        for (int k2 = 0; k2 < KS; ++k2) {
          const int chunk16 = (k0 + k2) * 2 + khalf;
          ldmatrix_x4(frag[i][k2], brick + r * 128 + ((chunk16 ^ (r & 7)) << 4));
        }
      }
    };
    // B of k16 step kk: 16 rows of the weight slice (MN-major: at BN >= 64
    // 64-column parts W_PART apart, 8-row groups 1024 B apart, 128-byte
    // swizzle; at BN = 32 one part, 8-row groups 512 B apart, 64-byte swizzle)
    auto mma = [&](const uint32_t (&frag)[2][KS][4], uint32_t wst, int k0) {
#pragma unroll
      for (int k2 = 0; k2 < KS; ++k2) {
        const uint32_t kb = wst + (k0 + k2) * 16 * C::ROW_BYTES;
        const uint64_t db = BN == 32 ? make_desc(kb, C::STAGE_BYTES, 512, 2)
                                     : make_desc(kb, W_PART, 1024, 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) wgmma_rs<BN>(acc[i], frag[i][k2], db);
      }
    };
    auto fence_a = [&](uint32_t (&f)[2][KS][4]) {
      fence_regs(f[0]);
      fence_regs(f[1]);
    };
    // a stage is free once every consumer thread is done with it
    auto release = [&](int st) { mbar_arrive(empty_w(st)); };

    int g = 0, item = 0;
    for (int k = 0; k < wk.count; ++k) {
      const Unit un(wk.unit(k), p.nb, S);
      const int c_lo = wk.chunk_lo(k), c_hi = wk.chunk_hi(k);
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[m][j] = 0.0f;
        fence_regs(acc[m]);
      }
      for (int chunk = c_lo; chunk < c_hi; ++chunk, ++item) {
        const int buf = item & 1;
        mbar_wait(ready(buf), (item >> 1) & 1);
        BRICK_STAMP(2, t == 0 && cw == 0 && item == 0);  // the first products start
        const uint32_t brick = base + buf * BRICK_BYTES;
        if constexpr (TAP) {
          // one tap a commit group; the next tap's gathers run while this
          // one is on the tensor cores. Taps in pairs, so that both
          // fragment buffers are named statically (a run-time index would
          // put them in local memory)
          auto tap_group = [&](uint32_t (&cur)[2][KS][4], uint32_t (&nxt)[2][KS][4],
                               int tap) {
            const int gs = g + tap;
            const int st = gs % ST;
            mbar_wait(full_w(st), (gs / ST) & 1);
            wgmma_fence();
            mma(cur, w_s + st * C::STAGE_BYTES, 0);
            wgmma_commit();
            wgmma_wait<1>();  // the previous tap is done
            fence_a(nxt);
            if (tap > 0) release((gs - 1) % ST);
            if (tap < 26) load_a(nxt, brick, tap + 1, 0);
          };
          load_a(a[0], brick, 0, 0);
          for (int tap = 0; tap < 27; tap += 2) {
            tap_group(a[0], a[1], tap);
            if (tap < 26) tap_group(a[1], a[0], tap + 1);
          }
          wgmma_wait<0>();
          fence_a(a[0]);
        } else {
          load_a(a[0], brick, 0, 0);
          for (int tap = 0; tap < 27; ++tap) {
            const int gs = g + tap;
            const int st = gs % ST;
            mbar_wait(full_w(st), (gs / ST) & 1);
            const uint32_t wst = w_s + st * C::STAGE_BYTES;
            wgmma_fence();
            mma(a[0], wst, 0);
            wgmma_commit();
            wgmma_wait<1>();  // the previous tap's second half is done
            fence_a(a[1]);
            if (tap > 0) release((gs - 1) % ST);
            load_a(a[1], brick, tap, 2);
            wgmma_fence();
            mma(a[1], wst, 2);
            wgmma_commit();
            wgmma_wait<1>();  // this tap's first half is done
            fence_a(a[0]);
            if (tap < 26) load_a(a[0], brick, tap + 1, 0);
          }
          wgmma_wait<0>();
        }
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        fence_a(a[1]);
        release((g + 26) % ST);
        mbar_arrive(brick_empty(buf));
        g += 27;
      }
      BRICK_STAMP(3, t == 0 && cw == 0 && k + 1 == wk.count);  // the last products are done

      // ---- epilogue: accumulator element j of tile m is output row
      // 16 warp + lane/4 + 8 ((j/2) % 2) (y = 2 warp + (j/2) % 2, z = lane/4)
      // of x-plane 2 cw + m, column (j/4) * 8 + 2 (lane % 4) + j % 2. A whole
      // unit goes out as bf16; with SPLIT a piece of a cut tail unit as fp32
      // into this CTA's slot of ws, 0 for its range's first unit, 1 for its
      // last: row o of the brick ((x * TY + y) * TZ + z) by BN columns
      if constexpr (SPLIT) {
        if (c_lo > 0 || c_hi < p.nchunks) {
          const int slot = k == wk.whole ? 0 : 1;
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) {
              const int o = ((2 * cw + m) * TY + 2 * warp + hh) * TZ + lane / 4;
              float* dst = p.ws + (((long long)blockIdx.x * 2 + slot) * (TX * TY * TZ) + o) * BN +
                           2 * (lane % 4);
#pragma unroll
              for (int jn = 0; jn < BN / 8; ++jn)
                *reinterpret_cast<float2*>(dst + jn * 8) =
                    make_float2(acc[m][4 * jn + 2 * hh], acc[m][4 * jn + 2 * hh + 1]);
            }
          continue;
        }
      }
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long vox =
              (((long long)un.b * S + un.x0 + 2 * cw + m) * S + un.y0 + 2 * warp + hh) * S +
              un.z0 + lane / 4;
          const int n0 = un.nt * BN + 2 * (lane % 4);
          __nv_bfloat16* dst = p.out + vox * p.cout + n0;
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn)
            if (n0 + jn * 8 < p.cout)
              *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(
                  acc[m][4 * jn + 2 * hh], acc[m][4 * jn + 2 * hh + 1]);
        }
    }
  }
  BRICK_STAMP(4, threadIdx.x == 128);  // the epilogue is done
}

// With SPLIT, the tail units that a range boundary cuts, each summed from
// the pieces of the CTAs whose ranges hold its chunks, in the order of the
// CTAs, and stored as bf16. blockIdx.y = b: the boundary range_lo(b + 1) of
// the tail items, taken by the first boundary inside its unit (so a unit
// cut twice is summed once); blockIdx.x, threads: groups of 4 columns of
// the unit's 256 x BN.
template <int BN>
__global__ void __launch_bounds__(256)
reduce_partials(const Params p) {
  constexpr int ROWS_OUT = TX * TY * TZ;
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= ROWS_OUT * BN / 4) return;
  const int ctas = (int)gridDim.y + 1, nch = p.nchunks;
  const int tail0 = p.units / ctas * ctas, items = (p.units - tail0) * nch;
  const int b = (int)blockIdx.y, lo = range_lo(items, ctas, b + 1);
  const int u = lo / nch;  // counted from tail0
  if (lo % nch == 0 || range_lo(items, ctas, b) > u * nch) return;
  const int o = e / (BN / 4), c = (e % (BN / 4)) * 4;
  const Unit un(tail0 + u, p.nb, p.s);
  const int n = un.nt * BN + c;
  if (n >= p.cout) return;
  // CTA b holds the unit's first chunk; each later CTA with items holds
  // the next piece, in slot 0 if the unit is its range's first
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int q = b;; ++q) {
    const int q_lo = range_lo(items, ctas, q), q_hi = range_lo(items, ctas, q + 1);
    if (q_hi > q_lo) {
      const int slot = q_lo / nch == u ? 0 : 1;
      const float4 v = *reinterpret_cast<const float4*>(
          p.ws + (((long long)q * 2 + slot) * ROWS_OUT + o) * BN + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    if (q_hi >= (u + 1) * nch) break;
  }
  const int x = o / (TY * TZ), y = (o / TZ) % TY, z = o % TZ;
  const long long vox =
      (((long long)un.b * p.s + un.x0 + x) * p.s + un.y0 + y) * p.s + un.z0 + z;
  __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(sum.x, sum.y),
                            __floats2bfloat162_rn(sum.z, sum.w)};
  *reinterpret_cast<uint2*>(p.out + vox * p.cout + n) = *reinterpret_cast<const uint2*>(pair);
}

template <bool FUSED, bool TMA_A, int BN, bool TAP, bool SPLIT>
int launch_cfg(const Params& p, const CUtensorMap& xmap, const CUtensorMap& wmap, int ctas,
               cudaStream_t stream) {
  auto kernel = conv_sm90<FUSED, TMA_A, BN, TAP, SPLIT>;
  constexpr int smem = Cfg<BN, TAP>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, THREADS, smem, stream>>>(p, xmap, wmap);
  if ((err = cudaGetLastError()) != cudaSuccess || !SPLIT || ctas == 1) return (int)err;
  const dim3 grid((TX * TY * TZ * BN / 4 + 255) / 256, ctas - 1);
  reduce_partials<BN><<<grid, 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// The units a build instantiates: the plain conv (conv3d.cu) the base unit
// only (BN 64 or 128), whole units; the fused Block also BN 32 and, where
// the brick comes by TMA, the tap layout (BN 32, 64) and ranges of chunks.
// The ranges are their own instantiations, so the whole-unit kernels carry
// none of their code.
template <bool FUSED, bool TMA_A, int BN>
int launch_bn(const Params& p, const CUtensorMap& xmap, const CUtensorMap& wmap, bool tap,
              bool split, int ctas, cudaStream_t stream) {
  if constexpr (FUSED && TMA_A) {
    if constexpr (BN <= 64) {
      if (tap && split) return launch_cfg<FUSED, TMA_A, BN, true, true>(p, xmap, wmap, ctas, stream);
      if (tap) return launch_cfg<FUSED, TMA_A, BN, true, false>(p, xmap, wmap, ctas, stream);
    }
    if (split && !tap) return launch_cfg<FUSED, TMA_A, BN, false, true>(p, xmap, wmap, ctas, stream);
  }
  if (tap || split) return (int)cudaErrorInvalidValue;
  return launch_cfg<FUSED, TMA_A, BN, false, false>(p, xmap, wmap, ctas, stream);
}

// xh, w, out, tables as at the head of this file; the plan's fields (the
// Python wrapper picks them: ops/kernels/fused_block.py::brick_plan, and
// for conv3d ops/kernels/conv3d.py::gemm_geometry): bn = 32, 64 or 128,
// tap = 0 or 1 (1: bn <= 64 and Cin % 8 == 0, the TMA brick), split = 0 or
// 1 (1: Cin % 8 == 0, and ws, (ctas, 2, 256, bn) fp32),
// ctas = the grid, 1 to the units (with split, to the (unit, chunk) items). Needs S % 8 == 0, Cout % 8 == 0 and 16-byte aligned
// xh and w. ``encode`` is the driver's cuTensorMapEncodeTiled. Returns a
// cudaError_t.
template <bool FUSED>
int launch(void* encode, const void* xh, const float* a_tab, const float* b_tab, const void* w,
           void* out, float* ws, int nb, int s, int cin, int cout, int bn, int tap, int split,
           int ctas, cudaStream_t stream) {
  EncodeTiled enc = reinterpret_cast<EncodeTiled>(encode);
  if (enc == nullptr || nb <= 0 || s <= 0 || s % 8 != 0 || cin <= 0 || cout <= 0 ||
      cout % 8 != 0 || (bn != 32 && bn != 64 && bn != 128) || ctas <= 0 ||
      (tap != 0 && tap != 1) || (split != 0 && split != 1) || (split && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!FUSED && bn == 32) return (int)cudaErrorInvalidValue;
  const long long per_sub = (long long)(s / TX) * (s / TY) * (s / TZ);
  const long long units = (long long)nb * per_sub * ((cout + bn - 1) / bn);
  const long long nchunks = (cin + KC - 1) / KC;
  if (units * nchunks > 0x7fffffffLL || ctas > (split ? units * nchunks : units))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xh = static_cast<const __nv_bfloat16*>(xh);
  p.a_tab = a_tab;
  p.b_tab = b_tab;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = ws;
  p.nb = nb;
  p.s = s;
  p.cin = cin;
  p.cout = cout;
  p.nchunks = (int)nchunks;
  p.units = (int)units;

  // weight (27, Cin, Cout), innermost first; boxes of 64 (BN = 32: 32)
  // columns by 64 K rows
  CUtensorMap wmap, xmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)cout, (cuuint64_t)cin, 27};
    const cuuint64_t strides[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
    const cuuint32_t box[3] = {bn == 32 ? 32u : 64u, (cuuint32_t)KC, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (enc(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bn == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const bool tma_a = cin % 8 == 0;  // rows 16-byte strided
  if (tma_a) {
    // input (B, E, E, E, Cin), innermost first; one halo'd brick per box
    const cuuint64_t e = (cuuint64_t)s + 2, row = (cuuint64_t)cin * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)cin, e, e, e, (cuuint64_t)nb};
    const cuuint64_t strides[4] = {row, row * e, row * e * e, row * e * e * e};
    const cuuint32_t box[5] = {KC, HZ, HY, HX, 1};
    const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
    if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(xh), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  } else {
    xmap = wmap;  // not read: the transform warps load the brick themselves
  }
  const bool tp = tap != 0, sp = split != 0;
  if constexpr (FUSED) {
    if (bn == 32)
      return tma_a ? launch_bn<FUSED, true, 32>(p, xmap, wmap, tp, sp, ctas, stream)
                   : launch_bn<FUSED, false, 32>(p, xmap, wmap, tp, sp, ctas, stream);
  }
  if (bn == 64)
    return tma_a ? launch_bn<FUSED, true, 64>(p, xmap, wmap, tp, sp, ctas, stream)
                 : launch_bn<FUSED, false, 64>(p, xmap, wmap, tp, sp, ctas, stream);
  return tma_a ? launch_bn<FUSED, true, 128>(p, xmap, wmap, tp, sp, ctas, stream)
               : launch_bn<FUSED, false, 128>(p, xmap, wmap, tp, sp, ctas, stream);
}

}  // namespace igemm
