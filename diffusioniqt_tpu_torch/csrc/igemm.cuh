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
// each unit in chunks of its input channels. The Python side picks a plan
// per launch (ops/kernels/fused_block.py::brick_plan) and passes its fields:
//   * BN = 32, 64 or 128 output channels per unit. 32 is the narrow unit of
//     the column shards (Cout 32 or 16 under tensor parallelism): its weight
//     slice has 64-byte rows (64-byte swizzle) and the products are wgmma
//     m64n32k16, so no columns past Cout rounded up to 32 are computed;
//   * kc = 64 input channels a chunk (128-byte brick rows, 128-byte
//     swizzle) or 32 (fused Block, Cin % 8 == 0: 64-byte rows, 64-byte
//     swizzle, the brick 38.4 KB). At Cin <= 32 the 64-channel chunk spent
//     half of its products, brick bytes and transform on zero channels; 32
//     does not. 32-channel chunks commit whole taps (4 wgmmas of 2 k16
//     steps, the register count of a 64-channel half tap, so at every BN),
//     and their smaller bricks leave room for a staging tile through which
//     the unit's output goes out by TMA (Cfg::TMA_OUT);
//   * TAP (Cin % 8 == 0): the consumers commit a whole tap per group instead
//     of half of one, so that the products of a group cover the next
//     group's A gathers. At BN = 128 a whole tap's A fragments do not fit
//     beside the accumulators, so there (Cfg::SS) the tensor core reads A
//     from the brick through a matrix descriptor, no gathers, and the
//     unit's chunks run back to back (a brick is handed back when the next
//     tap's wait shows its last products done). The base unit (the
//     flagship's Cout-64 Blocks at levels 0 and 1, and the plain-load brick)
//     commits half a tap;
//   * split: CTA c takes units c, c + ctas, ... whole, so neighbouring CTAs
//     run neighbouring bricks; with split (whole taps only) only the rounds
//     that fill the card, and the units left over (the last round's) are
//     cut into their (unit, chunk) items, spread over all CTAs in contiguous ranges that
//     differ by at most one item (range_lo), so that the last round is not
//     left part full (at 8^3 x 128 channels, 432 units of 2 chunks on 132
//     CTAs: 3 whole units and at most one chunk a CTA, 7 chunks, not 8). A
//     range cuts at most its first and last units; each piece of a cut unit
//     goes out as fp32 sums into the CTA's slot of ws (0: the unit its range
//     starts in, 1: the one it ends in), and reduce_partials, launched after
//     as a programmatic dependent (its idle threads leave while the conv
//     runs), sums a cut unit's pieces in the order of the CTAs. The split
//     kernels are their own instantiations (SPLIT), so the whole-unit ones
//     carry none of this;
//   * ctas: the grid, at most one CTA per SM, at most one per unit (with
//     split, per item).
// Three roles, warp-specialised, 512 threads:
//   * warp 0: one thread issues the TMA loads of the tap weight slices
//     (kc channels x BN, a 3-D map over (27, Cin, Cout)) into an mbarrier
//     ring (Cfg::STAGES: 48 KB at kc = 64, 54-64 KB at kc = 32);
//   * warps 1-3 and 12-15 (transform): per unit and chunk, one thread
//     issues the TMA load of the raw halo'd brick (6 x 10 x 10 voxels x kc
//     channels; a 5-D map over (B, E, E, E, Cin) whose channels past Cin
//     are zeros) into one of two brick buffers; the seven warps stage the
//     sub-volume's A, B of the chunk in shared memory, apply mish(A_r * x +
//     B_r) in place with the region r of each voxel (FUSED; Cfg::BATCH
//     16-byte groups in flight a thread) and hand the buffer to the
//     consumers. The next brick's load and Mish run while the consumers
//     multiply this one, on other warps, so the SFUs work beside the tensor
//     cores. Cin not a multiple of 8 (rows not 16-byte strided, which TMA
//     needs) takes plain loads here instead (kc = 64 only);
//   * warpgroups 1-2 (consumers): 128 output rows each (two m64 tiles, one
//     output x-plane of 8 x 8 each), 27 taps x kc / 16 k16 steps per chunk
//     as wgmma m64nBNk16 with A from registers (SS: from shared memory) and
//     B (the weight slice, MN-major) read by the tensor core through a
//     swizzled descriptor. A tap is a row shift of the brick, so the A
//     fragments are ldmatrix gathers from it (no im2col); the swizzle's XOR
//     uses the shifted brick row. Half a tap (2 k16 steps x 2 tiles; with
//     TAP the whole tap) is one commit group; the next group's ldmatrix
//     runs while this one is on the tensor cores, and a weight stage is
//     released as soon as its last group has finished. setmaxnreg moves
//     registers from warpgroups 0 and 3 to them (and, with SS, fewer).
// Seven transform warps, not three: with one warp a scheduler the Mish
// (about ten dependent instructions and two MUFU ops a value) could not
// hide its latency and set the kernel's pace.
// Shared memory: two bricks (153.6 KB at kc = 64, 77.8 KB at 32), the
// weight ring and the sub-volume's A, B coefficients of the chunk (13.5 or
// 6.75 KB) per CTA; at kc = 32 also the output staging tile (256 x BN bf16).
// Operand traffic per k16 step and consumer: 4 KB of ldmatrix for A and
// 2 x BN x 32 B of B reads, against 2 x 64 x BN x 16 x 2 FLOP. The epilogue
// stores the fp32 accumulators as bf16 pairs straight from registers; the
// two units of the 128-wide and 32-channel designs store otherwise: SS
// (BN = 128 in whole 64-channel taps) 16 bytes a store after a transpose
// inside each quad of lanes (whole 32-byte sectors), and 32-channel chunks
// through the staging tile, which one thread sends out by TMA stores that
// drain under the next unit.
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
// own build) compiles in per-CTA phase stamps and four ablations (the A
// gathers, the Mish, the weight stream, the epilogue).
#pragma once

#include "sm90.cuh"


namespace igemm {

using namespace sm90;

// Phase stamps and ablations of the trace build: each CTA writes the card's
// %globaltimer at five points into g_trace[blockIdx.x * 8 + k] (read by
// ops/kernels/brick_trace.py). g_ablate bit 0: the consumers gather each
// chunk's A fragments for its first tap only and multiply the same
// registers on every tap; bit 1: the transform warps hand the raw brick on
// without the affine + Mish; bit 3: the weight producer loads each ring
// stage once and then only marks it full again (the consumers multiply the
// stale slice: no weight stream from L2); bit 4: the consumers store
// nothing (no epilogue). All give wrong sums: they time the kernel without
// that work. The port's own build compiles all of it to nothing.
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
// the 64-channel chunk (one 128-byte row) of conv3d.cu and
// fused_block_small.cu; the brick route's kernel takes its chunk from Cfg
constexpr int KC = 64;
constexpr int BRICK_BYTES = ROWS * KC * 2;  // 76800 = 75 * 1024
constexpr int W_PART = KC * 64 * 2;       // one 64-column part of a weight slice
constexpr int TRANSFORM_THREADS = 224;    // warps 1-3 and 12-15
constexpr int THREADS = 512;

// One unit layout: BN output columns, TAP (a whole tap per commit group),
// CK input channels per chunk (64: 128-byte brick rows, 128-byte swizzle;
// 32: 64-byte rows, 64-byte swizzle, Cin <= 32 without half the products on
// zeros). Shared memory from a 1024-byte aligned base: the two bricks, the
// weight ring (both aligned as the swizzles need), the chunk's tables.
template <int BN, bool TAP = false, int CK = KC>
struct Cfg {
  static_assert(CK == 64 || (CK == 32 && TAP), "a 32-channel chunk commits whole taps");
  // SS: whole taps at BN = 128. A whole 64-channel tap's A fragments would
  // need a second set that does not fit beside 128 accumulators, and A in
  // registers leaves the transform two 16-byte groups in flight; so this
  // layout reads A from the brick through a matrix descriptor instead (wgmma
  // with both operands in shared memory): no ldmatrix, no A registers, and
  // the registers go to the transform
  static constexpr bool SS = TAP && BN == 128;
  static constexpr int ROW = 2 * CK;               // bytes per brick row
  static constexpr int GROUPS = CK / 8;            // 16-byte groups per brick row
  static constexpr int LOG_GROUPS = CK == 64 ? 3 : 2;
  static constexpr int BRICK = ROWS * ROW;         // 76800 or 38400
  static constexpr int BRICK_STRIDE = (BRICK + 1023) / 1024 * 1024;
  static constexpr int K16 = CK / 16;              // k16 steps per tap
  // setmaxnreg budgets: they move only the registers the CTA was launched
  // with, 512 * 128 = 65536 = 256 * CONSUMER_REGS + 256 * OTHER_REGS
  // (BN = 128: the 128 accumulators and two A fragment sets need 200, and
  // the transform then keeps two 16-byte groups in flight, not four; SS
  // holds no fragments, so the transform keeps four; BN = 32: 32
  // accumulators, so the transform keeps more registers)
  static constexpr int CONSUMER_REGS = BN == 32 ? 152 : (BN == 64 ? 160 : (SS ? 168 : 200));
  static constexpr int OTHER_REGS = BN == 32 ? 104 : (BN == 64 ? 96 : (SS ? 88 : 56));
  static constexpr int BATCH = BN == 128 && !SS ? 2 : 4;  // transform groups in flight a thread
  static constexpr int KS = TAP ? K16 : K16 / 2;   // k16 steps per commit group
  // a weight slice is CK K rows of BN columns: 128-byte rows in 64-column
  // parts W_PART apart (128-byte swizzle), or at BN = 32 one part of
  // 64-byte rows (64-byte swizzle)
  static constexpr int ROW_BYTES = BN == 32 ? 64 : 128;
  static constexpr int PARTS = BN == 32 ? 1 : BN / 64;
  static constexpr int W_PART = CK * 64 * 2;
  static constexpr int STAGE_BYTES = CK * BN * 2;
  // 48 KB of ring with 64-channel chunks; with 32-channel ones the smaller
  // bricks leave room for 64 KB (at BN = 32, 27 stages: one slice a tap)
  // and a staging tile for the output
  static constexpr int STAGES =
      CK == 64 ? (BN == 32 ? 12 : (BN == 64 ? 6 : 3)) : (BN == 32 ? 27 : 64 * 1024 / STAGE_BYTES);
  static constexpr int TAB_BYTES = 2 * 27 * CK * 4;  // A, B: [27][CK] fp32
  static constexpr int TAB_OFFSET = 2 * BRICK_STRIDE + STAGES * STAGE_BYTES;
  // TMA_OUT (32-channel chunks): a whole unit's bf16 output goes through a
  // staging tile (256 rows by BN, in 64-column parts of 128-byte rows with
  // the 128-byte swizzle; at BN = 32 one part of 64-byte rows, 64-byte
  // swizzle) and out by TMA stores, which drain while the consumers run the
  // next unit's products
  static constexpr bool TMA_OUT = CK == 32;
  static constexpr int OUT_ROW = BN == 32 ? 64 : 128;
  static constexpr int OUT_PART = 256 * OUT_ROW;
  static constexpr int OUT_OFFSET = (TAB_OFFSET + TAB_BYTES + 1023) / 1024 * 1024;
  static constexpr int SMEM =
      1024 + (TMA_OUT ? OUT_OFFSET + 256 * BN * 2 : TAB_OFFSET + TAB_BYTES);
  static_assert(SMEM <= 227 * 1024 - 256, "shared memory");
  // the swizzle: 16-byte group pc of brick row r holds the chunk's channels
  // 8 (pc ^ phase(r)) (bits 7-9, or 7-8, of the offset into bits 4-6 / 4-5)
  __device__ static __forceinline__ int phase(int r) { return CK == 64 ? (r & 7) : ((r >> 1) & 3); }
};

struct Params {
  const __nv_bfloat16* xh;  // read directly only when Cin % 8 != 0
  const float* a_tab;       // (B, 27, Cin), FUSED only
  const float* b_tab;
  __nv_bfloat16* out;
  float* ws;    // (ctas, 2, 256, BN) fp32: the CTAs' pieces of cut units, SPLIT only
  int nb, s, cin, cout;
  int nchunks;  // ceil(Cin / chunk width)
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

// The 4 x 4 transpose across the lanes of a quad (lane % 4 = q): register
// j of lane q goes to register q of lane j, by two exchanges (lanes 1, then
// 2 apart)
__device__ __forceinline__ void quad_transpose(uint32_t (&v)[4], int q) {
  const bool b0 = q & 1, b1 = q & 2;
  uint32_t r0 = __shfl_xor_sync(0xffffffffu, b0 ? v[0] : v[1], 1);
  uint32_t r1 = __shfl_xor_sync(0xffffffffu, b0 ? v[2] : v[3], 1);
  if (b0) {
    v[0] = r0;
    v[2] = r1;
  } else {
    v[1] = r0;
    v[3] = r1;
  }
  r0 = __shfl_xor_sync(0xffffffffu, b1 ? v[0] : v[2], 2);
  r1 = __shfl_xor_sync(0xffffffffu, b1 ? v[1] : v[3], 2);
  if (b1) {
    v[0] = r0;
    v[1] = r1;
  } else {
    v[2] = r0;
    v[3] = r1;
  }
}

// keeps the A fragments of half a tap live until its wgmma has finished
__device__ __forceinline__ void fence_frags(uint32_t (&f)[2][2][4]) {
  fence_regs(f[0]);
  fence_regs(f[1]);
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A K-major and B MN-major, both
// from shared memory through descriptors
__device__ __forceinline__ void wgmma_ss_n128_bt(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 1;\n}\n"
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
      : "l"(da), "l"(db), "r"(1));
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

template <bool FUSED, bool TMA_A, int BN, bool TAP, bool SPLIT, int CK = KC>
__global__ void __launch_bounds__(THREADS, 1)
conv_sm90(const Params p, const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap wmap, const __grid_constant__ CUtensorMap omap) {
  using C = Cfg<BN, TAP, CK>;
  constexpr int ST = C::STAGES, KS = C::KS, NT = TRANSFORM_THREADS, G = C::GROUPS;
  extern __shared__ unsigned char smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows of 128 B
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw_addr);
  const uint32_t w_s = base + 2 * C::BRICK_STRIDE;
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
#ifdef BRICK_TRACE
            if ((g_ablate & 8) && round > 0) {  // the stale slice, marked full
              mbar_arrive(full_w(st));
              continue;
            }
#endif
            mbar_expect_tx(full_w(st), C::STAGE_BYTES);
#pragma unroll
            for (int part = 0; part < C::PARTS; ++part)
              tma_load_3d(w_s + st * C::STAGE_BYTES + part * C::W_PART, &wmap, full_w(st),
                          un.nt * BN + part * 64, chunk * CK, tap);
          }
      }
    } else if (t >= 0) {
      // ------------------------------------------------------ transform
      float* tab_a = reinterpret_cast<float*>(base_ptr + C::TAB_OFFSET);  // [27][CK]
      float* tab_b = tab_a + 27 * CK;
      int item = 0;
      for (int k = 0; k < wk.count; ++k) {
        const Unit un(wk.unit(k), p.nb, S);
        for (int chunk = wk.chunk_lo(k); chunk < wk.chunk_hi(k); ++chunk, ++item) {
          const int buf = item & 1, use = item >> 1;
          if (use > 0) mbar_wait(brick_empty(buf), (use - 1) & 1);
          unsigned char* bp = base_ptr + buf * C::BRICK_STRIDE;
          const int c_base = chunk * CK;
          if (TMA_A && t == 0) {
            mbar_expect_tx(raw_full(buf), C::BRICK);
            tma_load_5d(base + buf * C::BRICK_STRIDE, &xmap, raw_full(buf), c_base, un.z0, un.y0,
                        un.x0, un.b);
          }
          if constexpr (FUSED) {
            // this sub-volume's coefficients of the chunk's channels -> shared
            // memory, [region][channel]; entries past Cin are never read
            named_bar_sync(1, NT);  // the previous chunk is done with them
            const long long t0 = (long long)un.b * 27 * cin + c_base;
            if constexpr (TMA_A) {  // Cin % 8 == 0: 16-byte copies, all in flight
              for (int id = t; id < 2 * 27 * (CK / 4); id += NT) {
                const int tab = id / (27 * (CK / 4)), r = (id / (CK / 4)) % 27, q = id % (CK / 4);
                const bool in = c_base + 4 * q < cin;
                const float* src = (tab ? p.b_tab : p.a_tab) + t0 + r * cin + 4 * q;
                cp_async16(smem_addr(tab_a + tab * 27 * CK + r * CK + 4 * q), in ? src : p.a_tab,
                           in ? 16 : 0);
              }
              cp_async_commit();
              cp_async_wait_all();
            } else {
              for (int id = t; id < 27 * CK; id += NT) {
                const int r = id / CK, c = id % CK;
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
            // pc of row r holds channels 8 (pc ^ phase(r)) of the chunk
            constexpr int BATCH = C::BATCH;
            for (int id0 = t; id0 < ROWS * G; id0 += BATCH * NT) {
              uint4 v[BATCH];
#pragma unroll
              for (int q = 0; q < BATCH; ++q) {
                const int id = id0 + q * NT;
                if (id >= ROWS * G) break;
                // shifts, not signed division: the transform's instructions
                // set the narrow unit's pace
                const int row = id >> C::LOG_GROUPS, pc = id & (G - 1);
                const int c = c_base + 8 * (pc ^ C::phase(row));
                if constexpr (TMA_A) {
                  v[q] = *reinterpret_cast<const uint4*>(bp + row * C::ROW + pc * 16);
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
                if (id >= ROWS * G) break;
                const int row = id >> C::LOG_GROUPS, pc = id & (G - 1);
                const int j8 = 8 * (pc ^ C::phase(row));
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
                    val = affine_mish8(val, tab_a + r * CK + j8, tab_b + r * CK + j8);
                  }
                }
                *reinterpret_cast<uint4*>(bp + row * C::ROW + pc * 16) = val;
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
          ldmatrix_x4(frag[i][k2], brick + r * C::ROW + ((chunk16 ^ C::phase(r)) << 4));
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
                                     : make_desc(kb, C::W_PART, 1024, 1);
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
    auto brick_at = [&](int it) { return base + (it & 1) * C::BRICK_STRIDE; };

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
      if constexpr (C::SS) {
        // one tap a commit group, A read by the tensor core from the brick:
        // m tile i of tap q is output x-plane 2 cw + i, 8 y rows of 8 z, so
        // its descriptor starts at brick row (2 cw + i) HY HZ + the tap's
        // shift, 8-row groups HZ rows apart (one y row to the next), k16
        // step kk at + 32 kk bytes; the swizzle (128- or 64-byte, as the
        // brick's) is applied on the absolute address, so a shift that is
        // not a multiple of 8 rows reads right with base offset 0
        // (brick_trace's desc_check). The unit's chunks back to back: a
        // brick is handed back once its last tap's products are done, which
        // the next tap's wait shows
        const int n = 27 * (c_hi - c_lo);
        mbar_wait(ready(item & 1), (item >> 1) & 1);
        BRICK_STAMP(2, t == 0 && cw == 0 && item == 0);  // the first products start
        for (int q = 0; q < n; ++q) {
          const int gs = g + q, st = gs % ST, tap = q % 27, it = item + q / 27;
          if (tap == 0 && q > 0) mbar_wait(ready(it & 1), (it >> 1) & 1);
          mbar_wait(full_w(st), (gs / ST) & 1);
          const uint32_t wst = w_s + st * C::STAGE_BYTES;
          const int toff = ((tap / 9) * HY + (tap / 3) % 3) * HZ + tap % 3;
          const uint32_t a0 = brick_at(it) + ((2 * cw) * HY * HZ + toff) * C::ROW;
          wgmma_fence();
#pragma unroll
          for (int k2 = 0; k2 < C::K16; ++k2) {
            const uint64_t db = make_desc(wst + k2 * 16 * C::ROW_BYTES, C::W_PART, 1024, 1);
#pragma unroll
            for (int i = 0; i < 2; ++i)
              wgmma_ss_n128_bt(acc[i], make_desc(a0 + i * HY * HZ * C::ROW + k2 * 32, 16,
                                                 HZ * C::ROW, CK == 64 ? 1 : 2), db);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous tap is done
          if (q > 0) {
            release((gs - 1) % ST);
            if (tap == 0) mbar_arrive(brick_empty((it - 1) & 1));
          }
        }
        wgmma_wait<0>();
        release((g + n - 1) % ST);
        mbar_arrive(brick_empty((item + c_hi - c_lo - 1) & 1));
        g += n;
        item += c_hi - c_lo;
        fence_regs(acc[0]);
        fence_regs(acc[1]);
      } else {
        for (int chunk = c_lo; chunk < c_hi; ++chunk, ++item) {
          const int buf = item & 1;
          mbar_wait(ready(buf), (item >> 1) & 1);
          BRICK_STAMP(2, t == 0 && cw == 0 && item == 0);  // the first products start
          const uint32_t brick = brick_at(item);
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
              load_a(a[1], brick, tap, KS);
              wgmma_fence();
              mma(a[1], wst, KS);
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
      }
      BRICK_STAMP(3, t == 0 && cw == 0 && k + 1 == wk.count);  // the last products are done
#ifdef BRICK_TRACE
      if (ablate & 16) continue;  // no epilogue
#endif

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
      if constexpr (C::TMA_OUT) {
        // the tile's element (row o, column n) at byte o * OUT_ROW + 16 (c ^
        // phase(o)) + 2 (n % 8) of part n / 64, c = (n % 64) / 8
        const bool issuer = t == 0 && cw == 0;
        if (issuer) bulk_wait_read();  // the previous unit's stores have read the tile
        named_bar_sync(2, 256);
        unsigned char* tile = base_ptr + C::OUT_OFFSET;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int o = ((2 * cw + m) * TY + 2 * warp + hh) * TZ + lane / 4;
            const int ph = BN == 32 ? (o >> 1) & 3 : o & 7;
#pragma unroll
            for (int jn = 0; jn < BN / 8; ++jn) {
              const __nv_bfloat162 h =
                  __floats2bfloat162_rn(acc[m][4 * jn + 2 * hh], acc[m][4 * jn + 2 * hh + 1]);
              *reinterpret_cast<__nv_bfloat162*>(tile + (jn / 8) * C::OUT_PART + o * C::OUT_ROW +
                                                 (((jn % 8) ^ ph) << 4) + 4 * (lane % 4)) = h;
            }
          }
        fence_proxy_async();  // the tile's writes before the TMA reads it
        named_bar_sync(2, 256);
        if (issuer) {
#pragma unroll
          for (int part = 0; part < (BN + 63) / 64; ++part)
            tma_store_5d(&omap, base + C::OUT_OFFSET + part * C::OUT_PART, un.nt * BN + part * 64,
                         un.z0, un.y0, un.x0, un.b);
          bulk_commit();
        }
      } else if constexpr (C::SS) {
        // a whole unit as bf16, 16 bytes a store: the four lanes of a quad
        // hold the 8-column groups 4 g .. 4 g + 3 of one output row as bf16
        // pairs; a transpose inside the quad gives lane q the whole group 4
        // g + q, so a warp's store covers 8 rows x 64 contiguous bytes
        // (whole 32-byte sectors) and not 8 rows x 16 bytes
        const int q = lane % 4;
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const long long vox =
                (((long long)un.b * S + un.x0 + 2 * cw + m) * S + un.y0 + 2 * warp + hh) * S +
                un.z0 + lane / 4;
#pragma unroll
            for (int g4 = 0; g4 < BN / 32; ++g4) {
              uint32_t v[4];
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const int jn = 4 * g4 + j;
                const __nv_bfloat162 h =
                    __floats2bfloat162_rn(acc[m][4 * jn + 2 * hh], acc[m][4 * jn + 2 * hh + 1]);
                v[j] = *reinterpret_cast<const uint32_t*>(&h);
              }
              quad_transpose(v, q);
              const int n0 = un.nt * BN + 8 * (4 * g4 + q);
              if (n0 < p.cout)
                *reinterpret_cast<uint4*>(p.out + vox * p.cout + n0) =
                    make_uint4(v[0], v[1], v[2], v[3]);
            }
          }
      } else {
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
    // the last tile's stores have read it before the CTA's shared memory goes
    if (C::TMA_OUT && t == 0 && cw == 0) bulk_wait();
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
  // launched as the conv's programmatic dependent: the threads above that
  // have nothing to sum leave while the conv still runs; the rest wait here
  // for its whole grid (and its partials) to be done
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

template <bool FUSED, bool TMA_A, int BN, bool TAP, bool SPLIT, int CK = KC>
int launch_cfg(const Params& p, const CUtensorMap& xmap, const CUtensorMap& wmap,
               const CUtensorMap& omap, int ctas, cudaStream_t stream) {
  auto kernel = conv_sm90<FUSED, TMA_A, BN, TAP, SPLIT, CK>;
  constexpr int smem = Cfg<BN, TAP, CK>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, THREADS, smem, stream>>>(p, xmap, wmap, omap);
  if ((err = cudaGetLastError()) != cudaSuccess || !SPLIT || ctas == 1) return (int)err;
  // the reduction as a programmatic dependent launch: its blocks start on
  // the SMs the conv's CTAs leave, not after the whole grid has drained
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((TX * TY * TZ * BN / 4 + 255) / 256, ctas - 1);
  cfg.blockDim = dim3(256);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if ((err = cudaLaunchKernelEx(&cfg, reduce_partials<BN>, p)) != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The units a build instantiates: the plain conv (conv3d.cu) the base unit
// only (BN 64 or 128, 64-channel chunks, half taps), whole units. The fused
// Block: with the plain-load brick (Cin % 8 != 0) half taps at BN 32, 64
// and 128, whole units; where the brick comes by TMA whole taps at every BN
// (at BN 128 with A from shared memory), whole units or ranges of chunks,
// 32-channel chunks (whole units) at every BN, and half taps only in the
// base unit (BN 64, 64-channel chunks, whole units). Every other plan is
// refused. The ranges are their own instantiations, so the whole-unit
// kernels carry none of their code.
template <bool FUSED, bool TMA_A, int BN>
int launch_bn(const Params& p, const CUtensorMap& xmap, const CUtensorMap& wmap,
              const CUtensorMap& omap, int kc, bool tap, bool split, int ctas,
              cudaStream_t stream) {
  if constexpr (FUSED && TMA_A) {
    if (kc == 32) {  // Cin <= 32: one chunk a unit, so never cut into ranges
      if (!tap || split) return (int)cudaErrorInvalidValue;
      return launch_cfg<FUSED, TMA_A, BN, true, false, 32>(p, xmap, wmap, omap, ctas, stream);
    }
    if (tap && split)
      return launch_cfg<FUSED, TMA_A, BN, true, true>(p, xmap, wmap, omap, ctas, stream);
    if (tap) return launch_cfg<FUSED, TMA_A, BN, true, false>(p, xmap, wmap, omap, ctas, stream);
    if constexpr (BN == 64) {
      if (!split)
        return launch_cfg<FUSED, TMA_A, 64, false, false>(p, xmap, wmap, omap, ctas, stream);
    }
    return (int)cudaErrorInvalidValue;
  } else {
    if (kc != KC || tap || split) return (int)cudaErrorInvalidValue;
    return launch_cfg<FUSED, TMA_A, BN, false, false>(p, xmap, wmap, omap, ctas, stream);
  }
}

// xh, w, out, tables as at the head of this file; the plan's fields (the
// Python wrapper picks them: ops/kernels/fused_block.py::brick_plan, and
// for conv3d ops/kernels/conv3d.py::gemm_geometry): bn = 32, 64 or 128,
// kc = 64 or 32 input channels per chunk (32: the fused Block with Cin % 8
// == 0, tap = 1 and split = 0), tap = 0 or 1 (1: the fused Block with Cin %
// 8 == 0, the TMA brick; 0 there only at bn = 64 without split), split = 0
// or 1 (1: tap = 1, and ws, (ctas, 2, 256, bn) fp32), ctas = the grid, 1
// to the units (with split, to the (unit, chunk) items). Needs S % 8 == 0,
// Cout % 8 == 0 and 16-byte aligned xh and w. ``encode`` is libcuda's cuTensorMapEncodeTiled.
// Returns a cudaError_t.
template <bool FUSED>
int launch(void* encode, const void* xh, const float* a_tab, const float* b_tab, const void* w,
           void* out, float* ws, int nb, int s, int cin, int cout, int bn, int kc, int tap,
           int split, int ctas, cudaStream_t stream) {
  EncodeTiled enc = reinterpret_cast<EncodeTiled>(encode);
  if (enc == nullptr || nb <= 0 || s <= 0 || s % 8 != 0 || cin <= 0 || cout <= 0 ||
      cout % 8 != 0 || (bn != 32 && bn != 64 && bn != 128) || (kc != 32 && kc != 64) ||
      ctas <= 0 || (tap != 0 && tap != 1) || (split != 0 && split != 1) ||
      (split && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (!FUSED && (bn == 32 || kc != KC)) return (int)cudaErrorInvalidValue;
  const long long per_sub = (long long)(s / TX) * (s / TY) * (s / TZ);
  const long long units = (long long)nb * per_sub * ((cout + bn - 1) / bn);
  const long long nchunks = (cin + kc - 1) / kc;
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
  // columns by kc K rows
  CUtensorMap wmap, xmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)cout, (cuuint64_t)cin, 27};
    const cuuint64_t strides[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
    const cuuint32_t box[3] = {bn == 32 ? 32u : 64u, (cuuint32_t)kc, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (enc(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            bn == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const bool tma_a = cin % 8 == 0;  // rows 16-byte strided
  if (tma_a) {
    // input (B, E, E, E, Cin), innermost first; one halo'd brick of one
    // chunk per box, its rows 128 (kc 64) or 64 (kc 32) bytes, swizzled
    const cuuint64_t e = (cuuint64_t)s + 2, row = (cuuint64_t)cin * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)cin, e, e, e, (cuuint64_t)nb};
    const cuuint64_t strides[4] = {row, row * e, row * e * e, row * e * e * e};
    const cuuint32_t box[5] = {(cuuint32_t)kc, HZ, HY, HX, 1};
    const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
    if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(xh), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            kc == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  } else {
    if (kc != KC) return (int)cudaErrorInvalidValue;
    xmap = wmap;  // not read: the transform warps load the brick themselves
  }
  // output (B, S, S, S, Cout), innermost first: with 32-channel chunks the
  // unit's tile goes out by TMA, 64 (BN = 32: 32) columns of the brick's 4 x
  // 8 x 8 voxels a box, swizzled as the staging tile
  CUtensorMap omap = wmap;  // not read by the other layouts
  if (kc == 32) {
    const cuuint64_t sz = (cuuint64_t)s, row = (cuuint64_t)cout * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)cout, sz, sz, sz, (cuuint64_t)nb};
    const cuuint64_t strides[4] = {row, row * sz, row * sz * sz, row * sz * sz * sz};
    const cuuint32_t box[5] = {bn == 32 ? 32u : 64u, TZ, TY, TX, 1};
    const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
    if (enc(&omap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, out, dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            bn == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  const bool tp = tap != 0, sp = split != 0;
  if constexpr (FUSED) {
    if (bn == 32)
      return tma_a ? launch_bn<FUSED, true, 32>(p, xmap, wmap, omap, kc, tp, sp, ctas, stream)
                   : launch_bn<FUSED, false, 32>(p, xmap, wmap, omap, kc, tp, sp, ctas, stream);
  }
  if (bn == 64)
    return tma_a ? launch_bn<FUSED, true, 64>(p, xmap, wmap, omap, kc, tp, sp, ctas, stream)
                 : launch_bn<FUSED, false, 64>(p, xmap, wmap, omap, kc, tp, sp, ctas, stream);
  return tma_a ? launch_bn<FUSED, true, 128>(p, xmap, wmap, omap, kc, tp, sp, ctas, stream)
               : launch_bn<FUSED, false, 128>(p, xmap, wmap, omap, kc, tp, sp, ctas, stream);
}

}  // namespace igemm
