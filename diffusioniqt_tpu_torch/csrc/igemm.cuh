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
// This design: one persistent CTA per SM walks units of work (an output
// brick of TX x TY x TZ = 4 x 8 x 8 = 256 voxels of one sub-volume and BN =
// 64 or 128 output channels), neighbouring CTAs on neighbouring bricks, and
// each unit in 64-channel chunks (128-byte rows, 128-byte swizzle). Three
// roles, warp-specialised, 512 threads:
//   * warp 0: one thread issues the TMA loads of the tap weight slices
//     (64 channels x BN, a 3-D map over (27, Cin, Cout)) into an mbarrier
//     ring (6 stages at BN = 64, 3 at BN = 128);
//   * warps 1-3 and 12-15 (transform): per unit and chunk, one thread
//     issues the TMA load of the raw halo'd brick (6 x 10 x 10 voxels x 64
//     channels, 76.8 KB; a 5-D map over (B, E, E, E, Cin) whose channels
//     past Cin are zeros) into one of two brick buffers; the seven warps
//     stage the sub-volume's A, B of the chunk in shared memory, apply
//     mish(A_r * x + B_r) in place with the region r of each voxel (FUSED;
//     4 16-byte groups in flight a thread at BN = 64, 2 at BN = 128) and
//     hand the buffer to the consumers. The next brick's load and Mish run
//     while the consumers multiply this one, on other warps, so the SFUs
//     work beside the tensor cores. Cin not a multiple of 8 (rows not
//     16-byte strided, which TMA needs) takes plain loads here instead;
//   * warpgroups 1-2 (consumers): 128 output rows each (two m64 tiles, one
//     output x-plane of 8 x 8 each), 27 taps x 4 k16 steps per chunk as
//     wgmma m64nBNk16 with A from registers and B (the weight slice,
//     MN-major) read by the tensor core through a swizzled descriptor. A
//     tap is a row shift of the brick, so the A fragments are ldmatrix
//     gathers from it (no im2col); the 128-byte swizzle's XOR uses the
//     shifted brick row. Half a tap (2 k16 steps x 2 tiles) is one commit
//     group; the next half's ldmatrix runs while this one is on the tensor
//     cores, and a weight stage is released as soon as its last group has
//     finished. setmaxnreg moves registers from warpgroups 0 and 3 to them.
// Seven transform warps, not three: with one warp a scheduler the Mish
// (about ten dependent instructions and two MUFU ops a value) could not
// hide its latency and set the kernel's pace.
// Shared memory: two bricks (153.6 KB), the weight ring (48 KB) and the
// sub-volume's A, B coefficients of the chunk (13.5 KB) per CTA.
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
#pragma once

#include "sm90.cuh"


namespace igemm {

using namespace sm90;

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
// ring (both 1024-byte aligned, as the 128-byte swizzle needs), the tables
template <int BN>
struct Cfg {
  // setmaxnreg budgets: they move only the registers the CTA was launched
  // with, 512 * 128 = 65536 = 256 * CONSUMER_REGS + 256 * OTHER_REGS
  // (BN = 128: the 128 accumulators and two A fragment sets need 200, and
  // the transform then keeps two 16-byte groups in flight, not four)
  static constexpr int CONSUMER_REGS = BN == 64 ? 160 : 200;
  static constexpr int OTHER_REGS = BN == 64 ? 96 : 56;
  static constexpr int BATCH = BN == 64 ? 4 : 2;  // transform groups in flight a thread
  static constexpr int STAGES = BN == 64 ? 6 : 3;
  static constexpr int STAGE_BYTES = KC * BN * 2;
  static constexpr int TAB_OFFSET = 2 * BRICK_BYTES + STAGES * STAGE_BYTES;
  static constexpr int SMEM = 1024 + TAB_OFFSET + TAB_BYTES;
};
static_assert(Cfg<64>::SMEM <= 227 * 1024 - 256 && Cfg<128>::SMEM <= 227 * 1024 - 256,
              "shared memory");

struct Params {
  const __nv_bfloat16* xh;  // read directly only when Cin % 8 != 0
  const float* a_tab;       // (B, 27, Cin), FUSED only
  const float* b_tab;
  __nv_bfloat16* out;
  int nb, s, cin, cout;
  int nchunks;  // ceil(Cin / 64)
  int units;    // B * bricks per sub-volume * ceil(Cout / BN)
};

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
  if constexpr (BN == 64) wgmma_rs_n64(d, a, db);
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

template <bool FUSED, bool TMA_A, int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_sm90(const Params p, const __grid_constant__ CUtensorMap xmap,
          const __grid_constant__ CUtensorMap wmap) {
  using C = Cfg<BN>;
  constexpr int ST = C::STAGES;
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
      mbar_init(ready(buf), TRANSFORM_THREADS);
      mbar_init(brick_empty(buf), 256);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0 || wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::OTHER_REGS));
    // transform thread, 0 ... 223: warps 1-3, then warpgroup 3
    const int t = wg == 0 ? (int)threadIdx.x - 32 : (int)threadIdx.x - 384 + 96;
    if (threadIdx.x == 0) {
      // ------------------------------------------------ weight producer
      int g = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit un(u, p.nb, S);
        for (int chunk = 0; chunk < p.nchunks; ++chunk)
          for (int tap = 0; tap < 27; ++tap, ++g) {
            const int st = g % ST, round = g / ST;
            if (round > 0) mbar_wait(empty_w(st), (round - 1) & 1);
            mbar_expect_tx(full_w(st), C::STAGE_BYTES);
#pragma unroll
            for (int part = 0; part < BN / 64; ++part)
              tma_load_3d(w_s + st * C::STAGE_BYTES + part * W_PART, &wmap, full_w(st),
                          un.nt * BN + part * 64, chunk * KC, tap);
          }
      }
    } else if (t >= 0) {
      // ------------------------------------------------------ transform
      float* tab_a = reinterpret_cast<float*>(base_ptr + C::TAB_OFFSET);  // [27][64]
      float* tab_b = tab_a + 27 * KC;
      int item = 0;
      for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
        const Unit un(u, p.nb, S);
        for (int chunk = 0; chunk < p.nchunks; ++chunk, ++item) {
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
            named_bar_sync(1, TRANSFORM_THREADS);  // the previous chunk is done with them
            const long long t0 = (long long)un.b * 27 * cin + c_base;
            if constexpr (TMA_A) {  // Cin % 8 == 0: 16-byte copies, all in flight
              for (int id = t; id < 2 * 27 * (KC / 4); id += TRANSFORM_THREADS) {
                const int tab = id / (27 * (KC / 4)), r = (id / (KC / 4)) % 27, q = id % (KC / 4);
                const bool in = c_base + 4 * q < cin;
                const float* src = (tab ? p.b_tab : p.a_tab) + t0 + r * cin + 4 * q;
                cp_async16(smem_addr(tab_a + tab * 27 * KC + r * KC + 4 * q), in ? src : p.a_tab,
                           in ? 16 : 0);
              }
              cp_async_commit();
              cp_async_wait_all();
            } else {
              for (int id = t; id < 27 * KC; id += TRANSFORM_THREADS) {
                const int r = id / KC, c = id % KC;
                const bool in = c_base + c < cin;
                tab_a[id] = in ? p.a_tab[t0 + r * cin + c] : 0.0f;
                tab_b[id] = in ? p.b_tab[t0 + r * cin + c] : 0.0f;
              }
            }
            named_bar_sync(1, TRANSFORM_THREADS);
          }
          if constexpr (TMA_A) mbar_wait(raw_full(buf), use & 1);
          if (FUSED || !TMA_A) {
            // 16-byte groups of 8 channels, four per thread in flight; group
            // pc of row r holds channels 8 (pc ^ (r & 7)) of the chunk
            // (128-byte swizzle)
            constexpr int BATCH = C::BATCH;
            for (int id0 = t; id0 < ROWS * 8; id0 += BATCH * TRANSFORM_THREADS) {
              uint4 v[BATCH];
#pragma unroll
              for (int q = 0; q < BATCH; ++q) {
                const int id = id0 + q * TRANSFORM_THREADS;
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
                const int id = id0 + q * TRANSFORM_THREADS;
                if (id >= ROWS * 8) break;
                const int row = id >> 3, pc = id & 7;
                const int j8 = 8 * (pc ^ (row & 7));
                uint4 val = v[q];
                if constexpr (FUSED) {
                  if (c_base + j8 < cin) {
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

    float acc[2][BN / 2];
    uint32_t a[2][2][2][4];  // [half of the tap][m tile][k16 step][fragment]

    // A fragments of half h of one tap: k16 steps 2h, 2h + 1
    auto load_a = [&](uint32_t (&frag)[2][2][4], uint32_t brick, int tap, int h) {
      const int kx = tap / 9, ky = (tap / 3) % 3, kz = tap % 3;
      const int toff = (kx * HY + ky) * HZ + kz;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = row0[i] + toff;
#pragma unroll
        for (int k2 = 0; k2 < 2; ++k2) {
          const int chunk16 = (2 * h + k2) * 2 + khalf;
          ldmatrix_x4(frag[i][k2], brick + r * 128 + ((chunk16 ^ (r & 7)) << 4));
        }
      }
    };
    // B of k16 step kk: 16 rows of the weight slice, 64-column parts W_PART apart
    auto mma_half = [&](const uint32_t (&frag)[2][2][4], uint32_t wst, int h) {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const uint64_t db = make_desc(wst + (2 * h + k2) * 16 * 128, W_PART, 1024, 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) wgmma_rs<BN>(acc[i], frag[i][k2], db);
      }
    };

    int g = 0, item = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const Unit un(u, p.nb, S);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[i][j] = 0.0f;
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      for (int chunk = 0; chunk < p.nchunks; ++chunk, ++item) {
        const int buf = item & 1;
        mbar_wait(ready(buf), (item >> 1) & 1);
        const uint32_t brick = base + buf * BRICK_BYTES;
        load_a(a[0], brick, 0, 0);
        for (int tap = 0; tap < 27; ++tap) {
          const int gs = g + tap;
          const int st = gs % ST;
          mbar_wait(full_w(st), (gs / ST) & 1);
          const uint32_t wst = w_s + st * C::STAGE_BYTES;
          wgmma_fence();
          mma_half(a[0], wst, 0);
          wgmma_commit();
          wgmma_wait<1>();  // the previous tap's second half is done
          fence_frags(a[1]);
          if (tap > 0) mbar_arrive(empty_w((gs - 1) % ST));
          load_a(a[1], brick, tap, 1);
          wgmma_fence();
          mma_half(a[1], wst, 1);
          wgmma_commit();
          wgmma_wait<1>();  // this tap's first half is done
          fence_frags(a[0]);
          if (tap < 26) load_a(a[0], brick, tap + 1, 0);
        }
        wgmma_wait<0>();
        fence_regs(acc[0]);
        fence_regs(acc[1]);
        fence_frags(a[1]);
        mbar_arrive(empty_w((g + 26) % ST));
        mbar_arrive(brick_empty(buf));
        g += 27;
      }

      // ---- epilogue: accumulator element j of tile i is output row
      // 16 warp + lane/4 + 8 ((j/2) % 2) (y = 2 warp + (j/2) % 2, z = lane/4),
      // column (j/4) * 8 + 2 (lane % 4) + j % 2
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long vox =
              (((long long)un.b * S + un.x0 + 2 * cw + i) * S + un.y0 + 2 * warp + hh) * S +
              un.z0 + lane / 4;
          const int n0 = un.nt * BN + 2 * (lane % 4);
          __nv_bfloat16* dst = p.out + vox * p.cout + n0;
#pragma unroll
          for (int jn = 0; jn < BN / 8; ++jn)
            if (n0 + jn * 8 < p.cout)
              *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(
                  acc[i][4 * jn + 2 * hh], acc[i][4 * jn + 2 * hh + 1]);
        }
    }
  }
}

template <bool FUSED, bool TMA_A, int BN>
int launch_cfg(const Params& p, const CUtensorMap& xmap, const CUtensorMap& wmap,
               cudaStream_t stream) {
  auto kernel = conv_sm90<FUSED, TMA_A, BN>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Cfg<BN>::SMEM);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  const int grid = p.units < sms ? p.units : sms;
  kernel<<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(p, xmap, wmap);
  return (int)cudaGetLastError();
}

// xh, w, out, tables as at the head of this file; bn = 64 or 128 (the
// Python wrapper picks it: ops/kernels/conv3d.py::gemm_geometry). Needs
// S % 8 == 0, Cout % 8 == 0 and 16-byte aligned xh and w. ``encode`` is the
// driver's cuTensorMapEncodeTiled. Returns a cudaError_t.
template <bool FUSED>
int launch(void* encode, const void* xh, const float* a_tab, const float* b_tab, const void* w,
           void* out, int nb, int s, int cin, int cout, int bn, cudaStream_t stream) {
  EncodeTiled enc = reinterpret_cast<EncodeTiled>(encode);
  if (enc == nullptr || nb <= 0 || s <= 0 || s % 8 != 0 || cin <= 0 || cout <= 0 ||
      cout % 8 != 0 || (bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  const long long per_sub = (long long)(s / TX) * (s / TY) * (s / TZ);
  const long long units = (long long)nb * per_sub * ((cout + bn - 1) / bn);
  if (units > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Params p;
  p.xh = static_cast<const __nv_bfloat16*>(xh);
  p.a_tab = a_tab;
  p.b_tab = b_tab;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.nb = nb;
  p.s = s;
  p.cin = cin;
  p.cout = cout;
  p.nchunks = (cin + KC - 1) / KC;
  p.units = (int)units;

  // weight (27, Cin, Cout), innermost first; 64 x 64 boxes
  CUtensorMap wmap, xmap;
  {
    const cuuint64_t dims[3] = {(cuuint64_t)cout, (cuuint64_t)cin, 27};
    const cuuint64_t strides[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
    const cuuint32_t box[3] = {64, KC, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (enc(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
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
  if (bn == 64)
    return tma_a ? launch_cfg<FUSED, true, 64>(p, xmap, wmap, stream)
                 : launch_cfg<FUSED, false, 64>(p, xmap, wmap, stream);
  return tma_a ? launch_cfg<FUSED, true, 128>(p, xmap, wmap, stream)
               : launch_cfg<FUSED, false, 128>(p, xmap, wmap, stream);
}

}  // namespace igemm
