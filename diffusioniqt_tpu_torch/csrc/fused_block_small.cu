// The fused ResnetBlock Block unit at sub-volume edges 4 and 2 on Hopper:
//   out = conv_valid(mish(A_r * xh + B_r), w)       (bf16 out, fp32 accum)
// with xh (B, E, E, E, Cin) the raw halo'd input (E = S + 2, S = 4 or 2),
// tables A, B (B, 27, Cin) fp32 per sub-volume and region r (A = B = 0
// where the neighbour is missing: a zero halo), w the packed (27, Cin,
// Cout) bf16 weight. The conv bias is added by the caller.
//
// Replaces diffusioniqt_tpu/ops/pallas/fused_block.py::fused_boundary_block
// (its _fused_kernel) at the levels of a memory_efficient U-Net: the
// efficient flagship at 4^3 (216 x 256 -> 256, factor 3), SRUnet256 at 4^3
// (27 x 512 -> 512, factor 1) and 2^3 (27 x 1024 -> 1024). The edges that
// are multiples of 8 take the brick route (fused_block.cu, igemm.cuh).
//
// Bound. As a matrix product M = B * S^3 rows, N = Cout, K = 27 * Cin. At
// 2^3 M is small (216 rows at B = 27) and the weight is the bound: 56.6 MB
// at 1024 -> 1024, 0.017 ms of HBM against 0.012 ms of products. At 4^3
// the products are (48.9 GFLOP at 216 x 256 -> 256, 0.049 ms).
//
// The earlier design (the brick route's kernel over units of whole
// sub-volumes) lost to cuDNN's conv alone 3x at 2^3 and 1.6x at 4^3:
// at 2^3 only 16 units of 128 rows x 128 columns for 132 SMs, each a serial
// chain of 432 weight slices; at 4^3 216 units in 1.64 waves, each halo'd
// brick put through Mish once per 128-column n tile.
//
// Design. A tile is 128 output rows (P = 2 whole 4^3 or 16 whole 2^3
// sub-volumes: m block) by BN = 2 * BNW output channels (n block); its K is
// 27 taps x ceil(Cin / 64) chunks, one brick (the tile's halo'd inputs of
// one chunk, one TMA box, put through Mish) a chunk, 27 slices (a tap of a
// chunk) a brick. CTAs come in pairs, a cluster of two: the pair takes m
// blocks 2 j and 2 j + 1 of one n block (a pair tile) with the same slices,
// and each CTA's producer loads half of every weight slice into both
// (TMA multicast), so a weight byte leaves L2 once per pair. The pair
// tiles' bricks, tile after tile (n block major), are cut into ctas / 2
// contiguous ranges of whole bricks (ops/kernels/fused_block.py::
// small_edge_plan: one wave, each pair ceil(bricks / pairs on the card)
// bricks, as few pairs as that allows). At 2^3 x 1024 that is split-K over
// 128 SMs: each pair streams one chunk of one n block's weight. A CTA whose
// range holds a whole tile stores bf16; a tile cut by a range end is summed
// from fp32 partials (two slots a CTA: the tile its range starts in, the
// one it ends in) by reduce_partials, in the order of the CTAs, so a
// launch's bits never depend on timing; no float atomics.
//
// Roles, warp-specialised, 512 threads (as igemm.cuh):
//   * warp 0: one thread pulls the range's first weight slices into L2
//     (their loads would wait behind the first brick's Mish), then issues
//     the multicast TMA loads of its half of each slice (64 channels x BN,
//     64-column boxes of a 3-D map over (27, Cin, Cout)) into an mbarrier
//     ring, a stage refilled once both CTAs' consumer warps have freed it;
//   * warps 1-3 and 12-15 (transform): per brick, one thread issues its TMA
//     load (P sub-volumes x E^3 voxels x 64 channels: 55.3 KB at 4^3, two
//     buffers; 128 KB at 2^3, one buffer; sub-volumes past B come in as
//     zeros), and the seven warps apply mish(A_r x + B_r) in place, each
//     16-byte group with its row's own sub-volume and region (the tables
//     read through L1: a brick mixes sub-volumes); the consumer warpgroups,
//     idle until then, take half of the CTA's first brick. A brick goes
//     through Mish once per tile: both consumer warpgroups read it;
//   * warpgroups 1-2 (consumers): both take all 128 rows (two m64 tiles),
//     warpgroup w the columns [w BNW, (w + 1) BNW) of the tile, 4 k16 steps
//     a slice as wgmma m64nBNWk16, A from registers (ldmatrix gathers: a tap
//     is a row shift (kx*E + ky)*E + kz of the brick, with the 128-byte
//     swizzle's XOR on the shifted row), B through a swizzled descriptor
//     at the warpgroup's column part of the slice. Half a slice is one
//     commit group; the next half's ldmatrix runs beside it.
#include "igemm.cuh"

namespace small_edge {

// Phase stamps read by ops/kernels/small_edge_trace.py: each CTA writes
// the card's %globaltimer at six points, in a build with -DSMALL_EDGE_TRACE
// only (the port's own build compiles them to nothing).
#ifdef SMALL_EDGE_TRACE
__device__ unsigned long long* g_trace;
#define TRACE(k, cond)                                                   \
  do {                                                                   \
    if ((cond) && g_trace) {                                             \
      unsigned long long now;                                            \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));            \
      g_trace[blockIdx.x * 8 + (k)] = now;                               \
    }                                                                    \
  } while (0)
#else
#define TRACE(k, cond) do {} while (0)
#endif

using namespace sm90;
using igemm::KC;
using igemm::THREADS;
using igemm::TRANSFORM_THREADS;
using igemm::W_PART;

constexpr int TILE_ROWS = 128;  // output rows of a tile: two m64 tiles
constexpr int PREFETCH = 16;    // weight slices a CTA pulls into L2 at its start

template <int S>
struct Geom {
  static constexpr int E = S + 2, E3 = E * E * E, V = S * S * S;
  static constexpr int P = TILE_ROWS / V;  // sub-volumes per tile: 2 or 16
  static constexpr int ROWS = P * E3;      // halo'd brick rows: 432 or 1024
  static constexpr int BRICK_BYTES = ROWS * KC * 2;
  static constexpr int NBUF = 2 * BRICK_BYTES <= 128 * 1024 ? 2 : 1;
  static_assert(P * V == TILE_ROWS, "a tile is whole sub-volumes");
  static_assert(BRICK_BYTES % 1024 == 0, "brick buffers 1024-byte aligned");
};

// shared memory from a 1024-byte aligned base: the brick buffers, then the
// weight ring (both 1024-byte aligned, as the 128-byte swizzle needs)
template <int S, int BNW>
struct Cfg {
  // setmaxnreg budgets, as igemm::Cfg: 512 * 128 = 256 * CONSUMER_REGS +
  // 256 * OTHER_REGS (BNW = 128: two m64 x n128 accumulators and two A
  // fragment sets; the transform then keeps two 16-byte groups in flight)
  static constexpr int CONSUMER_REGS = BNW == 64 ? 160 : 200;
  static constexpr int OTHER_REGS = BNW == 64 ? 96 : 56;
  static constexpr int BATCH = BNW == 64 ? 4 : 2;
  static constexpr int BN = 2 * BNW;
  static constexpr int STAGE_BYTES = KC * BN * 2;
  static constexpr int LIMIT = 227 * 1024 - 256;
  static constexpr int RING = LIMIT - 1024 - Geom<S>::NBUF * Geom<S>::BRICK_BYTES;
  static constexpr int STAGES = RING / STAGE_BYTES > 8 ? 8 : RING / STAGE_BYTES;
  static constexpr int SMEM = 1024 + Geom<S>::NBUF * Geom<S>::BRICK_BYTES + STAGES * STAGE_BYTES;
  static_assert(STAGES >= 2 && SMEM <= LIMIT, "shared memory");
};

struct Params {
  const float* a_tab;  // (B, 27, Cin)
  const float* b_tab;
  __nv_bfloat16* out;  // (B, S, S, S, Cout)
  float* ws;           // (ctas, 2, 128, BN) fp32 partials; unused if no tile is cut
  int nb, cin, cout;
  int chunks;          // ceil(Cin / 64): bricks per tile, 27 slices each
  int mblocks;         // ceil(B / P)
  int mpairs;          // ceil(mblocks / 2); pair tile u = n block u / mpairs, pair u % mpairs
  int clusters;        // ctas / 2
  int bricks;          // pair tiles * chunks
};

// the tiles that reduce_partials sums: m block and n block of each
constexpr int MAX_CUT = 256;
struct CutTiles {
  int n;
  short mb[MAX_CUT], nblk[MAX_CUT];
};

// first brick of cluster c's range: the clusters' ranges differ by at most one
__host__ __device__ __forceinline__ int range_lo(int bricks, int clusters, int c) {
  return (int)((long long)c * bricks / clusters);
}

// the cluster whose range holds brick i
__device__ __forceinline__ int cluster_of(int bricks, int clusters, int i) {
  return (int)(((long long)(i + 1) * clusters + bricks - 1) / bricks - 1);
}

// brick row of output row r (0 ... 63) of m64 tile i of a tile, before the
// tap's shift
template <int S>
__device__ __forceinline__ int brick_row(int i, int r) {
  using G = Geom<S>;
  const int o = i * 64 + r;
  const int sub = o / G::V, v = o % G::V;
  return sub * G::E3 + ((v / (S * S)) * G::E + (v / S) % S) * G::E + v % S;
}

// mish(A_r x + B_r) in place on the groups id = worker, worker + workers,
// ... of a brick in shared memory (BATCH in flight a thread): 16-byte
// groups of 8 channels, group pc of row r holding channels 8 (pc ^ (r & 7))
// of the chunk (128-byte swizzle), each with its row's own sub-volume b0 +
// r / E^3 and region. Rows of sub-volumes past B and channels past Cin stay
// the TMA's zeros.
template <int S, int BATCH>
__device__ __forceinline__ void transform_brick(unsigned char* bp, const Params& p, int b0,
                                                int c_base, int worker, int workers) {
  using G = Geom<S>;
  constexpr int end = G::ROWS * 8;
  for (int id0 = worker; id0 < end; id0 += BATCH * workers) {
    uint4 v[BATCH];
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int id = id0 + q * workers;
      if (id < end)
        v[q] = *reinterpret_cast<const uint4*>(bp + (id >> 3) * 128 + (id & 7) * 16);
    }
#pragma unroll
    for (int q = 0; q < BATCH; ++q) {
      const int id = id0 + q * workers;
      if (id >= end) break;
      const int row = id >> 3, pc = id & 7;
      const int j8 = 8 * (pc ^ (row & 7));
      const int sub = row / G::E3, rr = row % G::E3;
      const int b = b0 + sub;
      if (c_base + j8 < p.cin && b < p.nb) {
        const int r = (igemm::region(rr / (G::E * G::E), G::E) * 3 +
                       igemm::region((rr / G::E) % G::E, G::E)) * 3 +
                      igemm::region(rr % G::E, G::E);
        const long long off = ((long long)b * 27 + r) * p.cin + c_base + j8;
        *reinterpret_cast<uint4*>(bp + row * 128 + pc * 16) =
            igemm::affine_mish8(v[q], p.a_tab + off, p.b_tab + off);
      }
    }
  }
}

template <int S, int BNW>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(THREADS, 1)
conv_kernel(const Params p, const __grid_constant__ CUtensorMap xmap,
            const __grid_constant__ CUtensorMap wmap) {
  using G = Geom<S>;
  using C = Cfg<S, BNW>;
  constexpr int ST = C::STAGES, NBUF = G::NBUF, BN = C::BN;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - raw_addr);
  const uint32_t w_s = base + NBUF * G::BRICK_BYTES;
  __shared__ __align__(8) uint64_t bars[2 * ST + 6];
  auto full_w = [&](int st) { return smem_addr(&bars[st]); };
  auto empty_w = [&](int st) { return smem_addr(&bars[ST + st]); };
  auto raw_full = [&](int buf) { return smem_addr(&bars[2 * ST + buf]); };
  auto ready = [&](int buf) { return smem_addr(&bars[2 * ST + 2 + buf]); };
  auto brick_empty = [&](int buf) { return smem_addr(&bars[2 * ST + 4 + buf]); };

  const int cin = p.cin, chunks = p.chunks;
  // the pair's bricks [blo, bhi): brick i is chunk i % chunks of pair tile
  // i / chunks; this CTA (rank r) computes the pair's m block 2 pair + r
  const uint32_t rank = cluster_ctarank(), peer = rank ^ 1u;
  const int cl = blockIdx.x / 2;
  const int blo = range_lo(p.bricks, p.clusters, cl);
  const int bhi = range_lo(p.bricks, p.clusters, cl + 1);
  // warp-uniform for the compiler too, so the role branches are not
  // divergent paths around the wgmma
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    for (int st = 0; st < ST; ++st) {
      mbar_init(full_w(st), 1);
      mbar_init(empty_w(st), 16);  // every consumer warp of both CTAs
    }
    for (int buf = 0; buf < 2; ++buf) {
      mbar_init(raw_full(buf), 1);
      mbar_init(ready(buf), TRANSFORM_THREADS);
      mbar_init(brick_empty(buf), 256);
    }
    mbar_init_fence();
  }
  cluster_sync();  // the peer's barriers exist before anything arrives on them
  TRACE(0, threadIdx.x == 0);  // start

  if (wg == 0 || wg == 3) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(C::OTHER_REGS));
    // transform thread, 0 ... 223: warps 1-3, then warpgroup 3
    const int t = wg == 0 ? (int)threadIdx.x - 32 : (int)threadIdx.x - 384 + 96;
    if (threadIdx.x == 0) {
      // ------------------------------------------------ weight producer
      // both CTAs take the same slices: each loads its half of the 64-column
      // parts of a slice into both (multicast), once both have freed the stage
      constexpr int HALF = BN / 128;
      // while the first brick loads and goes through Mish, the ring takes
      // only its first stages: pull up to PREFETCH slices of its half of
      // the range's weight into L2 meanwhile
      for (int i = blo, k = 0; i < bhi && k < PREFETCH; ++i) {
        const int nblk = i / chunks / p.mpairs, chunk = i % chunks;
        for (int tap = 0; tap < 27 && k < PREFETCH; ++tap, ++k)
#pragma unroll
          for (int h = 0; h < HALF; ++h)
            tma_prefetch_3d(&wmap, nblk * BN + ((int)rank * HALF + h) * 64, chunk * KC, tap);
      }
      int g = 0;
      for (int i = blo; i < bhi; ++i) {
        const int nblk = i / chunks / p.mpairs, chunk = i % chunks;
        for (int tap = 0; tap < 27; ++tap, ++g) {
          const int st = g % ST, round = g / ST;
          if (round > 0) mbar_wait(empty_w(st), (round - 1) & 1);
          mbar_expect_tx(full_w(st), C::STAGE_BYTES);
#pragma unroll
          for (int h = 0; h < HALF; ++h) {
            const int part = (int)rank * HALF + h;
            tma_load_3d_multicast(w_s + st * C::STAGE_BYTES + part * W_PART, &wmap, full_w(st),
                                  nblk * BN + part * 64, chunk * KC, tap, 0x3);
          }
        }
      }
    } else if (t >= 0) {
      // ------------------------------------------------------ transform
      for (int i = blo, item = 0; i < bhi; ++i, ++item) {
        const int u = i / chunks, chunk = i % chunks;
        const int b0 = (2 * (u % p.mpairs) + (int)rank) * G::P;  // the tile's first sub-volume
        const int buf = item % NBUF, use = item / NBUF;
        if (use > 0) mbar_wait(brick_empty(buf), (use - 1) & 1);
        unsigned char* bp = base_ptr + buf * G::BRICK_BYTES;
        const int c_base = chunk * KC;
        if (t == 0) {
          mbar_expect_tx(raw_full(buf), G::BRICK_BYTES);
          tma_load_5d(base + buf * G::BRICK_BYTES, &xmap, raw_full(buf), c_base, 0, 0, 0, b0);
        }
        mbar_wait(raw_full(buf), use & 1);
        TRACE(1, t == 0 && item == 0);  // the first brick has landed
        // the CTA's first brick with the consumer warpgroups, which have
        // nothing to multiply before it; the others alone, one ahead
        if (item == 0)
          transform_brick<S, 1>(bp, p, b0, c_base, t, TRANSFORM_THREADS + 256);
        else
          transform_brick<S, C::BATCH>(bp, p, b0, c_base, t, TRANSFORM_THREADS);
        fence_proxy_async();  // before a later TMA load refills this buffer
        mbar_arrive(ready(buf));
        TRACE(2, t == 0 && item == 0);  // thread 0's share of it is through Mish
      }
    }
  } else {
    // ------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(C::CONSUMER_REGS));
    const int cw = wg - 1;  // columns [cw BNW, (cw + 1) BNW) of the tile
    const int tq = threadIdx.x % 128;
    const int warp = tq / 32, lane = tq % 32;
    // ldmatrix: lane l gives the address of row l % 16 of its warp's 16
    // rows of the m64 tile at k offset 8 (l / 16)
    int row0[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) row0[i] = brick_row<S>(i, 16 * warp + lane % 16);
    const int khalf = lane / 16;

    float acc[2][BNW / 2];
    uint32_t a[2][2][2][4];  // [half of the slice][m tile][k16 step][fragment]

    auto load_a = [&](uint32_t (&frag)[2][2][4], uint32_t brick, int tap, int h) {
      const int kx = tap / 9, ky = (tap / 3) % 3, kz = tap % 3;
      const int toff = (kx * G::E + ky) * G::E + kz;
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
    // B of k16 step kk: 16 rows of the slice, from this warpgroup's first
    // 64-column part on, parts W_PART apart
    const uint32_t col_part = cw * (BNW / 64) * W_PART;
    auto mma_half = [&](const uint32_t (&frag)[2][2][4], uint32_t wst, int h) {
#pragma unroll
      for (int k2 = 0; k2 < 2; ++k2) {
        const uint64_t db = make_desc(wst + col_part + (2 * h + k2) * 16 * 128, W_PART, 1024, 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) igemm::wgmma_rs<BNW>(acc[i], frag[i][k2], db);
      }
    };
    // a stage is free once every consumer warp of both CTAs is done with it
    auto release = [&](int st) {
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(empty_w(st));
        mbar_arrive_cluster(empty_w(st), peer);
      }
    };

    {  // their share of the first brick (buffer 0), then each other's writes
      const int u = blo / chunks;
      mbar_wait(raw_full(0), 0);
      transform_brick<S, 1>(base_ptr, p, (2 * (u % p.mpairs) + (int)rank) * G::P,
                            (blo % chunks) * KC, TRANSFORM_THREADS + (int)threadIdx.x - 128,
                            TRANSFORM_THREADS + 256);
      fence_proxy_async();  // before a later TMA load refills the buffer
      named_bar_sync(2, 256);
    }

    int g = 0, first_chunk = 0;
    for (int i = blo, item = 0; i < bhi; ++i, ++item) {
      const int u = i / chunks, chunk = i % chunks;
      if (i == blo || chunk == 0) {  // a tile's first brick in this range
        first_chunk = chunk;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
#pragma unroll
          for (int j = 0; j < BNW / 2; ++j) acc[m][j] = 0.0f;
          fence_regs(acc[m]);
        }
      }
      const int buf = item % NBUF;
      mbar_wait(ready(buf), (item / NBUF) & 1);
      TRACE(3, threadIdx.x == 128 && item == 0);  // the first products start
      const uint32_t brick = base + buf * G::BRICK_BYTES;
      load_a(a[0], brick, 0, 0);
      for (int tap = 0; tap < 27; ++tap) {
        const int gs = g + tap;
        const int st = gs % ST;
        mbar_wait(full_w(st), (gs / ST) & 1);
        const uint32_t wst = w_s + st * C::STAGE_BYTES;
        wgmma_fence();
        mma_half(a[0], wst, 0);
        wgmma_commit();
        wgmma_wait<1>();  // the previous slice's second half is done
        igemm::fence_frags(a[1]);
        if (tap > 0) release((gs - 1) % ST);
        load_a(a[1], brick, tap, 1);
        wgmma_fence();
        mma_half(a[1], wst, 1);
        wgmma_commit();
        wgmma_wait<1>();  // this slice's first half is done
        igemm::fence_frags(a[0]);
        if (tap < 26) load_a(a[0], brick, tap + 1, 0);
      }
      wgmma_wait<0>();
      TRACE(4, threadIdx.x == 128 && i == bhi - 1);  // the last products are done
#pragma unroll
      for (int m = 0; m < 2; ++m) fence_regs(acc[m]);
      igemm::fence_frags(a[1]);
      g += 27;
      release((g - 1) % ST);
      mbar_arrive(brick_empty(buf));
      if (!(i == bhi - 1 || chunk == chunks - 1)) continue;

      // ---- the tile's last brick in this range. Accumulator element j of
      // m64 tile m is the tile's row 64 m + 16 warp + lane/4 + 8 ((j/2) % 2),
      // this warpgroup's column (j/4) * 8 + 2 (lane % 4) + j % 2. A whole
      // tile goes out as bf16; a cut one as fp32 partials into this CTA's
      // slot (0: the tile its range starts in, 1: the one it ends in).
      const int mb = 2 * (u % p.mpairs) + (int)rank, nblk = u / p.mpairs;
      const bool whole = first_chunk == 0 && chunk == chunks - 1;
      const int slot = u == blo / chunks ? 0 : 1;
      const int col = cw * BNW + 2 * (lane % 4);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int o = 64 * m + 16 * warp + lane / 4 + 8 * hh;
          if (whole) {
            const long long vox = (long long)mb * TILE_ROWS + o;
            if (vox >= (long long)p.nb * G::V) continue;
            const int n0 = nblk * BN + col;
            __nv_bfloat16* dst = p.out + vox * p.cout + n0;
#pragma unroll
            for (int jn = 0; jn < BNW / 8; ++jn)
              if (n0 + jn * 8 < p.cout)
                *reinterpret_cast<__nv_bfloat162*>(dst + jn * 8) = __floats2bfloat162_rn(
                    acc[m][4 * jn + 2 * hh], acc[m][4 * jn + 2 * hh + 1]);
          } else {
            float* dst = p.ws + (((long long)blockIdx.x * 2 + slot) * TILE_ROWS + o) * BN + col;
#pragma unroll
            for (int jn = 0; jn < BNW / 8; ++jn)
              *reinterpret_cast<float2*>(dst + jn * 8) =
                  make_float2(acc[m][4 * jn + 2 * hh], acc[m][4 * jn + 2 * hh + 1]);
          }
        }
    }
  }
  TRACE(5, threadIdx.x == 128);  // the epilogue is done
  // no CTA leaves while its peer may still arrive on its barriers
  __syncwarp();
  cluster_sync();
}

// The cut tiles, each summed from the partials of the CTAs whose ranges
// hold its bricks, in the order of the CTAs, and stored as bf16.
// blockIdx.y: the cut tile; blockIdx.x: 256 groups of 4 columns of its 128
// x BN.
template <int S, int BN>
__global__ void __launch_bounds__(256)
reduce_partials(const Params p, const CutTiles cuts) {
  const int e = blockIdx.x * 256 + threadIdx.x;
  if (e >= TILE_ROWS * BN / 4) return;
  const int mb = cuts.mb[blockIdx.y], nblk = cuts.nblk[blockIdx.y];
  const int o = e / (BN / 4), c = (e % (BN / 4)) * 4;
  const long long vox = (long long)mb * TILE_ROWS + o;
  const int n = nblk * BN + c;
  if (vox >= (long long)p.nb * Geom<S>::V || n >= p.cout) return;
  const int u = nblk * p.mpairs + mb / 2, rank = mb % 2;
  const int c0 = cluster_of(p.bricks, p.clusters, u * p.chunks);
  const int c1 = cluster_of(p.bricks, p.clusters, u * p.chunks + p.chunks - 1);
  auto partial = [&](int cl) {
    const int slot = range_lo(p.bricks, p.clusters, cl) / p.chunks == u ? 0 : 1;
    return *reinterpret_cast<const float4*>(
        p.ws + (((long long)(2 * cl + rank) * 2 + slot) * TILE_ROWS + o) * BN + c);
  };
  float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  auto add = [&](const float4& v) {
    sum.x += v.x;
    sum.y += v.y;
    sum.z += v.z;
    sum.w += v.w;
  };
  // eight loads in flight, added in CTA order
  int cl = c0;
  for (; cl + 7 <= c1; cl += 8) {
    float4 v[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) v[q] = partial(cl + q);
#pragma unroll
    for (int q = 0; q < 8; ++q) add(v[q]);
  }
  for (; cl <= c1; ++cl) add(partial(cl));
  __nv_bfloat162 pair[2] = {__floats2bfloat162_rn(sum.x, sum.y),
                            __floats2bfloat162_rn(sum.z, sum.w)};
  *reinterpret_cast<uint2*>(p.out + vox * p.cout + n) = *reinterpret_cast<const uint2*>(pair);
}

template <int S, int BNW>
int launch_cfg(const Params& p, const CUtensorMap& xmap, const CUtensorMap& wmap,
               const CutTiles& cuts, cudaStream_t stream) {
  auto kernel = conv_kernel<S, BNW>;
  constexpr int smem = Cfg<S, BNW>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<2 * p.clusters, THREADS, smem, stream>>>(p, xmap, wmap);
  if ((err = cudaGetLastError()) != cudaSuccess || cuts.n == 0) return (int)err;
  constexpr int BN = 2 * BNW;
  const dim3 grid((TILE_ROWS * BN / 4 + 255) / 256, cuts.n);
  reduce_partials<S, BN><<<grid, 256, 0, stream>>>(p, cuts);
  return (int)cudaGetLastError();
}

template <int S>
int launch(void* encode, const void* xh, const float* a_tab, const float* b_tab, const void* w,
           void* out, float* ws, int nb, int cin, int cout, int bnw, int ctas,
           cudaStream_t stream) {
  using G = Geom<S>;
  EncodeTiled enc = reinterpret_cast<EncodeTiled>(encode);
  if (enc == nullptr || nb <= 0 || cin <= 0 || cin % 8 != 0 || cout <= 0 || cout % 8 != 0 ||
      (bnw != 64 && bnw != 128) || ctas <= 0 || ctas % 2 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.a_tab = a_tab;
  p.b_tab = b_tab;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.ws = ws;
  p.nb = nb;
  p.cin = cin;
  p.cout = cout;
  p.chunks = (cin + KC - 1) / KC;
  p.mblocks = (nb + G::P - 1) / G::P;
  p.mpairs = (p.mblocks + 1) / 2;
  p.clusters = ctas / 2;
  const int nblocks = (cout + 2 * bnw - 1) / (2 * bnw);
  const long long bricks = (long long)p.mpairs * nblocks * p.chunks;
  if (bricks > 0x7fffffffLL || p.clusters > bricks || p.mblocks > 0x7fff || nblocks > 0x7fff)
    return (int)cudaErrorInvalidValue;
  p.bricks = (int)bricks;
  // the tiles of a pair tile that a range starts inside (one per real m
  // block of the pair)
  CutTiles cuts;
  cuts.n = 0;
  for (int c = 1; c < p.clusters; ++c) {
    const int b = range_lo(p.bricks, p.clusters, c);
    const int u = b / p.chunks;
    if (b % p.chunks == 0 || range_lo(p.bricks, p.clusters, c - 1) > u * p.chunks) continue;
    for (int r = 0; r < 2; ++r) {
      const int mb = 2 * (u % p.mpairs) + r;
      if (mb >= p.mblocks) continue;
      if (cuts.n == MAX_CUT) return (int)cudaErrorInvalidValue;
      cuts.mb[cuts.n] = (short)mb;
      cuts.nblk[cuts.n] = (short)(u / p.mpairs);
      ++cuts.n;
    }
  }
  if (cuts.n > 0 && ws == nullptr) return (int)cudaErrorInvalidValue;

  CUtensorMap wmap, xmap;
  {  // weight (27, Cin, Cout), innermost first; 64 x 64 boxes
    const cuuint64_t dims[3] = {(cuuint64_t)cout, (cuuint64_t)cin, 27};
    const cuuint64_t strides[2] = {(cuuint64_t)cout * 2, (cuuint64_t)cin * cout * 2};
    const cuuint32_t box[3] = {64, KC, 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    if (enc(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(w), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  {  // input (B, E, E, E, Cin), innermost first; P whole halo'd sub-volumes a box
    const cuuint64_t e = (cuuint64_t)G::E, row = (cuuint64_t)cin * 2;
    const cuuint64_t dims[5] = {(cuuint64_t)cin, e, e, e, (cuuint64_t)nb};
    const cuuint64_t strides[4] = {row, row * e, row * e * e, row * e * e * e};
    const cuuint32_t box[5] = {KC, G::E, G::E, G::E, G::P};
    const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
    if (enc(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(xh), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return (int)cudaErrorInvalidValue;
  }
  return bnw == 64 ? launch_cfg<S, 64>(p, xmap, wmap, cuts, stream)
                   : launch_cfg<S, 128>(p, xmap, wmap, cuts, stream);
}

}  // namespace small_edge

// xh (B, S+2, S+2, S+2, Cin) bf16, S = 4 or 2, Cin % 8 == 0; tables (B,
// 27, Cin) fp32; w (27, Cin, Cout) bf16, Cout % 8 == 0; out (B, S, S, S,
// Cout) bf16; ws (ctas, 2, 128, 2 bnw) fp32 or null when no CTA range
// starts inside a tile; bnw = 64 or 128 columns per consumer warpgroup;
// ctas even (pairs of CTAs, one cluster each), ctas / 2 <= the pair tiles'
// bricks (ops/kernels/fused_block.py::small_edge_plan). Returns a
// cudaError_t.
extern "C" int fused_block_small_launch(void* encode, const void* xh, const float* a_tab,
                                        const float* b_tab, const void* w, void* out, void* ws,
                                        int nb, int s, int cin, int cout, int bnw, int ctas,
                                        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wsf = static_cast<float*>(ws);
  if (s == 4)
    return small_edge::launch<4>(encode, xh, a_tab, b_tab, w, out, wsf, nb, cin, cout, bnw,
                                 ctas, st);
  if (s == 2)
    return small_edge::launch<2>(encode, xh, a_tab, b_tab, w, out, wsf, nb, cin, cout, bnw,
                                 ctas, st);
  return (int)cudaErrorInvalidValue;
}

#ifdef SMALL_EDGE_TRACE
// Where the phase stamps go: (ctas, 8) int64, or null for none.
extern "C" int set_trace(void* p) {
  return (int)cudaMemcpyToSymbol(small_edge::g_trace, &p, sizeof(p));
}
#endif
