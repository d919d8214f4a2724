// VALID 3x3x3 convolution of halo'd sub-volumes on Hopper (the init conv).
//
// Replaces diffusioniqt_tpu/ops/pallas/conv3d.py::conv3d_valid:
//   (B, s+2, s+2, s+2, Cin) bf16 x packed weight -> (B, s, s, s, Cout) bf16,
//   fp32 accumulation. The conv bias is added by the caller.
//
// Two routes, chosen from the shape by the Python wrapper
// (ops/kernels/conv3d.py::route):
//
// * Cin <= 8 (the init conv: Cin = 2), small_cin_kernel below. Bound: bytes.
//   At the serve batch (216, 32^3, 2 -> 64) the output alone is
//   216 * 32^3 * 64 * 2 B = 906 MB and the halo'd input 34 MB: 0.28 ms at
//   3.35 TB/s, while the real product (K = 27 * 2 = 54) is 49 GFLOP,
//   0.05 ms of tensor-core time. Padding Cin to a 32-channel chunk, as the
//   implicit GEMM does, multiplies the product by 16 and made it the whole
//   cost. Here K is dense: k = tap * Cin + c, tap = (kx*3+ky)*3+kz, padded
//   only to the next multiple of 16 (54 -> 64), weight (K_pad, Cout).
//   Persistent blocks walk bricks of 256 output voxels (whole z-runs where
//   s allows), all of Cout per block:
//     1. the brick's halo'd input (about 3 KB at Cin = 2) comes in by
//        cp.async into one of two buffers while the other brick computes;
//     2. the weights stay in shared memory for the block's lifetime;
//     3. each mma.sync A fragment register holds the pair (k, k+1), which
//        for even Cin is one 32-bit word of the brick at the voxel's tap
//        offset: the A fragments are read straight from the brick, and
//        k >= 27 * Cin is a register set to zero, never stale shared memory;
//     4. the fp32 tile goes to bf16 through a padded shared tile and out
//        with 16-byte streaming stores, whole output rows per warp.
//   The product is mma.sync m16n8k16, not wgmma: the
//   padded product is 58 GFLOP, 0.06 ms at the bf16 peak, against 0.28 ms
//   of stores. Whether wgmma would move this kernel's time is not measured.
//
// * Cin > 8: the implicit GEMM of igemm.cuh (wgmma + TMA, the fused
//   block's GEMM without its Mish prologue), weight (27, Cin, Cout).

#include "igemm.cuh"

namespace small {

constexpr int THREADS = 256;  // 8 warps x 32 voxel rows
constexpr int BM = 256;       // output voxels (GEMM rows) per brick
constexpr int NP = 64;        // output channels per pass
constexpr int C_LD = NP + 8;  // staging row pitch (bf16): conflict-free

struct Params {
  const __nv_bfloat16* xh;
  const __nv_bfloat16* w;  // (K_pad, Cout)
  __nv_bfloat16* out;
  int nb, s, cout;
  int tx, ty, tz;          // brick edge per axis, tx * ty * tz = BM
  int ly, lz;              // log2(ty), log2(tz): every edge is a power of two
};

template <int CIN>
struct Dims {
  static constexpr int K = 27 * CIN;
  static constexpr int KPAD = (K + 15) / 16 * 16;
  static constexpr int KSTEPS = KPAD / 16;
  static constexpr int PAIRS = CIN % 2 == 0 ? 1 : 2;  // loads per A register
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(dst), "l"(src));
}

__host__ __device__ inline int halo_voxels(int tx, int ty, int tz) {
  return (tx + 2) * (ty + 2) * (tz + 2);
}

template <int CIN>
__global__ void __launch_bounds__(THREADS, 2)
small_cin_kernel(const Params p) {
  using Dm = Dims<CIN>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = p.s, E = S + 2;
  const int TX = p.tx, TY = p.ty, TZ = p.tz;
  const int HY = TY + 2, HZ = TZ + 2;
  const int nvox = halo_voxels(TX, TY, TZ);
  const int brick_elems = (nvox * CIN + 7) / 8 * 8;
  const int cpad = (p.cout + NP - 1) / NP * NP;
  const int w_ld = cpad + 8;
  __nv_bfloat16* bricks = reinterpret_cast<__nv_bfloat16*>(smem);  // 2 buffers
  __nv_bfloat16* wsm = bricks + 2 * brick_elems;                   // KPAD x w_ld
  __nv_bfloat16* stage = wsm + Dm::KPAD * w_ld;                    // BM x C_LD

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int per_x = S / TX, per_y = S / TY, per_z = S / TZ;
  const int per_sub = per_x * per_y * per_z;
  const int total = p.nb * per_sub;

  // halo'd input brick -> buffer: z-runs of HZ voxels are contiguous in xh
  auto load_brick = [&](int buf, int brick) {
    const int b = brick / per_sub, r = brick % per_sub;
    const int x0 = (r / (per_y * per_z)) * TX;
    const int y0 = ((r / per_z) % per_y) * TY;
    const int z0 = (r % per_z) * TZ;
    __nv_bfloat16* dst = bricks + buf * brick_elems;
    const int run = HZ * CIN;  // elements per z-run
    if constexpr (CIN % 2 == 0) {
      const int words = run / 2;
      for (int id = tid; id < (TX + 2) * HY * words; id += THREADS) {
        const int row = id / words, wi = id % words;
        const int hx = row / HY, hy = row % HY;
        const long long g =
            ((((long long)b * E + x0 + hx) * E + y0 + hy) * E + z0) * CIN + 2 * wi;
        cp_async4(sm90::smem_addr(dst + row * run + 2 * wi), p.xh + g);
      }
    } else {
      for (int id = tid; id < (TX + 2) * HY * run; id += THREADS) {
        const int row = id / run, e = id % run;
        const int hx = row / HY, hy = row % HY;
        const long long g = ((((long long)b * E + x0 + hx) * E + y0 + hy) * E + z0) * CIN + e;
        dst[row * run + e] = p.xh[g];
      }
    }
  };

  // A fragment rows of this warp: m16 tile i, half h -> brick element offset
  int row_off[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * 32 + i * 16 + lane / 4 + 8 * h;
      const int mx = m / (TY * TZ), my = (m / TZ) % TY, mz = m % TZ;
      row_off[i][h] = ((mx * HY + my) * HZ + mz) * CIN;
    }
  // A fragment columns: k-step ks, upper half hi (k + 8), element e -> the
  // tap's brick offset plus the channel, or -1 past K (a zero register)
  int k_off[Dm::KSTEPS][2][Dm::PAIRS];
#pragma unroll
  for (int ks = 0; ks < Dm::KSTEPS; ++ks)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi)
#pragma unroll
      for (int e = 0; e < Dm::PAIRS; ++e) {
        const int k = ks * 16 + hi * 8 + (lane % 4) * 2 + e;
        const int tap = k / CIN, c = k % CIN;
        const int kx = tap / 9, ky = (tap / 3) % 3, kz = tap % 3;
        k_off[ks][hi][e] = k < Dm::K ? ((kx * HY + ky) * HZ + kz) * CIN + c : -1;
      }

  int brick = blockIdx.x;
  if (brick < total) load_brick(0, brick);
  sm90::cp_async_commit();

  // weights -> shared memory once, columns past Cout zero
  for (int id = tid; id < Dm::KPAD * (cpad / 8); id += THREADS) {
    const int r = id / (cpad / 8), n = (id % (cpad / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (n < p.cout) v = __ldg(reinterpret_cast<const uint4*>(p.w + (long long)r * p.cout + n));
    *reinterpret_cast<uint4*>(wsm + r * w_ld + n) = v;
  }
  // ldmatrix.trans row address of the B fragments (as in igemm.cuh)
  const int b_off = (((lane / 8) % 2) * 8 + lane % 8) * w_ld + (lane / 16) * 8;

  for (int it = 0; brick < total; brick += gridDim.x, ++it) {
    const int nxt = brick + gridDim.x;
    if (nxt < total) load_brick((it + 1) & 1, nxt);
    sm90::cp_async_commit();   // (possibly empty) group: uniform wait count
    sm90::cp_async_wait_one(); // this brick has landed
    __syncthreads();            // ... for every thread; staging free again
    const __nv_bfloat16* br = bricks + (it & 1) * brick_elems;

    const int b = brick / per_sub, r = brick % per_sub;
    const int x0 = (r / (per_y * per_z)) * TX;
    const int y0 = ((r / per_z) % per_y) * TY;
    const int z0 = (r % per_z) * TZ;

    for (int n0 = 0; n0 < p.cout; n0 += NP) {
      float acc[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

#pragma unroll
      for (int ks = 0; ks < Dm::KSTEPS; ++ks) {
        // register q of an m16n8k16 A fragment: row half q % 2, k half q / 2
        uint32_t a[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int h = q % 2, hi = q / 2;
            if constexpr (Dm::PAIRS == 1) {
              const int ko = k_off[ks][hi][0];
              a[i][q] = ko < 0 ? 0u
                               : *reinterpret_cast<const uint32_t*>(br + row_off[i][h] + ko);
            } else {
              const int k0 = k_off[ks][hi][0], k1 = k_off[ks][hi][1];
              const uint32_t lo =
                  k0 < 0 ? 0u : *reinterpret_cast<const unsigned short*>(br + row_off[i][h] + k0);
              const uint32_t up =
                  k1 < 0 ? 0u : *reinterpret_cast<const unsigned short*>(br + row_off[i][h] + k1);
              a[i][q] = lo | (up << 16);
            }
          }
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          uint32_t bf[4];
          sm90::ldmatrix_x4_trans(bf,
                                   sm90::smem_addr(wsm + b_off + ks * 16 * w_ld + n0 + jj * 16));
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            sm90::mma_bf16(acc[i][2 * jj], a[i], bf[0], bf[1]);
            sm90::mma_bf16(acc[i][2 * jj + 1], a[i], bf[2], bf[3]);
          }
        }
      }

      if (n0 > 0) __syncthreads();  // the previous pass's stores have read staging
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int row = warp * 32 + i * 16 + lane / 4;
          const int col = j * 8 + (lane % 4) * 2;
          *reinterpret_cast<__nv_bfloat162*>(stage + row * C_LD + col) =
              __floats2bfloat162_rn(acc[i][j][0], acc[i][j][1]);
          *reinterpret_cast<__nv_bfloat162*>(stage + (row + 8) * C_LD + col) =
              __floats2bfloat162_rn(acc[i][j][2], acc[i][j][3]);
        }
      __syncthreads();
      // 16-byte streaming stores: consecutive threads cover one voxel's
      // channels, then the next voxel of the z-run
      const int n = n0 + (tid % (NP / 8)) * 8;  // the same channels every row
      if (n < p.cout) {
        __nv_bfloat16* corner = p.out + ((((long long)b * S + x0) * S + y0) * S + z0) * p.cout + n;
#pragma unroll
        for (int r8 = 0; r8 < BM * (NP / 8) / THREADS; ++r8) {
          const int row = tid / (NP / 8) + r8 * (THREADS / (NP / 8));
          const int mx = row >> (p.ly + p.lz), my = (row >> p.lz) & (TY - 1), mz = row & (TZ - 1);
          __stcs(reinterpret_cast<uint4*>(corner + ((mx * S + my) * S + mz) * p.cout),
                 *reinterpret_cast<const uint4*>(stage + row * C_LD + n - n0));
        }
      }
    }
  }
  sm90::cp_async_wait_all();
}

template <int CIN>
int launch(const Params& p, cudaStream_t stream) {
  using Dm = Dims<CIN>;
  const int brick_elems = (halo_voxels(p.tx, p.ty, p.tz) * CIN + 7) / 8 * 8;
  const int cpad = (p.cout + NP - 1) / NP * NP;
  const int smem = 2 * brick_elems * 2 + Dm::KPAD * (cpad + 8) * 2 + BM * C_LD * 2;
  auto kernel = small_cin_kernel<CIN>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long long bricks = (long long)p.nb * (p.s / p.tx) * (p.s / p.ty) * (p.s / p.tz);
  const long long grid = bricks < (long long)per_sm * sms ? bricks : (long long)per_sm * sms;
  if (bricks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace small

// The implicit-GEMM route (Cin > 8): weight (27, Cin, Cout), bn = 64 or
// 128, whole units on ctas CTAs (1 to the units). Returns a cudaError_t.
extern "C" int conv3d_valid_launch(void* encode, const void* xh, const void* w, void* out,
                                   int nb, int s, int cin, int cout, int bn, int ctas,
                                   void* stream) {
  return igemm::launch<false>(encode, xh, nullptr, nullptr, w, out, nullptr, nb, s, cin, cout, bn,
                              igemm::KC, 0, 0, ctas, static_cast<cudaStream_t>(stream));
}

// The small-Cin route (1 <= Cin <= 8): weight (K_pad, Cout), row
// k = tap * Cin + c, K_pad = 27 * Cin rounded up to 16. Needs s % 8 == 0,
// Cout % 8 == 0 (Cout <= 256) and 16-byte aligned pointers (the Python
// wrapper checks). The brick is 256 voxels: (2, 4, 32) when s % 32 == 0,
// (4, 4, 16) when s % 16 == 0, else (4, 8, 8). Returns a cudaError_t.
extern "C" int conv3d_small_cin_launch(const void* xh, const void* w, void* out, int nb, int s,
                                       int cin, int cout, void* stream) {
  small::Params p;
  p.xh = static_cast<const __nv_bfloat16*>(xh);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.nb = nb;
  p.s = s;
  p.cout = cout;
  p.tz = s % 32 == 0 ? 32 : (s % 16 == 0 ? 16 : 8);
  p.ty = p.tz == 8 ? 8 : 4;
  p.tx = small::BM / (p.ty * p.tz);
  p.ly = p.ty == 8 ? 3 : 2;
  p.lz = p.tz == 32 ? 5 : (p.tz == 16 ? 4 : 3);
  if (nb <= 0 || s <= 0 || s % 8 != 0 || cout % 8 != 0 || cout > 256 || s % p.tx != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (cin) {
    case 1: return small::launch<1>(p, st);
    case 2: return small::launch<2>(p, st);
    case 3: return small::launch<3>(p, st);
    case 4: return small::launch<4>(p, st);
    case 5: return small::launch<5>(p, st);
    case 6: return small::launch<6>(p, st);
    case 7: return small::launch<7>(p, st);
    case 8: return small::launch<8>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
