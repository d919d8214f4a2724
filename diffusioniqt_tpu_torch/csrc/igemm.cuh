// Implicit-GEMM VALID 3x3x3 convolution over halo'd sub-volumes, shared by
// conv3d.cu (plain conv) and fused_block.cu (conv with a fused
// GroupNorm-affine + Mish prologue).
//
//   xh  (B, E, E, E, Cin) bf16, E = S + 2 (channels-last, halo included)
//   w   (27 * Cin_pad, Cout) bf16, row k = tap * Cin_pad + c,
//       tap = (kx*3+ky)*3+kz, Cin_pad = Cin rounded up to 32 (zero rows)
//   out (B, S, S, S, Cout) bf16, fp32 accumulation
//
// As a matrix product: M = B * S^3 output voxels, N = Cout, K = 27 * Cin.
// A block owns a brick of BM output voxels (TX x TY x TZ) of one
// sub-volume and BN output channels, with 8 warps of 32 x 32 each
// (mma.sync m16n8k16 bf16, fp32 accumulators in registers). For each
// chunk of 32 input channels:
//   1. the brick's input with its one-voxel halo, (TX+2)(TY+2)(TZ+2)
//      voxels x 32 channels, is read from xh once and stored to shared
//      memory (FUSED: as mish(A_r * x + B_r), so each input value is
//      transformed once per block, not once per tap);
//   2. the 27 taps run from that brick: a tap is a shifted view of it, and
//      ldmatrix takes one row address per lane, so the A fragments are
//      gathered straight from the brick with no im2col copy. The tap's
//      32 x BN weight slice streams through a 3-stage cp.async ring.
// The fp32 tile goes back through shared memory for 16-byte stores.
//
// FUSED: region r = (rx*3+ry)*3+rz of a halo'd voxel is, per axis, 0 on the
// low halo plane, 2 on the high one, 1 inside. A missing neighbour has
// A = B = 0, so the halo there is mish(0) = 0, the reference's zero
// padding. Mish uses the one-exp identity with the input clamped at 20, as
// the Pallas kernel does.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

constexpr int BK = 32;          // input channels per chunk (the K step)
constexpr int THREADS = 256;
constexpr int A_LD = BK + 8;    // bf16 per brick voxel row: 80 B, ldmatrix conflict-free
constexpr int STAGES = 3;       // weight-slice ring

struct Params {
  const __nv_bfloat16* xh;
  const __nv_bfloat16* w;
  const float* a_tab;  // (B, 27, Cin), FUSED only
  const float* b_tab;
  __nv_bfloat16* out;
  int nb, s, cin, cin_pad, cout;
  int tx, ty, tz;      // output brick, set by launch()
};

__device__ __forceinline__ float mish1(float v) {
  const float u = __expf(fminf(v, 20.0f));
  const float t = u * (u + 2.0f);
  return __fdividef(v * t, t + 2.0f);
}

__device__ __forceinline__ int region(int p, int e) {
  return p == 0 ? 0 : (p == e - 1 ? 2 : 1);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// 8 bf16 values of channels [c, c+8) -> mish(a * x + b), 8 bf16
__device__ __forceinline__ uint4 affine_mish8(uint4 raw, const float* ap,
                                              const float* bp) {
  const float4 a0 = __ldg(reinterpret_cast<const float4*>(ap));
  const float4 a1 = __ldg(reinterpret_cast<const float4*>(ap) + 1);
  const float4 b0 = __ldg(reinterpret_cast<const float4*>(bp));
  const float4 b1 = __ldg(reinterpret_cast<const float4*>(bp) + 1);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    o[j] = __floats2bfloat162_rn(mish1(fmaf(av[2 * j], f.x, bv[2 * j])),
                                 mish1(fmaf(av[2 * j + 1], f.y, bv[2 * j + 1])));
  }
  return res;
}

template <int BM>
__host__ __device__ constexpr int max_halo_voxels() {
  // bricks chosen by launch(): BM=128 -> (2,4,16) or (2,8,8); BM=64 ->
  // (1,4,16) or (1,8,8); the halo'd brick is the larger of the two
  return BM == 128 ? 4 * 6 * 18 : 3 * 6 * 18;
}

template <int BM, int BN>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ab = max_halo_voxels<BM>() * A_LD * 2 + STAGES * BK * (BN + 8) * 2;
  constexpr int c = BM * (BN + 4) * 4;
  return ab > c ? ab : c;
}

template <bool FUSED, bool VEC8, int BM, int BN>
__global__ void __launch_bounds__(THREADS, 2)
conv_kernel(const Params p) {
  constexpr int WARPS_M = BM / 32;
  static_assert(WARPS_M * (BN / 32) == THREADS / 32, "8 warps of 32x32");
  constexpr int B_LD = BN + 8;
  constexpr int C_LD = BN + 4;
  constexpr int GROUPS = BK / 8;  // 8-channel groups per brick voxel row

  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* brick = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* bring = brick + max_halo_voxels<BM>() * A_LD;
  float* csm = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int wm = warp % WARPS_M;
  const int wn = warp / WARPS_M;
  const int S = p.s, E = S + 2, cin = p.cin;
  const int TX = p.tx, TY = p.ty, TZ = p.tz;
  const int HY = TY + 2, HZ = TZ + 2;
  const int nvox = (TX + 2) * HY * HZ;
  const int tiles_y = S / TY, tiles_z = S / TZ;
  const int tiles = (S / TX) * tiles_y * tiles_z;
  const int b = blockIdx.x / tiles;
  const int tile = blockIdx.x % tiles;
  const int x0 = (tile / (tiles_y * tiles_z)) * TX;
  const int y0 = ((tile / tiles_z) % tiles_y) * TY;
  const int z0 = (tile % tiles_z) * TZ;
  const int n0 = blockIdx.y * BN;
  const int nchunks = p.cin_pad / BK;
  const int steps = nchunks * 27;

  // ldmatrix row addresses: lane l feeds row (l/8 % 2)*8 + l%8 of the
  // m16 tile at k offset (l/16)*8 (A), and k row (l/8 % 2)*8 + l%8 at
  // n offset (l/16)*8 (B, transposed load)
  int a_off[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm * 32 + i * 16 + ((lane / 8) % 2) * 8 + lane % 8;
    const int mx = m / (TY * TZ), my = (m / TZ) % TY, mz = m % TZ;
    a_off[i] = ((mx * HY + my) * HZ + mz) * A_LD + (lane / 16) * 8;
  }
  const int b_off = (((lane / 8) % 2) * 8 + lane % 8) * B_LD + wn * 32 + (lane / 16) * 8;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.0f;

  // weight slice of one (chunk, tap) step -> ring stage
  auto issue_weights = [&](int step) {
    const int chunk = step / 27, tap = step % 27;
    const long long krow0 = (long long)tap * p.cin_pad + chunk * BK;
    __nv_bfloat16* dst = bring + (step % STAGES) * BK * B_LD;
    for (int id = tid; id < BK * (BN / 8); id += THREADS) {
      const int r = id / (BN / 8);
      const int n = n0 + (id % (BN / 8)) * 8;
      const bool ok = n < p.cout;
      const __nv_bfloat16* src = ok ? p.w + (krow0 + r) * p.cout + n : p.w;
      cp_async16(smem_addr(dst + r * B_LD + (id % (BN / 8)) * 8), src, ok ? 16 : 0);
    }
  };

  // halo'd input brick of one channel chunk -> shared memory, transformed
  auto load_brick = [&](int chunk) {
    const int c0 = chunk * BK;
    constexpr int BATCH = 4;  // loads in flight per thread
    for (int base = tid; base < nvox * GROUPS; base += THREADS * BATCH) {
      uint4 v[BATCH];
      int c_of[BATCH], r_of[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int id = base + u * THREADS;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        c_of[u] = cin;  // marks "nothing loaded"
        r_of[u] = 0;
        if (id < nvox * GROUPS) {
          const int vox = id / GROUPS;
          const int c = c0 + (id % GROUPS) * 8;
          const int hz = vox % HZ, hy = (vox / HZ) % HY, hx = vox / (HZ * HY);
          const int px = x0 + hx, py = y0 + hy, pz = z0 + hz;
          const long long g = ((((long long)b * E + px) * E + py) * E + pz) * cin + c;
          if (c < cin) {
            c_of[u] = c;
            r_of[u] = (region(px, E) * 3 + region(py, E)) * 3 + region(pz, E);
            if constexpr (VEC8) {
              v[u] = __ldg(reinterpret_cast<const uint4*>(p.xh + g));
            } else {
              __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&v[u]);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (c + j < cin) e[j] = p.xh[g + j];
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < BATCH; ++u) {
        const int id = base + u * THREADS;
        if (id >= nvox * GROUPS) break;
        uint4 val = v[u];
        if constexpr (FUSED) {
          if (c_of[u] < cin) {
            const long long co = ((long long)b * 27 + r_of[u]) * cin + c_of[u];
            if constexpr (VEC8) {
              val = affine_mish8(val, p.a_tab + co, p.b_tab + co);
            } else {
              __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
              for (int j = 0; j < 8; ++j)
                if (c_of[u] + j < cin)
                  e[j] = __float2bfloat16(mish1(
                      fmaf(p.a_tab[co + j], __bfloat162float(e[j]), p.b_tab[co + j])));
            }
          }
        }
        *reinterpret_cast<uint4*>(brick + (id / GROUPS) * A_LD + (id % GROUPS) * 8) = val;
      }
    }
  };

  issue_weights(0);
  cp_async_commit();
  for (int chunk = 0; chunk < nchunks; ++chunk) {
    load_brick(chunk);
    for (int tap = 0; tap < 27; ++tap) {
      const int step = chunk * 27 + tap;
      if (step + 1 < steps) issue_weights(step + 1);
      cp_async_commit();     // (possibly empty) group: uniform wait count
      cp_async_wait_one();   // this step's weights have landed
      __syncthreads();       // ... for every thread; brick stores visible
      const __nv_bfloat16* bt = bring + (step % STAGES) * BK * B_LD;
      const int kx = tap / 9, ky = (tap / 3) % 3, kz = tap % 3;
      const int tap_off = ((kx * HY + ky) * HZ + kz) * A_LD;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t a[2][4], bf[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          ldmatrix_x4(a[i], smem_addr(brick + a_off[i] + tap_off + kk));
#pragma unroll
        for (int j = 0; j < 2; ++j)
          ldmatrix_x4_trans(bf[j], smem_addr(bt + b_off + kk * B_LD + j * 16));
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            mma_bf16(acc[i][2 * j], a[i], bf[j][0], bf[j][1]);
            mma_bf16(acc[i][2 * j + 1], a[i], bf[j][2], bf[j][3]);
          }
      }
    }
    __syncthreads();  // every warp is done with this chunk's brick
  }

  // --- epilogue: fp32 tile through shared memory, bf16 16-byte stores ----
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = wm * 32 + i * 16 + lane / 4;
      const int col = wn * 32 + j * 8 + (lane % 4) * 2;
      csm[row * C_LD + col] = acc[i][j][0];
      csm[row * C_LD + col + 1] = acc[i][j][1];
      csm[(row + 8) * C_LD + col] = acc[i][j][2];
      csm[(row + 8) * C_LD + col + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int id = tid; id < BM * (BN / 8); id += THREADS) {
    const int row = id / (BN / 8);
    const int col = (id % (BN / 8)) * 8;
    const int n = n0 + col;
    if (n >= p.cout) continue;
    const int mx = row / (TY * TZ), my = (row / TZ) % TY, mz = row % TZ;
    const long long m =
        (((long long)b * S + x0 + mx) * S + y0 + my) * S + z0 + mz;
    const float* c = csm + row * C_LD + col;
    uint4 v;
    __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = __floats2bfloat162_rn(c[2 * j], c[2 * j + 1]);
    *reinterpret_cast<uint4*>(p.out + m * p.cout + n) = v;
  }
}

template <bool FUSED, bool VEC8, int BM, int BN>
int launch_tiled(const Params& p, cudaStream_t stream) {
  constexpr int smem = smem_bytes<BM, BN>();
  auto kernel = conv_kernel<FUSED, VEC8, BM, BN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.s / p.tx) * (p.s / p.ty) * (p.s / p.tz);
  const dim3 grid((unsigned)(p.nb * tiles), (unsigned)((p.cout + BN - 1) / BN));
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// BN = 128 when Cout allows it (then BM = 64), else BN = 64 and BM = 128:
// the brick's load and transform are shared by BN output channels. Needs
// S % 8 == 0, Cout % 8 == 0 and 16-byte aligned pointers (the Python
// wrapper checks). Returns a cudaError_t.
template <bool FUSED>
int launch(const Params& in, cudaStream_t stream) {
  Params p = in;
  const bool wide = p.cout % 128 == 0;
  const int bm = wide ? 64 : 128;
  p.tz = p.s % 16 == 0 ? 16 : 8;
  p.ty = p.tz == 16 ? 4 : 8;
  p.tx = bm / (p.ty * p.tz);
  if (p.s % p.tz != 0 || p.s % p.ty != 0 || p.s % p.tx != 0 || p.cin_pad % BK != 0 ||
      p.cout % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const bool vec8 = p.cin % 8 == 0;
  if (wide)
    return vec8 ? launch_tiled<FUSED, true, 64, 128>(p, stream)
                : launch_tiled<FUSED, false, 64, 128>(p, stream);
  return vec8 ? launch_tiled<FUSED, true, 128, 64>(p, stream)
              : launch_tiled<FUSED, false, 128, 64>(p, stream);
}

}  // namespace igemm
