// Fused ResnetBlock ``Block`` unit on Hopper:
//   [GroupNorm -> (scale+1, shift) -> Mish -> boundary halo -> VALID 3^3 conv]
//
// Replaces diffusioniqt_tpu/ops/pallas/fused_block.py::fused_boundary_block
// (its _fused_kernel). As there, the GroupNorm statistics, the norm affine
// and the time scale-shift are folded outside the kernel into
// per-(sub-volume, region, channel) coefficients A and B (27 regions:
// the sub-volume itself and its 26 grid neighbours, A = B = 0 where the
// neighbour is missing), and the halo exchange runs on the raw input. This
// kernel computes
//   out = conv_valid(mish(A_r * xh + B_r), w)       (bf16 out, fp32 accum)
// The conv bias is added by the caller.
//
// Bound: operations, 2 * M * 27 * Cin * Cout FLOP against reading xh once
// (1.583 ms at the main path's (216, 32^3, 64->64) on the H100). The old
// design, an 8-warp mma.sync implicit GEMM that put the brick through Mish
// on the same warps between products, reached 15% of it; igemm.cuh lists
// the five causes. Design: the wgmma + TMA implicit GEMM of igemm.cuh with
// the affine + Mish applied by seven transform warps to the TMA-loaded
// brick in shared memory, one brick ahead of the two consumer warpgroups:
// the normalised activation never goes to device memory, each input value
// is transformed once per 256-voxel brick and N tile (2.3x halo overhead,
// not 3.4-5x), and the SFU work runs beside the tensor cores. The plan of
// each launch (BN 32 / 64 / 128; 64- or 32-channel chunks, 32 where Cin <=
// 32 so that no product, brick byte or Mish is spent on zero channels;
// half- or whole-tap commit groups; whole units or ranges of chunks whose
// cut units a second kernel sums from fp32 partials; the grid) comes from
// ops/kernels/fused_block.py::brick_plan.
//
// Sub-volume edges 4 and 2 (the levels of a memory_efficient U-Net) have
// no 4 x 8 x 8 brick: they take fused_block_small.cu.

#include "igemm.cuh"

// weight (27, Cin, Cout) bf16; tables (B, 27, Cin) fp32; ws (ctas, 2, 256,
// bn) fp32 with split, else null; the plan's bn (32, 64 or 128), kc (64 or
// 32 input channels per chunk; 32 needs Cin % 8 == 0, tap 1 and split 0),
// tap (0 or 1; 1 needs Cin % 8 == 0), split (0 or 1; 1 needs Cin % 8 == 0)
// and ctas (the grid). S % 8 == 0. Returns a cudaError_t.
extern "C" int fused_block_launch(void* encode, const void* xh, const float* a_tab,
                                  const float* b_tab, const void* w, void* out, void* ws, int nb,
                                  int s, int cin, int cout, int bn, int kc, int tap, int split,
                                  int ctas, void* stream) {
  return igemm::launch<true>(encode, xh, a_tab, b_tab, w, out, static_cast<float*>(ws), nb, s,
                             cin, cout, bn, kc, tap, split, ctas,
                             static_cast<cudaStream_t>(stream));
}

#ifdef BRICK_TRACE
// Where the phase stamps go ((ctas, 8) int64, or null for none) and the
// ablation bits (igemm.cuh).
extern "C" int set_trace(void* p, int ablate) {
  cudaError_t err = cudaMemcpyToSymbol(igemm::g_trace, &p, sizeof(p));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(igemm::g_ablate, &ablate, sizeof(ablate));
}

// A check for a later unit design, compiled into the trace build only: can
// the tensor core read a tap's A tile (one output x-plane, 8 x 8 voxels, 64
// channels) straight from the 128-byte-swizzled brick through a matrix
// descriptor, its 8-row groups HZ * 128 = 1280 bytes apart and its start a
// row shift that is not a multiple of 8 rows? One warpgroup multiplies the
// tile by a 64 x 64 weight slice two ways: A gathered by ldmatrix (the
// kernel's way) and A by descriptor (base offset 0: the swizzle is applied
// on the absolute address). xb: the brick, 600 rows x 64 channels bf16,
// unswizzled; wk: the slice (64 K rows x 64 columns) bf16; out: (2, 128
// threads, 32) fp32, each thread's accumulators as they lie.
namespace desc_check {
using namespace sm90;
using namespace igemm;

__device__ __forceinline__ void wgmma_ss_n64_bt(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(128) kernel(const uint4* xb, const uint4* wk, float* out,
                                              int tap) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw_addr = smem_addr(smem_raw);
  const uint32_t base = (raw_addr + 1023u) & ~1023u;
  unsigned char* bp = smem_raw + (base - raw_addr);
  const uint32_t w_s = base + BRICK_BYTES;
  const int t = threadIdx.x, warp = t / 32, lane = t % 32;
  for (int id = t; id < ROWS * 8; id += 128) {
    const int row = id / 8, pc = id % 8;
    *reinterpret_cast<uint4*>(bp + row * 128 + ((pc ^ (row & 7)) << 4)) = xb[id];
  }
  for (int id = t; id < 64 * 8; id += 128) {
    const int k = id / 8, pc = id % 8;
    *reinterpret_cast<uint4*>(bp + BRICK_BYTES + k * 128 + ((pc ^ (k & 7)) << 4)) = wk[id];
  }
  fence_proxy_async();
  __syncthreads();
  const int toff = ((tap / 9) * HY + (tap / 3) % 3) * HZ + tap % 3;
  for (int way = 0; way < 2; ++way) {
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.0f;
    uint32_t frag[4][4];
    if (way == 0) {
      const int r = (2 * warp + (lane % 16) / 8) * HZ + lane % 8 + toff;
#pragma unroll
      for (int k2 = 0; k2 < 4; ++k2)
        ldmatrix_x4(frag[k2], base + r * 128 + (((k2 * 2 + lane / 16) ^ (r & 7)) << 4));
    }
    wgmma_fence();
#pragma unroll
    for (int k2 = 0; k2 < 4; ++k2) {
      const uint64_t db = make_desc(w_s + k2 * 16 * 128, W_PART, 1024, 1);
      if (way == 0) {
        wgmma_rs_n64(acc, frag[k2], db);
      } else {
        const uint32_t start = base + toff * 128 + k2 * 32;
        wgmma_ss_n64_bt(acc, make_desc(start, 16, HZ * 128, 1), db);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < 32; ++j) out[(way * 128 + t) * 32 + j] = acc[j];
  }
}
}  // namespace desc_check

extern "C" int desc_check_launch(const void* xb, const void* wk, float* out, int tap) {
  const int smem = 1024 + igemm::BRICK_BYTES + 64 * 128;
  cudaError_t err = cudaFuncSetAttribute(desc_check::kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  desc_check::kernel<<<1, 128, smem>>>(static_cast<const uint4*>(xb),
                                       static_cast<const uint4*>(wk), out, tap);
  return (int)cudaGetLastError();
}
#endif
