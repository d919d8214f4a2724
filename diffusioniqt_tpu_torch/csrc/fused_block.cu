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
// each launch (BN 32 / 64 / 128, half- or whole-tap commit groups, whole
// units or ranges of chunks whose cut units a second kernel sums from fp32
// partials, the grid) comes from ops/kernels/fused_block.py::brick_plan.
//
// Sub-volume edges 4 and 2 (the levels of a memory_efficient U-Net) have
// no 4 x 8 x 8 brick: they take fused_block_small.cu.

#include "igemm.cuh"

// weight (27, Cin, Cout) bf16; tables (B, 27, Cin) fp32; ws (ctas, 2, 256,
// bn) fp32 with split, else null; the plan's bn (32, 64 or 128), tap (0 or
// 1; 1 needs bn <= 64 and Cin % 8 == 0), split (0 or 1; 1 needs Cin % 8 ==
// 0) and ctas (the grid). S % 8 == 0. Returns a cudaError_t.
extern "C" int fused_block_launch(void* encode, const void* xh, const float* a_tab,
                                  const float* b_tab, const void* w, void* out, void* ws, int nb,
                                  int s, int cin, int cout, int bn, int tap, int split, int ctas,
                                  void* stream) {
  return igemm::launch<true>(encode, xh, a_tab, b_tab, w, out, static_cast<float*>(ws), nb, s,
                             cin, cout, bn, tap, split, ctas, static_cast<cudaStream_t>(stream));
}

#ifdef BRICK_TRACE
// Where the phase stamps go ((ctas, 8) int64, or null for none) and the
// ablation bits (igemm.cuh).
extern "C" int set_trace(void* p, int ablate) {
  cudaError_t err = cudaMemcpyToSymbol(igemm::g_trace, &p, sizeof(p));
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyToSymbol(igemm::g_ablate, &ablate, sizeof(ablate));
}
#endif
