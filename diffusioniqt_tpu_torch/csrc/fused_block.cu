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
// Bound: operations (2 * M * 27 * Cin * Cout FLOP against reading xh once:
// hundreds of FLOP per byte at Cin, Cout >= 64). Design: the implicit GEMM
// of igemm.cuh with the affine + Mish applied where the input brick is
// loaded into shared memory, so the normalised activation never goes to
// device memory and each input value is transformed once per block (its
// 27 taps and BN = 64 or 128 output channels share it).

#include "igemm.cuh"

extern "C" int fused_block_launch(const void* xh, const float* a_tab,
                                  const float* b_tab, const void* w, void* out,
                                  int nb, int s, int cin, int cout,
                                  void* stream) {
  igemm::Params p;
  p.xh = static_cast<const __nv_bfloat16*>(xh);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.a_tab = a_tab;
  p.b_tab = b_tab;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.nb = nb;
  p.s = s;
  p.cin = cin;
  p.cin_pad = (cin + igemm::BK - 1) / igemm::BK * igemm::BK;
  p.cout = cout;
  return igemm::launch<true>(p, static_cast<cudaStream_t>(stream));
}
