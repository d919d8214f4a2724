// VALID 3x3x3 convolution of halo'd sub-volumes on Hopper (the init conv).
//
// Replaces diffusioniqt_tpu/ops/pallas/conv3d.py::conv3d_valid:
//   (B, s+2, s+2, s+2, Cin) bf16 x (27*Cin_pad, Cout) bf16 -> (B, s, s, s, Cout)
//   bf16, fp32 accumulation. The conv bias is added by the caller.
//
// Bound: operations at the block convs' widths; at the init conv's
// Cin = 2 the 54-deep product is tiny and moving the input and output
// dominates, so it is bound by bytes. Design: the implicit GEMM of
// igemm.cuh (a shared-memory brick per block, mma.sync, no im2col buffer
// in device memory). Cin = 2 is zero-padded to one 32-channel chunk: 16x
// the tensor-core work of the real product, which is still small next to
// the 113 MB the output takes to write.

#include "igemm.cuh"

extern "C" int conv3d_valid_launch(const void* xh, const void* w, void* out,
                                   int nb, int s, int cin, int cout,
                                   void* stream) {
  igemm::Params p;
  p.xh = static_cast<const __nv_bfloat16*>(xh);
  p.w = static_cast<const __nv_bfloat16*>(w);
  p.a_tab = nullptr;
  p.b_tab = nullptr;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.nb = nb;
  p.s = s;
  p.cin = cin;
  p.cin_pad = (cin + igemm::BK - 1) / igemm::BK * igemm::BK;
  p.cout = cout;
  return igemm::launch<false>(p, static_cast<cudaStream_t>(stream));
}
