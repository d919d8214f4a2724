"""Kernel 2: VALID 3x3x3 convolution of halo'd sub-volumes (``csrc/conv3d.cu``).

Replaces ``diffusioniqt_tpu/ops/pallas/conv3d.py::conv3d_valid``:
``(B, s+2, s+2, s+2, Cin) x w -> (B, s, s, s, Cout)``, fp32 accumulation,
output in the input dtype, no bias. On the main path it is the init conv
(Cin = 2: the noisy volume and the lowres conditioning).

Weights stay in torch layout ``(Cout, Cin, 3, 3, 3)`` in the modules;
:class:`PackedWeight` reorders one once into the kernel's
``(27*Cin_pad, Cout)`` bf16 layout and keeps it until the parameter
changes.

Bound on the H100: operations for wide convs; at Cin = 2 the 54-deep
product is tiny and moving the input and output dominates, so it is bound
by bytes. The kernel is the implicit GEMM of ``csrc/igemm.cuh`` (per block
a halo'd input brick in shared memory, the 27 taps as shifted views of it,
mma.sync over M = voxels, N = Cout, K = 27*Cin; no im2col buffer in device
memory).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diffusioniqt_tpu_torch.ops.kernels import runtime

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def conv3d_valid_plain(xh: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: ``F.conv3d`` on the channels-first view (fp32
    accumulation), output in ``xh.dtype``, channels-last and contiguous."""
    out = F.conv3d(xh.permute(0, 4, 1, 2, 3), w.to(xh.dtype))
    return out.permute(0, 2, 3, 4, 1).contiguous()


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """``(Cout, Cin, 3, 3, 3)`` -> ``(27*Cin_pad, Cout)`` bf16, row
    ``((kx*3 + ky)*3 + kz)*Cin_pad + c``, Cin_pad = Cin rounded up to the
    kernel's 32-channel chunk (zero rows)."""
    cout, cin = w.shape[0], w.shape[1]
    cin_pad = -(-cin // 32) * 32
    taps = w.detach().permute(2, 3, 4, 1, 0).reshape(27, cin, cout)
    packed = torch.zeros((27, cin_pad, cout), dtype=torch.bfloat16, device=w.device)
    packed[:, :cin] = taps
    return packed.reshape(27 * cin_pad, cout)


class PackedWeight:
    """Cache of one conv weight in the kernel layout; repacks only when the
    parameter's storage or version counter changes (an optimizer step or
    ``load_state_dict`` bumps the version)."""

    def __init__(self):
        self._key = None
        self._packed = None

    def get(self, w: torch.Tensor) -> torch.Tensor:
        key = (w.data_ptr(), w._version, w.device, w.dtype, tuple(w.shape))
        if key != self._key:
            self._packed = pack_weight(w)
            self._key = key
        return self._packed


def check_igemm_args(name: str, xh: torch.Tensor, w: torch.Tensor) -> None:
    """Shapes, dtype, device and contiguity the implicit-GEMM kernels take."""
    runtime.require(xh.dtype == torch.bfloat16, name,
                    f"input must be bfloat16, got {xh.dtype}")
    runtime.require(xh.dim() == 5 and xh.shape[1] == xh.shape[2] == xh.shape[3]
                    and xh.shape[1] >= 3, name,
                    f"expected (B, s+2, s+2, s+2, Cin), got {tuple(xh.shape)}")
    runtime.require(xh.is_contiguous(), name, "input must be contiguous")
    runtime.require(w.dim() == 5 and tuple(w.shape[2:]) == (3, 3, 3)
                    and w.shape[1] == xh.shape[4], name,
                    f"weight {tuple(w.shape)} is not (Cout, {xh.shape[4]}, 3, 3, 3)")
    runtime.require(w.shape[0] % 8 == 0, name,
                    f"Cout = {w.shape[0]} is not a multiple of 8")
    runtime.require(w.device == xh.device, name, "weight on another device")
    runtime.require((xh.shape[1] - 2) % 8 == 0, name,
                    f"sub-volume edge {xh.shape[1] - 2} is not a multiple of 8")
    runtime.require(xh.data_ptr() % 16 == 0, name, "input not 16-byte aligned")


def _launch(xh: torch.Tensor, w: torch.Tensor, packed: torch.Tensor):
    name = "conv3d"
    b, s, cin, cout = xh.shape[0], xh.shape[1] - 2, xh.shape[4], w.shape[0]
    out = torch.empty((b, s, s, s, cout), dtype=xh.dtype, device=xh.device)
    fn = runtime.c_function(name, "conv3d_valid_launch", _ARGTYPES)
    err = fn(xh.data_ptr(), packed.data_ptr(), out.data_ptr(), b, s, cin, cout,
             runtime.stream_handle(xh.device))
    runtime.check_launch(name, err)
    conv3d_valid.launches += 1
    return out


class _Conv3dValid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, w, packed):
        ctx.save_for_backward(xh, w)
        return _launch(xh, w, packed)

    @staticmethod
    def backward(ctx, grad):
        xh, w = ctx.saved_tensors
        gx, gw = runtime.plain_vjp(conv3d_valid_plain, [xh, w],
                                   ctx.needs_input_grad[:2], grad)
        return gx, gw, None


def conv3d_valid(xh: torch.Tensor, w: torch.Tensor,
                 cache: PackedWeight = None) -> torch.Tensor:
    """VALID 3^3 conv: the CUDA kernel for a CUDA tensor (bf16 only), the
    plain version for a CPU tensor. ``cache`` keeps the packed weight."""
    if xh.device.type == "cpu":
        return conv3d_valid_plain(xh, w)
    if xh.device.type != "cuda":
        raise ValueError(f"conv3d kernel: unsupported device {xh.device}")
    check_igemm_args("conv3d", xh, w)
    packed = cache.get(w) if cache is not None else pack_weight(w)
    return _Conv3dValid.apply(xh, w, packed)


conv3d_valid.launches = 0
