"""Kernel 1: sub-volume halo exchange (``csrc/halo.cu``).

Replaces ``diffusioniqt_tpu/ops/pallas/halo.py::halo_exchange_pallas``:
``(N*f^3, s, s, s, C) -> (N*f^3, s+2, s+2, s+2, C)``, each sub-volume's
one-voxel shell filled from its 26 grid neighbours, zeros at the merged
volume's outer border. ``factor=1`` is plain zero padding.

Bound on the H100: bytes (pure data movement, input read once and output
written once). The kernel gives each thread one 16-byte channel vector of
one output voxel, so loads and stores are coalesced, and moves bytes
whatever the dtype. The plain version is the axis sweep of
``ops.volume.halo_exchange``; the two must agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from diffusioniqt_tpu_torch.ops.kernels import runtime
from diffusioniqt_tpu_torch.ops.volume import halo_exchange as halo_exchange_plain

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _launch(x: torch.Tensor, factor: int) -> torch.Tensor:
    name = "halo"
    runtime.require(x.dim() == 5 and x.shape[1] == x.shape[2] == x.shape[3],
                    name, f"expected (N, s, s, s, C), got {tuple(x.shape)}")
    runtime.require(x.is_contiguous(), name, "input must be contiguous")
    n, s, c = x.shape[0], x.shape[1], x.shape[4]
    runtime.require(n % factor ** 3 == 0, name,
                    f"batch {n} is not a multiple of factor^3 = {factor ** 3}")
    out = torch.empty((n, s + 2, s + 2, s + 2, c), dtype=x.dtype,
                      device=x.device)
    fn = runtime.c_function(name, "halo_exchange_launch", _ARGTYPES)
    err = fn(x.data_ptr(), out.data_ptr(), n, s, factor, c * x.element_size(),
             runtime.stream_handle(x.device))
    runtime.check_launch(name, err)
    halo_exchange.launches += 1
    return out


class _HaloExchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, factor):
        ctx.factor = factor
        ctx.save_for_backward(x)
        return _launch(x, factor)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        (gx,) = runtime.plain_vjp(halo_exchange_plain, [x],
                                  ctx.needs_input_grad[:1], grad, ctx.factor)
        return gx, None


def halo_exchange(x: torch.Tensor, factor: int = 3) -> torch.Tensor:
    """Halo exchange: the CUDA kernel for a CUDA tensor, the plain axis
    sweep for a CPU tensor."""
    if x.device.type == "cpu":
        return halo_exchange_plain(x, factor)
    if x.device.type != "cuda":
        raise ValueError(f"halo kernel: unsupported device {x.device}")
    return _HaloExchange.apply(x, factor)


halo_exchange.launches = 0
