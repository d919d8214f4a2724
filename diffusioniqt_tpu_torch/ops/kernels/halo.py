"""Kernel 1: sub-volume halo exchange (``csrc/halo.cu``).

Replaces ``diffusioniqt_tpu/ops/pallas/halo.py::halo_exchange_pallas``:
``(N*f^3, s, s, s, C) -> (N*f^3, s+2, s+2, s+2, C)``, each sub-volume's
one-voxel shell filled from its 26 grid neighbours, zeros at the merged
volume's outer border. ``factor=1`` is plain zero padding.

Bound on the H100: bytes (pure data movement, input read once and output
written once). The kernel is row-wise: a team of lanes owns one output row
(n, px, py) of s+2 voxels, works out its sources once (:func:`row_sources`,
32-bit arithmetic in the kernel), copies the interior z-run as one
contiguous run of the source row with the widest vector both pointers
allow, and fills the two end voxels from the z-neighbours or with zeros. It
moves bytes whatever the dtype. The plain version is the axis sweep of
``ops.volume.halo_exchange``; the two must agree exactly.
"""

from __future__ import annotations

import ctypes

import torch

from diffusioniqt_tpu_torch.ops.kernels import runtime
from diffusioniqt_tpu_torch.ops.volume import halo_exchange as halo_exchange_plain
from diffusioniqt_tpu_torch.utils import profiling

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def row_sources(n: int, px: int, py: int, s: int, factor: int):
    """Where the kernel takes output row ``(n, px, py)`` from: three
    ``(sub-volume, x, y, z0)`` source starts, for the low z end voxel, the
    interior run of s voxels and the high z end voxel, each ``None`` where
    that part is zeros (a missing grid neighbour)."""
    e, f = s + 2, factor
    cell = n % f ** 3
    gx, gy, gz = cell // (f * f), (cell // f) % f, cell % f

    def axis(p):  # grid step to the neighbour, index inside it
        return (-1, s - 1) if p == 0 else ((1, 0) if p == e - 1 else (0, p - 1))

    (dx, sx), (dy, sy) = axis(px), axis(py)
    row_ok = 0 <= gx + dx < f and 0 <= gy + dy < f
    src = n + (dx * f + dy) * f
    lo = (src - 1, sx, sy, s - 1) if row_ok and gz > 0 else None
    mid = (src, sx, sy, 0) if row_ok else None
    hi = (src + 1, sx, sy, 0) if row_ok and gz < f - 1 else None
    return lo, mid, hi


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
    profiling.launched("halo")
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
    start = profiling.launch_clock()
    out = _HaloExchange.apply(x, factor)
    profiling.launch_timed("halo", start)
    return out
