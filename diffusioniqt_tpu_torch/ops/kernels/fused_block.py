"""Kernel 3: the fused ResnetBlock ``Block`` unit (``csrc/fused_block.cu``).

Replaces ``diffusioniqt_tpu/ops/pallas/fused_block.py::fused_boundary_block``:
[GroupNorm -> (scale+1, shift) -> Mish -> boundary halo -> VALID 3^3 conv].

As in the JAX package, the work splits in three:

* :func:`groupnorm_affine` and :func:`neighbor_tables` (plain torch, tiny
  arrays): single-pass fp32 GroupNorm statistics folded with the norm
  affine and the time scale-shift into per-(sub-volume, channel) A and B,
  then a 27-region table per sub-volume (itself and its 26 grid
  neighbours; A = B = 0 where a neighbour is missing, so mish(0) = 0 is the
  reference's zero padding);
* the halo exchange (kernel 1) on the raw activation;
* :func:`fused_conv` (this kernel): ``conv_valid(mish(A_r * xh + B_r), w)``
  with r the region of each halo voxel, bf16 out, fp32 accumulation. Mish
  uses the one-exp identity with the input clamped at 20, as the Pallas
  kernel does.

Bound on the H100: operations, ``2 * M * 27 * Cin * Cout`` FLOP (1.583 ms
at the main path's (216, 32^3, 64->64)). The first kernel (an 8-warp
``mma.sync`` implicit GEMM, both operands through ``ldmatrix``, a barrier on
every tap, the brick loaded and put through Mish by the same warps between
products, 3.4-5x halo overhead) reached 15% of it. The kernel now is the
``wgmma`` + TMA implicit GEMM of ``csrc/igemm.cuh``: persistent CTAs walk
4 x 8 x 8-voxel output bricks (:func:`..conv3d.gemm_geometry`); one warp
streams the tap weight slices through an mbarrier ring; three transform
warps load each halo'd brick by TMA and apply the affine + Mish in shared
memory one brick ahead of two consumer warpgroups, which gather their A
fragments from the brick by ``ldmatrix`` (a tap is a row shift) and read B
from the ring. The normalised activation never reaches device memory, and
the Mish runs beside the products rather than between them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from diffusioniqt_tpu_torch.ops.kernels import runtime
from diffusioniqt_tpu_torch.ops.kernels.conv3d import (
    PackedWeight,
    check_igemm_args,
    conv3d_valid_plain,
    gemm_geometry,
    pack_weight,
)

# encoder, xh, a_tab, b_tab, w, out, B, s, Cin, Cout, BN, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


# ---------------------------------------------------------------------------
# coefficient construction (plain torch, tiny arrays)
# ---------------------------------------------------------------------------

def group_stats(x: torch.Tensor, groups: int, eps: float = 1e-5):
    """Single-pass fp32 GroupNorm statistics per sample: E[x], and
    1/sqrt(E[x^2] - E[x]^2 + eps), each ``(B, C)`` (repeated over the
    channels of a group)."""
    b, c = x.shape[0], x.shape[-1]
    cg = c // groups
    xv = x.reshape(b, -1, groups, cg)
    mean = xv.mean(dim=(1, 3), dtype=torch.float32)
    sq = xv.float().square().mean(dim=(1, 3))
    var = torch.clamp(sq - mean.square(), min=0.0)
    rstd = torch.rsqrt(var + eps)
    return (mean.repeat_interleave(cg, dim=-1),
            rstd.repeat_interleave(cg, dim=-1))


def groupnorm_affine(x, norm_scale, norm_bias, groups: int,
                     scale_shift=None, eps: float = 1e-5):
    """Fold [GroupNorm + bias + optional time (scale+1, shift)] into
    per-(sample, channel) fp32 coefficients A, B with ``y = A*x + B``."""
    b = x.shape[0]
    mean, rstd = group_stats(x, groups, eps)
    a = rstd * norm_scale.float()[None, :]
    bb = norm_bias.float()[None, :] - mean * a
    if scale_shift is not None:
        scale, shift = scale_shift
        scale = scale.reshape(scale.shape[0], -1).float()
        shift = shift.reshape(shift.shape[0], -1).float()
        if scale.shape[0] != b:  # broadcast a per-group embedding
            scale = scale.repeat_interleave(b // scale.shape[0], dim=0)
            shift = shift.repeat_interleave(b // shift.shape[0], dim=0)
        a = a * (scale + 1.0)
        bb = bb * (scale + 1.0) + shift
    return a, bb


@functools.lru_cache(maxsize=32)
def _neighbor_index(n: int, factor: int, device: torch.device):
    """For sub-volume b and region r: the batch index of its neighbour at
    grid offset (r1-1, r2-1, r3-1), and whether that neighbour exists.
    Both ``(n, 27)``; cached per shape (a handful of small tensors)."""
    f = factor
    b = torch.arange(n, device=device)
    rem = b % (f ** 3)
    g = (rem // (f * f), (rem // f) % f, rem % f)
    index, valid = [], []
    for d1 in (-1, 0, 1):
        for d2 in (-1, 0, 1):
            for d3 in (-1, 0, 1):
                ok = torch.ones(n, dtype=torch.bool, device=device)
                for gc, d in zip(g, (d1, d2, d3)):
                    ok &= (gc + d >= 0) & (gc + d < f)
                index.append((b + (d1 * f + d2) * f + d3) % n)
                valid.append(ok)
    return torch.stack(index, dim=1), torch.stack(valid, dim=1)


def neighbor_tables(a: torch.Tensor, bb: torch.Tensor, factor: int):
    """(B, C) coefficients -> (B, 27, C) region tables, region
    r = r1*9 + r2*3 + r3 for grid offsets (r1-1, r2-1, r3-1); zero where
    the neighbour is missing."""
    index, valid = _neighbor_index(a.shape[0], factor, a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    valid = valid[..., None]
    return (torch.where(valid, a[index], zero).contiguous(),
            torch.where(valid, bb[index], zero).contiguous())


# ---------------------------------------------------------------------------
# the kernel's function: plain version and wrapper
# ---------------------------------------------------------------------------

def mish_one_exp(v: torch.Tensor) -> torch.Tensor:
    """mish(v) = v * tanh(softplus(v)) = v * t / (t + 2), t = u^2 + 2u,
    u = exp(min(v, 20)) (the Pallas kernel's form, fused_block.py:160-167)."""
    u = torch.exp(torch.clamp(v, max=20.0))
    t = u * (u + 2.0)
    return v * t / (t + 2.0)


def _region_index(e: int, device) -> torch.Tensor:
    """(e, e, e) region index r of every halo'd voxel."""
    reg = torch.ones(e, dtype=torch.long, device=device)
    reg[0], reg[-1] = 0, 2
    return (reg[:, None, None] * 3 + reg[None, :, None]) * 3 + reg[None, None, :]


def fused_conv_plain(xh, a_tab, b_tab, w) -> torch.Tensor:
    """Plain version: ``conv_valid(mish(A_r * xh + B_r), w)``. xh
    ``(B, s+2, s+2, s+2, Cin)`` raw halo'd input; tables ``(B, 27, Cin)``
    fp32; w ``(Cout, Cin, 3, 3, 3)``. Output in ``xh.dtype``."""
    r = _region_index(xh.shape[1], xh.device)
    v = a_tab[:, r] * xh.float() + b_tab[:, r]
    return conv3d_valid_plain(mish_one_exp(v).to(xh.dtype), w)


def _launch(xh, a_tab, b_tab, w, packed):
    name = "fused_block"
    b, s, cin, cout = xh.shape[0], xh.shape[1] - 2, xh.shape[4], w.shape[0]
    out = torch.empty((b, s, s, s, cout), dtype=xh.dtype, device=xh.device)
    fn = runtime.c_function(name, "fused_block_launch", _ARGTYPES)
    err = fn(runtime.driver_function("cuTensorMapEncodeTiled"), xh.data_ptr(),
             a_tab.data_ptr(), b_tab.data_ptr(), packed.data_ptr(), out.data_ptr(), b, s,
             cin, cout, gemm_geometry(s, cin, cout).bn, runtime.stream_handle(xh.device))
    runtime.check_launch(name, err)
    fused_conv.launches += 1
    return out


class _FusedConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xh, a_tab, b_tab, w, packed):
        ctx.save_for_backward(xh, a_tab, b_tab, w)
        return _launch(xh, a_tab, b_tab, w, packed)

    @staticmethod
    def backward(ctx, grad):
        grads = runtime.plain_vjp(fused_conv_plain, list(ctx.saved_tensors),
                                  ctx.needs_input_grad[:4], grad)
        return (*grads, None)


def fused_conv(xh, a_tab, b_tab, w, cache: PackedWeight = None) -> torch.Tensor:
    """The fused kernel for a CUDA tensor (bf16 xh, fp32 contiguous tables),
    the plain version for a CPU tensor."""
    if xh.device.type == "cpu":
        return fused_conv_plain(xh, a_tab, b_tab, w)
    if xh.device.type != "cuda":
        raise ValueError(f"fused_block kernel: unsupported device {xh.device}")
    name = "fused_block"
    check_igemm_args(name, xh, w)
    want = (xh.shape[0], 27, xh.shape[4])
    for tab in (a_tab, b_tab):
        runtime.require(tab.dtype == torch.float32 and tuple(tab.shape) == want
                        and tab.is_contiguous() and tab.device == xh.device
                        and tab.data_ptr() % 16 == 0,
                        name, f"tables must be contiguous, 16-byte aligned fp32 {want} "
                        f"on {xh.device}")
    packed = cache.get(w) if cache is not None else pack_weight(w)
    return _FusedConv.apply(xh, a_tab, b_tab, w, packed)


fused_conv.launches = 0


def fused_boundary_block(x, norm_scale, norm_bias, scale_shift, w,
                         groups: int, factor: int,
                         cache: Optional[PackedWeight] = None,
                         ops=None) -> torch.Tensor:
    """Fused [GN -> (scale, shift) -> Mish -> halo -> VALID conv] without
    the conv bias. x ``(B, s, s, s, C)`` raw split sub-volumes (B a multiple
    of factor^3) in the compute dtype; w ``(Cout, C, 3, 3, 3)``;
    ``scale_shift`` optional ``((B,1,1,1,C), (B,1,1,1,C))``. Returns
    ``(B, s, s, s, Cout)`` in ``x.dtype``. ``ops`` picks the kernels
    (default) or their plain versions (:data:`..PLAIN`)."""
    from diffusioniqt_tpu_torch.ops.kernels import KERNELS

    ops = ops or KERNELS
    a, bb = groupnorm_affine(x, norm_scale, norm_bias, groups,
                             scale_shift=scale_shift)
    a_tab, b_tab = neighbor_tables(a, bb, factor)
    xh = ops.halo(x, factor)
    return ops.fused_conv(xh, a_tab, b_tab, w, cache)
