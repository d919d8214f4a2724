"""U-Net building blocks of the main path (counterpart of
``diffusioniqt_tpu/models/blocks.py``), channels-last ``(B, X, Y, Z, C)``.

Parameter names follow the reference ``Unet`` (imagen_pytorch3D.py), so
``diffusioniqt_tpu/utils/torch_convert.py::convert_iqt_unet_state_dict``
reads a port ``state_dict`` directly:

  Block                 groupnorm.{weight,bias}, project.{weight,bias}
  ResnetBlock           time_mlp.1, block1, block2, se.fc.{0,2}, res_conv
  Downsample            1 (the 1x1 conv after the pixel unshuffle)
  PixelShuffleUpsample  net.0 (the 1x1 conv before Mish + pixel shuffle)

Dense layers and 1x1 convs run in the activation's dtype (the JAX
modules' ``dtype=compute_dtype``) with fp32 parameters cast per call; every
3^3 conv goes through the kernels of ``ops/kernels``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusioniqt_tpu_torch.ops.kernels import KERNELS
from diffusioniqt_tpu_torch.ops.kernels.conv3d import PackedWeight
from diffusioniqt_tpu_torch.ops.kernels.fused_block import (
    fused_boundary_block,
    group_stats,
)
from diffusioniqt_tpu_torch.ops.volume import pixel_shuffle_3d, pixel_unshuffle_3d
from diffusioniqt_tpu_torch.utils.misc import Mish


class Dense(nn.Linear):
    """``nn.Linear`` computed in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class PointwiseConv(nn.Conv3d):
    """1x1x1 ``nn.Conv3d`` (weight ``(Cout, Cin, 1, 1, 1)``) applied to a
    channels-last tensor in its dtype."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True):
        super().__init__(dim_in, dim_out, 1, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.reshape(self.out_channels, self.in_channels)
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, w.to(x.dtype), bias)


class LearnedSinusoidalPosEmb(nn.Module):
    """Learned Fourier features over scalar conditioning (reference
    imagen_pytorch3D.py:518-533). Output dim = ``dim`` + 1, fp32."""

    def __init__(self, dim: int = 16):
        super().__init__()
        assert dim % 2 == 0
        self.weights = nn.Parameter(torch.randn(dim // 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x[:, None].float()
        freqs = x * self.weights[None, :] * 2 * math.pi
        return torch.cat([x, freqs.sin(), freqs.cos()], dim=-1)


def subvol_group_norm(x: torch.Tensor, scale: torch.Tensor, groups: int,
                      eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over (spatial, channels-in-group) per batch element with
    single-pass fp32 statistics (the JAX ``subvol_group_norm`` with
    factor 1), times ``scale``, in ``x.dtype``. The Block folds the same
    statistics into the fused kernel's coefficients instead."""
    mean, rstd = group_stats(x, groups, eps)
    b, c = x.shape[0], x.shape[-1]
    mean = mean.reshape(b, 1, 1, 1, c)
    rstd = rstd.reshape(b, 1, 1, 1, c)
    return ((x.float() - mean) * rstd * scale.float()).to(x.dtype)


class Block(nn.Module):
    """GroupNorm -> optional (scale+1, shift) -> Mish -> halo -> VALID 3^3
    conv (reference imagen_pytorch3D.py:535-566), as one fused kernel call
    (``ops/kernels/fused_block.py``) plus the conv bias. ``factor`` is the
    sub-volume grid of the boundary halo; ``factor=1`` is a SAME conv."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 factor: int = 3):
        super().__init__()
        self.groupnorm = nn.GroupNorm(groups, dim_in)
        self.project = nn.Conv3d(dim_in, dim_out, 3)
        self.groups = groups
        self.factor = factor
        self.ops = KERNELS
        self._packed = PackedWeight()

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        out = fused_boundary_block(
            x, self.groupnorm.weight, self.groupnorm.bias, scale_shift,
            self.project.weight, self.groups, self.factor,
            cache=self._packed, ops=self.ops,
        )
        return out + self.project.bias.to(out.dtype)


class SE3D(nn.Module):
    """Squeeze-and-excitation over (X, Y, Z) (reference
    imagen_pytorch3D.py:617-632)."""

    def __init__(self, dim: int, reduction: int = 16):
        super().__init__()
        hidden = max(dim // reduction, 1)
        self.fc = nn.Sequential(
            Dense(dim, hidden, bias=False), nn.ReLU(),
            Dense(hidden, dim, bias=False), nn.Sigmoid(),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.fc(x.mean(dim=(1, 2, 3)))
        return x * y[:, None, None, None, :]


class ResnetBlock(nn.Module):
    """Two Blocks + time scale-shift on the second + SE + residual
    (reference imagen_pytorch3D.py:568-614; ``block1`` gets no
    scale-shift)."""

    def __init__(self, dim_in: int, dim_out: int,
                 time_cond_dim: Optional[int] = None, groups: int = 8,
                 use_se: bool = False, factor: int = 3):
        super().__init__()
        self.time_mlp = None
        if time_cond_dim is not None:
            self.time_mlp = nn.Sequential(Mish(), Dense(time_cond_dim, dim_out * 2))
        self.block1 = Block(dim_in, dim_out, groups, factor)
        self.block2 = Block(dim_out, dim_out, groups, factor)
        self.se = SE3D(dim_out) if use_se else None
        self.res_conv = (PointwiseConv(dim_in, dim_out) if dim_in != dim_out
                         else nn.Identity())

    def forward(self, x: torch.Tensor, time_emb=None) -> torch.Tensor:
        scale_shift = None
        if self.time_mlp is not None and time_emb is not None:
            t = self.time_mlp(time_emb)[:, None, None, None, :]
            scale_shift = t.chunk(2, dim=-1)
        h = self.block1(x)
        h = self.block2(h, scale_shift=scale_shift)
        if self.se is not None:
            h = self.se(h)
        return h + self.res_conv(x)


class Downsample(nn.Sequential):
    """Pixel-unshuffle + 1x1 conv, the 'SP-conv' downsample (reference
    imagen_pytorch3D.py:489-496); slot 0 is the parameter-free rearrange."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__(nn.Identity(), PointwiseConv(dim_in * 8, dim_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[1](pixel_unshuffle_3d(x, scale=2))


class PixelShuffleUpsample(nn.Module):
    """1x1 conv (ICNR init) -> Mish -> pixel-shuffle x2 (reference
    imagen_pytorch3D.py:459-487)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        conv = PointwiseConv(dim_in, dim_out * 8)
        # ICNR: every 2^3 sub-position of an output channel starts equal
        base = torch.empty(dim_out, dim_in, 1, 1, 1)
        nn.init.kaiming_uniform_(base)
        with torch.no_grad():
            conv.weight.copy_(base.repeat_interleave(8, dim=0))
            conv.bias.zero_()
        self.net = nn.Sequential(conv, Mish())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle_3d(self.net(x), scale=2)
