"""U-Net building blocks of the main path (counterpart of
``diffusioniqt_tpu/models/blocks.py``), channels-last ``(B, X, Y, Z, C)``.

Parameter names follow the reference ``Unet`` (imagen_pytorch3D.py), so
``diffusioniqt_tpu/utils/torch_convert.py::convert_iqt_unet_state_dict``
reads a port ``state_dict`` directly:

  Block                 groupnorm.{weight,bias}, project.{weight,bias}
  ResnetBlock           time_mlp.1, block1, block2, se.fc.{0,2}, res_conv
  Downsample            1 (the 1x1 conv after the pixel unshuffle)
  PixelShuffleUpsample  net.0 (the 1x1 conv before Mish + pixel shuffle)
  DeconvUpsample        deconv.0 (ConvTranspose3d, torch layout (in, out, 3, 3, 3))
  CrossEmbedLayer       convs.{i} (one conv per kernel size, smallest first)
  ChanLayerNorm         g
  GlobalContext         to_k, net.{0,2}

Fresh modules draw their parameters as the JAX modules' flax initialisers
do: every conv and dense kernel ``lecun_normal`` (a normal of variance
1 / fan_in truncated at two standard deviations, :func:`lecun_normal_`),
every bias zero, GroupNorm and LayerNorm scales one and biases zero. The
special cases keep theirs: the learned sinusoidal weights and the ViT
positions normal(1), the pixel-shuffle conv's ICNR over a ``kaiming_uniform``
base, the deconv's ``lecun_normal`` with fan_in over its input channels.

Dense layers and 1x1 convs run in the activation's dtype (the JAX
modules' ``dtype=compute_dtype``) with fp32 parameters cast per call; every
3^3 conv of a Block goes through the kernels of ``ops/kernels``. The
cross-embed stem, the deconv upsample and the U-Net's init / final convs
of other kernel sizes are convs that the JAX package leaves to XLA
(``nn.Conv``, ``lax.conv_general_dilated``) outside any Pallas kernel;
here they are cuDNN convolutions (:class:`SameConv`).
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
from diffusioniqt_tpu_torch.parallel.sharding import (
    ColumnParallel,
    copy_to_model,
    gather_from_model,
)
from diffusioniqt_tpu_torch.utils.misc import Mish, mish


# flax's truncated normal: the standard deviation of a unit normal cut at
# +-2, by which ``variance_scaling`` divides its scale (jax initializers)
TRUNCATED_NORMAL_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, fan_in: Optional[int] = None) -> torch.Tensor:
    """flax ``lecun_normal`` in place: ``variance_scaling(1, "fan_in",
    "truncated_normal")``, a normal of standard deviation
    ``sqrt(1 / fan_in) / TRUNCATED_NORMAL_STD`` cut at two of them, so
    that the kept values have variance ``1 / fan_in``. ``fan_in`` defaults
    to a torch conv or linear weight's ``in_channels / groups`` times its
    kernel extent, which is flax's count for the same layer."""
    fan_in = weight[0].numel() if fan_in is None else fan_in
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_NORMAL_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)


class LecunInit:
    """Mixin for ``nn.Linear`` / ``nn.Conv*`` subclasses: the flax
    ``nn.Dense`` / ``nn.Conv`` initialisers (``lecun_normal`` kernel, zero
    bias) in place of torch's ``kaiming_uniform_(a=sqrt(5))``."""

    def reset_parameters(self) -> None:
        lecun_normal_(self.weight)
        if self.bias is not None:
            nn.init.zeros_(self.bias)


class Conv3d(ColumnParallel, LecunInit, nn.Conv3d):
    """``nn.Conv3d`` with the flax initialisers; its weight is read by the
    kernels (in :class:`Block` and the U-Net's stem), not by its
    ``forward``."""

    forward = nn.Conv3d.forward


class Dense(ColumnParallel, LecunInit, nn.Linear):
    """``nn.Linear`` computed in the input's dtype."""

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        return F.linear(x, self.weight.to(x.dtype), None if bias is None else bias.to(x.dtype))


class PointwiseConv(ColumnParallel, LecunInit, nn.Conv3d):
    """1x1x1 ``nn.Conv3d`` (weight ``(Cout, Cin, 1, 1, 1)``) applied to a
    channels-last tensor in its dtype."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True):
        super().__init__(dim_in, dim_out, 1, bias=bias)

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.in_channels)
        return F.linear(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype))


class SameConv(ColumnParallel, LecunInit, nn.Conv3d):
    """k^3 ``nn.Conv3d`` with stride 1 applied to a channels-last tensor in
    its dtype; ``padding`` voxels of zeros on every side (``(k - 1) // 2``
    by default: flax ``padding="SAME"`` at an odd kernel)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int,
                 padding: Optional[int] = None):
        super().__init__(dim_in, dim_out, kernel_size,
                         padding=(kernel_size - 1) // 2 if padding is None else padding)

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        out = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                       None if bias is None else bias.to(x.dtype), padding=self.padding)
        return out.permute(0, 2, 3, 4, 1).contiguous()


class ConvTranspose3d(ColumnParallel, nn.ConvTranspose3d):
    """``nn.ConvTranspose3d`` applied to a channels-last tensor in its
    dtype; weight ``(in, out, k..)``: its output channels are torch axis 1."""

    shard_dim = 1

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        y = F.conv_transpose3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                               None if bias is None else bias.to(x.dtype), self.stride,
                               self.padding, self.output_padding)
        return y.permute(0, 2, 3, 4, 1).contiguous()


class CrossEmbedLayer(nn.Module):
    """Multi-kernel conv stem (JAX blocks.py:430-457, reference
    imagen_pytorch3D.py:661-686): one stride-1 conv per kernel size,
    smallest first, padding ``(k - stride) // 2``, their outputs
    concatenated; output channels halve per extra scale (32 -> 16 / 8 / 8)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_sizes=(3, 7, 15), stride: int = 1):
        super().__init__()
        if stride != 1:
            raise ValueError("the U-Net's cross-embed stem has stride 1")
        kernel_sizes = sorted(kernel_sizes)
        scales = [int(dim_out / (2 ** i)) for i in range(1, len(kernel_sizes))]
        scales = [*scales, dim_out - sum(scales)]
        self.convs = nn.ModuleList([
            SameConv(dim_in, d, k, padding=(k - stride) // 2)
            for k, d in zip(kernel_sizes, scales)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([conv(x) for conv in self.convs], dim=-1)


class DeconvUpsample(nn.Module):
    """2x transposed-conv upsample, bias, Mish (JAX blocks.py:366-399,
    reference ``Deconv3D`` imagen_pytorch3D.py:441-457): the reference's
    ``ConvTranspose3d(k=3, s=2, p=1, output_padding=1)`` with its weight in
    torch layout ``(in, out, 3, 3, 3)``. The JAX module computes the same
    function as a correlation with input dilation 2 and padding (1, 2) per
    axis over the spatially flipped kernel, which is what its converter
    stores (``utils/torch_convert.py::_deconv_upsample``)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        conv = ConvTranspose3d(dim_in, dim_out, 3, stride=2, padding=1, output_padding=1)
        # the JAX kernel's lecun_normal(in_axis=-2) counts fan_in over the
        # input channels (blocks.py:383-390); torch's layout is (in, out, k^3)
        lecun_normal_(conv.weight, fan_in=dim_in * 27)
        nn.init.zeros_(conv.bias)
        self.deconv = nn.Sequential(conv)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(self.deconv(x))


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


class ChanLayerNorm(nn.Module):
    """LayerNorm over the channel axis only: fp32 mean and biased variance,
    eps 1e-5, learned scale ``g`` ``(C,)``, no bias, result in the input's
    dtype (reference imagen_pytorch3D.py:361-382). A ``g`` of another
    shape with C elements (the reference keeps singleton spatial axes)
    loads too."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.g = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        key = prefix + "g"
        if key in state_dict and state_dict[key].numel() == self.g.numel():
            state_dict[key] = state_dict[key].reshape(self.g.shape)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var, mean = torch.var_mean(x32, dim=-1, unbiased=False, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + self.eps) * self.g).to(x.dtype)


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
    sub-volume grid of the boundary halo; ``factor=1`` is a SAME conv.

    With the conv weight column-sharded (``project.tp``), the fused call
    takes the ``(Cout / M, Cin, 3, 3, 3)`` shard and gives this rank's
    ``Cout / M`` channels, which the model group gathers before the
    replicated bias is added. The kernel's Function fuses the GroupNorm,
    affine and Mish with the conv, so each rank's backward gives every
    replicated input of the call (``x``, the GroupNorm scale and bias, the
    time scale and shift) the part of its gradient that its columns
    carry: they enter through one :func:`copy_to_model`, which sums those
    parts over the group."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 factor: int = 3):
        super().__init__()
        self.groupnorm = nn.GroupNorm(groups, dim_in)
        self.project = Conv3d(dim_in, dim_out, 3)
        self.groups = groups
        self.factor = factor
        self.ops = KERNELS
        self._packed = PackedWeight()

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        tp = self.project.tp
        norm_scale, norm_bias = self.groupnorm.weight, self.groupnorm.bias
        if tp is not None:
            x, norm_scale, norm_bias, *ss = copy_to_model(
                tp, x, norm_scale, norm_bias, *(scale_shift or ()))
            scale_shift = tuple(ss) or None
        out = fused_boundary_block(
            x, norm_scale, norm_bias, scale_shift,
            self.project.weight, self.groups, self.factor,
            cache=self._packed, ops=self.ops,
        )
        if tp is not None:
            out = gather_from_model(out, tp)
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
        # ICNR: every 2^3 sub-position of an output channel starts equal,
        # over flax's kaiming_uniform (torch's with a=0: U(+-sqrt(6 / fan_in)))
        base = torch.empty(dim_out, dim_in, 1, 1, 1)
        nn.init.kaiming_uniform_(base)
        with torch.no_grad():
            conv.weight.copy_(base.repeat_interleave(8, dim=0))
            conv.bias.zero_()
        self.net = nn.Sequential(conv, Mish())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle_3d(self.net(x), scale=2)


class GlobalContext(nn.Module):
    """Attention-pooled squeeze-excitation (JAX blocks.py:500-518,
    reference imagen_pytorch3D.py:634-659): a 1x1 conv to one channel
    whose softmax over every position of a sample pools the input, then
    1x1 -> Mish -> 1x1 -> sigmoid, a ``(B, 1, .., 1, C)`` gate. Any
    channels-last rank (the video U-Net's ``(B, F, H, W, C)``); the
    softmax in fp32."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        hidden = max(3, dim_out // 2)
        self.to_k = PointwiseConv(dim_in, 1)
        self.net = nn.Sequential(PointwiseConv(dim_in, hidden), Mish(),
                                 PointwiseConv(hidden, dim_out), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        weights = torch.softmax(self.to_k(x).reshape(b, -1).float(), dim=-1).to(x.dtype)
        pooled = torch.einsum("bn,bnc->bc", weights, x.reshape(b, -1, c))
        return self.net(pooled).reshape(b, *([1] * (x.dim() - 2)), -1)
