"""The 2D slice U-Net (counterpart of ``diffusioniqt_tpu/models/unet2d.py``,
the ``imagen_pytorch2D`` capability), channels-last ``(B, H, W, C)``.

The 2D instantiation of the U-Net's block grammar: GroupNorm -> (scale+1,
shift) -> Mish -> 3x3 SAME conv Blocks, squeeze-excite, a pixel-unshuffle
downsample and a pixel-shuffle upsample, linear or softmax attention over
the tokens of the whole grid, and the learned sinusoidal log-SNR
embedding. Drives ``diffusion/gaussian.py::Imagen`` with ``spatial_dims=2``.

The JAX module leaves its convolutions, GroupNorms and 1x1 products to XLA
(no Pallas kernel), so here they are PyTorch calls (cuDNN, cuBLAS) in the
compute dtype (under a ``model`` mesh axis the convs and dense layers are
column-parallel, ``parallel/sharding.py``): flax's GroupNorm (eps 1e-6, single-pass fp32 statistics
E[x^2] - E[x]^2), ``F.conv2d`` for the 3x3 convs, matrix products for the
1x1s, and the output conv in fp32 on an fp32 cast. Softmax attention goes
through ``ops/attention.py::scaled_dot_product_attention``: on a CUDA
tensor the hand-written flash kernel (``csrc/flash_attention.cu``, head
dim 32 by default, any token count), with no fallback; on a CPU tensor
:func:`~diffusioniqt_tpu_torch.ops.attention.attention_reference`.

Modules carry the JAX module names (``init_conv``, ``down{i}_init``,
``down{i}_attn``, ``down{i}_block{j}``, ``down{i}_post``, ``mid_attn``,
``mid_block``, ``up{i}_upsample``, ``up{i}_init``, ``up{i}_block{j}``,
``final_res_block``, ``final_conv``); inside them the 3D port's names
(``to_time_hiddens.{0,1}``, ``to_time_cond.0``, ``time_mlp.1``,
``block{1,2}.{groupnorm,project}``, ``se.fc.{0,2}``, ``res_conv``), which
``utils/convert.py::unet2d_state_dict_from_jax_params`` fills from the
JAX parameters. Fresh parameters follow the JAX initialisers
(``models/blocks.py``: ``lecun_normal`` kernels, zero biases; the
pixel-shuffle conv's ICNR over a ``kaiming_uniform`` base, repeated 4
times).
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusioniqt_tpu_torch.models.blocks import (
    CastToCascade,
    ChanLayerNorm,
    Dense,
    LearnedSinusoidalPosEmb,
    LecunInit,
)
from diffusioniqt_tpu_torch.ops.attention import scaled_dot_product_attention
from diffusioniqt_tpu_torch.ops.kernels import KERNELS, Ops
from diffusioniqt_tpu_torch.parallel.sharding import ColumnParallel
from diffusioniqt_tpu_torch.utils.misc import Mish, cast_tuple, mish


class Conv2d(ColumnParallel, LecunInit, nn.Conv2d):
    """k x k stride-1 SAME ``nn.Conv2d`` on a channels-last tensor in its
    dtype (flax ``nn.Conv(padding="SAME")`` at an odd kernel); under a
    model axis it computes its column shard's channels and gathers them."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3):
        super().__init__(dim_in, dim_out, kernel_size, padding=(kernel_size - 1) // 2)

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.weight.to(x.dtype),
                     None if bias is None else bias.to(x.dtype), padding=self.padding)
        return y.permute(0, 2, 3, 1)


class PointwiseConv2d(ColumnParallel, LecunInit, nn.Conv2d):
    """1x1 ``nn.Conv2d`` (weight ``(Cout, Cin, 1, 1)``) on a channels-last
    tensor in its dtype: one matrix product (of its column shard under a
    model axis, gathered)."""

    def __init__(self, dim_in: int, dim_out: int, bias: bool = True):
        super().__init__(dim_in, dim_out, 1, bias=bias)

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        w = self.weight.reshape(self.weight.shape[0], self.in_channels)
        return F.linear(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype))


class GroupNorm(nn.GroupNorm):
    """flax ``nn.GroupNorm`` on a channels-last tensor: eps 1e-6, fp32
    statistics in one pass (variance E[x^2] - E[x]^2, floored at 0), scale
    and bias applied in fp32, the result in the input's dtype."""

    def __init__(self, groups: int, dim: int):
        super().__init__(groups, dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        x32 = x.float().reshape(b, -1, self.num_groups, c // self.num_groups)
        mean = x32.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp((x32 * x32).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
        y = ((x32 - mean) * torch.rsqrt(var + self.eps)).reshape(x.shape)
        return (y * self.weight + self.bias).to(x.dtype)


class SE2D(nn.Module):
    """Squeeze-and-excitation over (H, W), dense layers without bias."""

    def __init__(self, dim: int, reduction: int = 16):
        super().__init__()
        hidden = max(dim // reduction, 1)
        self.fc = nn.Sequential(Dense(dim, hidden, bias=False), nn.ReLU(),
                                Dense(hidden, dim, bias=False), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.fc(x.mean(dim=(1, 2)))[:, None, None, :]


class Block2D(nn.Module):
    """GroupNorm -> optional (scale+1, shift) -> Mish -> 3x3 SAME conv."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.groupnorm = GroupNorm(groups, dim_in)
        self.project = Conv2d(dim_in, dim_out, 3)

    def forward(self, x: torch.Tensor, scale_shift=None) -> torch.Tensor:
        x = self.groupnorm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return self.project(mish(x))


class ResnetBlock2D(nn.Module):
    """Two Block2Ds, the time scale-shift on the second, SE, residual (a 1x1
    conv where the width changes)."""

    def __init__(self, dim_in: int, dim_out: int, time_cond_dim: Optional[int] = None,
                 groups: int = 8, use_se: bool = True):
        super().__init__()
        self.time_mlp = (nn.Sequential(Mish(), Dense(time_cond_dim, dim_out * 2))
                         if time_cond_dim is not None else None)
        self.block1 = Block2D(dim_in, dim_out, groups)
        self.block2 = Block2D(dim_out, dim_out, groups)
        self.se = SE2D(dim_out) if use_se else None
        self.res_conv = PointwiseConv2d(dim_in, dim_out) if dim_in != dim_out else nn.Identity()

    def forward(self, x: torch.Tensor, time_emb=None) -> torch.Tensor:
        scale_shift = None
        if self.time_mlp is not None and time_emb is not None:
            scale_shift = self.time_mlp(time_emb)[:, None, None, :].chunk(2, dim=-1)
        h = self.block2(self.block1(x), scale_shift=scale_shift)
        if self.se is not None:
            h = self.se(h)
        return h + self.res_conv(x)


class Downsample2D(nn.Module):
    """Pixel-unshuffle by 2 (input channel ``c`` of sub-position (dy, dx)
    to ``4 c + 2 dy + dx``, the JAX reshape order) and a 1x1 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = PointwiseConv2d(dim_in * 4, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pixel_unshuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
        return self.conv(x)


class PixelShuffleUpsample2D(nn.Module):
    """1x1 conv to 4x the channels (ICNR: the 4 sub-positions of an output
    channel start equal, over flax's ``kaiming_uniform``, zero bias), Mish,
    pixel-shuffle by 2 (channel ``4 c + 2 i + j`` to sub-position (i, j) of
    ``c``, the JAX reshape order)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = PointwiseConv2d(dim_in, dim_out * 4)
        base = torch.empty(dim_out, dim_in, 1, 1)
        nn.init.kaiming_uniform_(base)  # U(+-sqrt(6 / fan_in)), flax's kaiming_uniform
        with torch.no_grad():
            self.conv.weight.copy_(base.repeat_interleave(4, dim=0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = mish(self.conv(x))
        return F.pixel_shuffle(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class Attention2D(nn.Module):
    """Token attention over the whole grid, linear or softmax, between two
    ChanLayerNorms, plus the input. Softmax attention runs through
    ``ops.attention`` (``self.ops``, the flash kernel by default). Under a
    model axis each rank computes its columns of q / k / v and of the
    output projection, and the gather gives every rank all heads, over
    which the kernel runs whole."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 32, linear: bool = True,
                 use_flash: bool = True):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head, self.linear, self.use_flash = heads, dim_head, linear, use_flash
        self.norm = ChanLayerNorm(dim)
        self.to_qkv = PointwiseConv2d(dim, inner * 3, bias=False)
        self.to_out = PointwiseConv2d(inner, dim, bias=False)
        self.out_norm = ChanLayerNorm(dim)
        self.ops = KERNELS

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hh, ww, _ = x.shape
        h, d = self.heads, self.dim_head

        def split_heads(t):
            return t.reshape(b, hh * ww, h, d).permute(0, 2, 1, 3).reshape(b * h, hh * ww, d)

        q, k, v = map(split_heads, self.to_qkv(self.norm(x)).chunk(3, dim=-1))
        scale = d ** -0.5
        if self.linear:
            q = torch.softmax(q, dim=-1) * scale
            k = torch.softmax(k, dim=-2)
            out = torch.einsum("bnd,bde->bne", q, torch.einsum("bnd,bne->bde", k, v))
        else:
            out = scaled_dot_product_attention(q, k, v, scale, use_flash=self.use_flash,
                                               ops=self.ops)
        out = out.reshape(b, h, hh * ww, d).permute(0, 2, 1, 3).reshape(b, hh, ww, h * d)
        return self.out_norm(self.to_out(out)) + x


class UNet2D(CastToCascade, nn.Module):
    """2D conditional diffusion U-Net for MRI slices, with every field of
    the JAX ``UNet2D`` (unet2d.py:168-189); ``dtype`` is the compute dtype
    (parameters stay fp32)."""

    def __init__(
        self,
        dim: int = 64,
        dim_mults: Tuple[int, ...] = (1, 2, 4),
        num_resnet_blocks: Union[int, Tuple[int, ...]] = 2,
        channels: int = 1,
        channels_out: Optional[int] = None,
        lowres_cond: bool = False,
        self_cond: bool = False,
        cond_images_channels: int = 0,
        learned_sinu_pos_emb_dim: int = 16,
        init_dim: Optional[int] = None,
        resnet_groups: Union[int, Tuple[int, ...]] = 8,
        use_se_attn: bool = True,
        att_type: str = "linear",
        attn_heads: int = 8,
        attn_dim_head: int = 32,
        layer_attns: Union[bool, Tuple[bool, ...]] = False,
        attend_at_middle: bool = False,
        final_resnet_block: bool = True,
        use_flash: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.config = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        if att_type not in ("linear", "softmax", "none"):
            raise ValueError(f"unknown att_type {att_type!r}")
        num_layers = len(dim_mults)
        num_blocks = cast_tuple(num_resnet_blocks, num_layers)
        groups = cast_tuple(resnet_groups, num_layers)
        layer_attns = cast_tuple(layer_attns, num_layers)
        init_dim = init_dim or dim
        time_cond_dim = dim * 4
        self.channels, self.channels_out = channels, channels_out or channels
        self.lowres_cond, self.self_cond = lowres_cond, self_cond
        self.cond_images_channels = cond_images_channels
        self.dtype = dtype
        self.num_layers = num_layers
        in_ch = (channels * (1 + int(self_cond) + int(lowres_cond)) + cond_images_channels)

        def resnet(d_in, d_out, g):
            return ResnetBlock2D(d_in, d_out, time_cond_dim, g, use_se_attn)

        def attention(d):
            return Attention2D(d, attn_heads, attn_dim_head, linear=att_type == "linear",
                               use_flash=use_flash)

        self.init_conv = Conv2d(in_ch, init_dim, 3)
        self.to_time_hiddens = nn.Sequential(
            LearnedSinusoidalPosEmb(learned_sinu_pos_emb_dim),
            Dense(learned_sinu_pos_emb_dim + 1, time_cond_dim))
        self.to_time_cond = nn.Sequential(Dense(time_cond_dim, time_cond_dim))

        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        mid_dim = dims[-1]
        self.down_attn = [bool(layer_attns[i]) and att_type != "none" for i in range(num_layers)]
        self.num_blocks = num_blocks
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind == num_layers - 1
            self.add_module(f"down{ind}_init", resnet(dim_in, dim_in, groups[ind]))
            if self.down_attn[ind]:
                self.add_module(f"down{ind}_attn", attention(dim_in))
            for bi in range(num_blocks[ind]):
                self.add_module(f"down{ind}_block{bi}", resnet(dim_in, dim_in, groups[ind]))
            self.add_module(f"down{ind}_post", PointwiseConv2d(dim_in, dim_out) if is_last
                            else Downsample2D(dim_in, dim_out))

        self.mid_attn = attention(mid_dim) if attend_at_middle and att_type != "none" else None
        self.mid_block = resnet(mid_dim, mid_dim, groups[-1])

        x_dim = mid_dim
        rev_blocks, rev_groups = list(reversed(num_blocks)), list(reversed(groups))
        for ind, (dim_out_lvl, _) in enumerate(reversed(in_out)):
            if ind < num_layers - 1:
                self.add_module(f"up{ind}_upsample", PixelShuffleUpsample2D(x_dim, dim_out_lvl))
                # the skip of down level num_layers - 2 - ind
                x_dim = dim_out_lvl + in_out[num_layers - 2 - ind][0]
            self.add_module(f"up{ind}_init", resnet(x_dim, dim_out_lvl, rev_groups[ind]))
            for bi in range(rev_blocks[ind]):
                self.add_module(f"up{ind}_block{bi}",
                                resnet(dim_out_lvl, dim_out_lvl, rev_groups[ind]))
            x_dim = dim_out_lvl

        self.final_res_block = resnet(x_dim, dim, groups[0]) if final_resnet_block else None
        self.final_conv = PointwiseConv2d(dim if final_resnet_block else x_dim,
                                          self.channels_out)

    def use_ops(self, ops: Ops) -> "UNet2D":
        """Route softmax attention through ``ops`` (``KERNELS`` or ``PLAIN``)."""
        for m in self.modules():
            if hasattr(m, "ops"):
                m.ops = ops
        return self

    def forward(
        self,
        x: torch.Tensor,            # (B, H, W, C) noisy input
        time_steps: torch.Tensor,   # raw t in [0, 1] (API parity, unused)
        time: torch.Tensor,         # log-SNR conditioning, (B,)
        *,
        lowres_cond_img: Optional[torch.Tensor] = None,
        cond_images: Optional[torch.Tensor] = None,
        self_cond: Optional[torch.Tensor] = None,
        cond_drop_prob: float = 0.0,
    ) -> torch.Tensor:
        # unconditional like the JAX module, which takes cond_drop_prob for
        # the wrappers' signature and ignores it
        del time_steps, cond_drop_prob
        dt = self.dtype
        x = x.to(dt)
        # conditioning concat in the JAX module's order (unet2d.py:206-215)
        if self.self_cond:
            x = torch.cat([x, torch.zeros_like(x) if self_cond is None else self_cond.to(dt)],
                          dim=-1)
        if self.lowres_cond != (lowres_cond_img is not None):
            raise ValueError("a lowres conditioning image goes with lowres_cond=True, and "
                             "only with it")
        if lowres_cond_img is not None:
            x = torch.cat([x, lowres_cond_img.to(dt)], dim=-1)
        if self.cond_images_channels > 0:
            if cond_images is None:
                raise ValueError("conditioning images not supplied")
            x = torch.cat([cond_images.to(dt), x], dim=-1)

        x = self.init_conv(x)
        t = self.to_time_hiddens[0](time).to(dt)
        t = self.to_time_cond(mish(self.to_time_hiddens[1](t)))

        hiddens = []
        for ind in range(self.num_layers):
            x = getattr(self, f"down{ind}_init")(x, t)
            if self.down_attn[ind]:
                x = getattr(self, f"down{ind}_attn")(x)
            for bi in range(self.num_blocks[ind]):
                x = getattr(self, f"down{ind}_block{bi}")(x, t)
            if ind < self.num_layers - 1:
                hiddens.append(x)
            x = getattr(self, f"down{ind}_post")(x)

        if self.mid_attn is not None:
            x = self.mid_attn(x)
        x = self.mid_block(x, t)

        rev_blocks = list(reversed(self.num_blocks))
        for ind in range(self.num_layers):
            if ind < self.num_layers - 1:
                x = getattr(self, f"up{ind}_upsample")(x)
                x = torch.cat([x, hiddens.pop().to(x.dtype)], dim=-1)
            x = getattr(self, f"up{ind}_init")(x, t)
            for bi in range(rev_blocks[ind]):
                x = getattr(self, f"up{ind}_block{bi}")(x, t)

        if self.final_res_block is not None:
            x = self.final_res_block(x, t)
        # the output conv in fp32 on an fp32 cast (JAX unet2d.py:296-297)
        return self.final_conv(x.float())
