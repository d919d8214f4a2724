"""The 3D IQT U-Net (counterpart of ``diffusioniqt_tpu/models/unet3d.py``),
channels-last, with every option of the JAX ``UNet3D``.

Per level: an optional pre-downsample (``memory_efficient``), an init
ResnetBlock, an optional attention slot and ``num_resnet_blocks`` more
ResnetBlocks, then the SP-conv downsample (or, with ``memory_efficient``,
a 1x1 conv, the level having downsampled on entry); the optional
``deep_feature`` middle (attention + ResnetBlock); pixel-shuffle or deconv
upsample with skip concat (with ``memory_efficient`` every up level
upsamples); a final ResnetBlock and the output conv in fp32. The stem is a
3^3 conv, a conv of another odd size (``init_conv_kernel_size``), or the
cross-embed stem (``init_cross_embed``, kernel sizes 3 / 7 / 15 by
default; not with ``boundary``). Learned-sinusoidal time embedding;
optional self-conditioning and conditioning-image channels.

With ``boundary`` every 3^3 conv is a halo exchange over the ``factor^3``
sub-volume grid followed by a VALID conv (kernels in ``ops/kernels``);
without it the same kernels run with ``factor=1``, which is a SAME conv.
The fused Block kernel takes sub-volume edges that are multiples of 8 and,
by its small-edge route, 4 and 2: the levels ``memory_efficient`` adds.
``merged_boundary`` runs on the split layout too: a halo exchange plus a
VALID conv per sub-volume is the SAME conv over the merged volume (the JAX
``tests/test_unet3d.py`` holds the two layouts to each other), so the
Blocks and the 3^3 stem run on the split kernels, and only what is not
local to a sub-volume runs on the merged volume as the JAX merged mode
runs it: the time embedding (one per group of ``factor^3`` sub-volumes,
the group's first), and the cuDNN convs of other kernel sizes (the stem at
``init_conv_kernel_size`` != 3, the final conv at ``final_conv_kernel_size``
> 1, the deconv upsample). Attention (``models/attention.py``, ``att_type``
linear / softmax / vit) runs on the merged volume of each group of
``batch_sample_factor^3`` sub-volumes; softmax attention goes through the
flash-attention kernel. The stem and final convs of other sizes, the
cross-embed stem and the deconv upsample are cuDNN convolutions, as the
JAX package leaves them to XLA.

Training: the attention dropout (``att_drop`` and ``att_forward_drop``
for ViT3D, a constant 0.05 on the q/k/v inputs of Linear/SoftMax
attention, as in the JAX modules) acts in ``train()`` mode only. ``remat``
with ``remat_policy=None`` recomputes every ResnetBlock in the backward
pass (``torch.utils.checkpoint``, the JAX ``nn.remat`` of
unet3d.py:284-294), which launches its kernels a second time. With
``remat_policy='conv'`` nothing is checkpointed: each Block already saves
only its input (the previous conv's output) and its backward recomputes
only the GroupNorm / affine / Mish chain and the halo, then runs the conv's
backward products without its forward (``ops/kernels/fused_block.py``), the
recompute that the JAX policy (save ``conv_in`` / ``conv_out``) leaves.
Its memory is that of no remat.

Tensor parallelism: after ``parallel/sharding.py::shard_module_`` each
layer whose weight the JAX rule shards (a conv or dense kernel of at least
4096 elements whose output width divides by the model size) holds its
``Cout / M`` output channels and computes them, and the model group
gathers them along the channel axis (the Megatron column split; the JAX
mesh trainer's ``P(..., "model")``). The fused Block kernel then runs on
the weight shard; the activations between layers are whole on every rank.

``use_pallas`` is accepted for the JAX signature and changes nothing: the
port always runs its kernels on the card. ``attn_heads`` is accepted and,
as in the JAX module, unused (the slots take ``attend_at_*_heads``).

Module and parameter names are the reference ``Unet``'s
(imagen_pytorch3D.py:1188-1737): ``init_conv`` (``init_conv.convs.{i}``
for the cross-embed stem), ``to_time_hiddens.{0,1}``, ``to_time_cond.0``,
``downs.{i}.{0,1,2,3,4}`` (``downs.{i}.0.1`` the pre-downsample's conv),
``mid_attn``, ``mid_block``, ``ups.{i}.{0,1,2}`` (``ups.{i}.0.deconv.0``
the deconv), ``final_res_block``, ``final_conv``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from diffusioniqt_tpu_torch.models.attention import AttentionTransformerBlock, ViT3D
from diffusioniqt_tpu_torch.models.blocks import (
    CastToCascade,
    Conv3d,
    CrossEmbedLayer,
    DeconvUpsample,
    Dense,
    Downsample,
    LearnedSinusoidalPosEmb,
    PixelShuffleUpsample,
    PointwiseConv,
    ResnetBlock,
    SameConv,
)
from diffusioniqt_tpu_torch.ops.kernels import KERNELS, Ops
from diffusioniqt_tpu_torch.ops.kernels.conv3d import PackedWeight
from diffusioniqt_tpu_torch.ops.volume import (
    resize_volume,
    subvolumes_to_volume,
    volume_to_subvolumes,
)
from diffusioniqt_tpu_torch.parallel.sharding import column_parallel
from diffusioniqt_tpu_torch.utils.misc import cast_tuple, mish, resolve_device


class UNet3D(CastToCascade, nn.Module):
    """3D conditional diffusion U-Net."""

    def __init__(
        self,
        dim: int = 64,
        img_size: int = 96,
        num_resnet_blocks: Union[int, Tuple[int, ...]] = 2,
        dim_mults: Tuple[int, ...] = (1, 2, 4),
        channels: int = 1,
        channels_out: Optional[int] = None,
        cond_images_channels: int = 0,
        lowres_cond: bool = True,
        self_cond: bool = False,
        learned_sinu_pos_emb_dim: int = 16,
        init_dim: Optional[int] = 64,
        resnet_groups: Union[int, Tuple[int, ...]] = 8,
        use_se_attn: bool = True,
        final_resnet_block: bool = True,
        scale_skip_connection: bool = False,
        boundary: bool = True,
        batch_sample: bool = True,
        batch_sample_factor: int = 3,
        deep_feature: bool = False,
        attend_at_middle: bool = False,
        attend_at_enc: Union[bool, Sequence[bool]] = False,
        att_type: str = "vit",
        attn_dim_head: int = 64,
        attn_heads: int = 8,
        attend_at_middle_depth: int = 1,
        attend_at_middle_heads: int = 8,
        attend_at_enc_depth: Union[int, Sequence[int]] = 1,
        attend_at_enc_heads: Union[int, Sequence[int]] = 8,
        att_drop: float = 0.1,
        att_forward_drop: float = 0.3,
        att_forward_expansion: int = 2,
        att_localvit: bool = True,
        init_patch_size: int = 8,
        use_flash: bool = True,
        merged_boundary: bool = False,
        memory_efficient: bool = False,
        init_cross_embed: bool = False,
        init_cross_embed_kernel_sizes: Tuple[int, ...] = (3, 7, 15),
        pixel_shuffle_upsample: bool = True,
        init_conv_kernel_size: int = 3,
        final_conv_kernel_size: int = 1,
        use_pallas: bool = False,
        remat: bool = False,
        remat_policy: Optional[str] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.config = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        del attn_heads, use_pallas  # the JAX signature's; unused there too / always kernels
        num_layers = len(dim_mults)
        if remat and remat_policy not in (None, "conv"):
            raise ValueError(f"unknown remat_policy {remat_policy!r}")
        if init_cross_embed and boundary:
            raise ValueError("boundary mode requires the plain init conv (init_cross_embed=False)")
        merged = merged_boundary and boundary and batch_sample
        if boundary and not merged and not init_cross_embed and init_conv_kernel_size != 3:
            # the JAX module's VALID conv of another size after a one-voxel
            # halo changes the sub-volume's edge
            raise ValueError("the split boundary layout needs init_conv_kernel_size=3")

        self.channels = channels
        self.channels_out = channels_out or channels
        self.lowres_cond = lowres_cond
        self.self_cond = self_cond
        self.cond_images_channels = cond_images_channels
        self.img_size = img_size
        self.batch_sample = batch_sample
        self.batch_sample_factor = batch_sample_factor
        self.merged = merged
        self.dtype = dtype
        self.remat = remat
        self.remat_policy = remat_policy
        self.skip_scale = 2 ** -0.5 if scale_skip_connection else 1.0
        factor = batch_sample_factor if boundary else 1
        self.factor = factor

        num_blocks = cast_tuple(num_resnet_blocks, num_layers)
        groups = cast_tuple(resnet_groups, num_layers)
        init_dim = init_dim or dim
        time_cond_dim = dim * 4
        in_ch = (channels * (2 if lowres_cond else 1) + (channels if self_cond else 0)
                 + cond_images_channels)

        self.ops = KERNELS
        # the 3^3 stem runs through the halo and conv3d kernels
        self._kernel_stem = not init_cross_embed and init_conv_kernel_size == 3
        if init_cross_embed:
            self.init_conv = CrossEmbedLayer(in_ch, init_dim, init_cross_embed_kernel_sizes)
        elif self._kernel_stem:
            self.init_conv = Conv3d(in_ch, init_dim, 3)
        else:
            self.init_conv = SameConv(in_ch, init_dim, init_conv_kernel_size)
        self._init_packed = PackedWeight()
        self.to_time_hiddens = nn.Sequential(
            LearnedSinusoidalPosEmb(learned_sinu_pos_emb_dim),
            Dense(learned_sinu_pos_emb_dim + 1, time_cond_dim),
        )
        self.to_time_cond = nn.Sequential(Dense(time_cond_dim, time_cond_dim))

        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        mid_dim = dims[-1]

        def resnet(d_in, d_out, g, use_se=use_se_attn):
            return ResnetBlock(d_in, d_out, time_cond_dim=time_cond_dim,
                               groups=g, use_se=use_se, factor=factor)

        def attention(d, depth, heads, img, patch):
            if att_type == "vit":
                return ViT3D(d, patch_size=patch, num_heads=heads,
                             dim_head=attn_dim_head, img_size=img, depth=depth,
                             forward_expansion=att_forward_expansion,
                             local=att_localvit, drop_p=att_drop,
                             forward_drop_p=att_forward_drop)
            return AttentionTransformerBlock(
                d, att_type=att_type, depth=depth, heads=heads,
                dim_head=attn_dim_head, ff_mult=att_forward_expansion,
                patch_size=patch, patch=True, use_flash=use_flash)

        # the merged volume's edge and the attention patch size per level
        cur_size, patch_size = img_size, init_patch_size
        self.attend_enc = cast_tuple(attend_at_enc, num_layers)
        if any(self.attend_enc):
            # read only when a slot is on: with attention off a config may
            # carry per-level lists of another length, which go unused
            enc_depth = cast_tuple(attend_at_enc_depth, num_layers)
            enc_heads = cast_tuple(attend_at_enc_heads, num_layers)

        # downs.{i} = [pre-downsample, init block, attention, blocks, post]
        self.downs = nn.ModuleList()
        skip_dims = []
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind == num_layers - 1
            if memory_efficient:
                # downsample on entry; the level runs at dim_out
                pre, cur = Downsample(dim_in, dim_out), dim_out
                post = PointwiseConv(dim_out, dim_out)
                cur_size //= 2
            else:
                pre, cur = nn.Identity(), dim_in
                post = (PointwiseConv(dim_in, dim_out) if is_last
                        else Downsample(dim_in, dim_out))
            attn = (attention(cur, enc_depth[ind], enc_heads[ind], cur_size, patch_size)
                    if self.attend_enc[ind] else nn.Identity())
            self.downs.append(nn.ModuleList([
                pre,
                resnet(cur, cur, groups[ind]),
                attn,
                nn.ModuleList([resnet(cur, cur, groups[ind])
                               for _ in range(num_blocks[ind])]),
                post,
            ]))
            if not is_last:
                skip_dims.append(cur)
                if not memory_efficient:
                    cur_size //= 2
                patch_size = max(patch_size // 2, 1)

        self.mid_attn = (attention(mid_dim, attend_at_middle_depth,
                                   attend_at_middle_heads, cur_size, patch_size)
                         if deep_feature and attend_at_middle else None)
        # the JAX mid ResnetBlock has no squeeze-excite
        self.mid_block = (resnet(mid_dim, mid_dim, groups[-1], use_se=False)
                          if deep_feature else None)

        # ups.{i} = [upsample, init block, blocks]; with memory_efficient
        # the last level upsamples too (JAX unet3d.py:371-375)
        self.ups = nn.ModuleList()
        rev_blocks = list(reversed(num_blocks))
        rev_groups = list(reversed(groups))
        upsample_cls = PixelShuffleUpsample if pixel_shuffle_upsample else DeconvUpsample
        x_dim = mid_dim
        for ind, (dim_out_lvl, _) in enumerate(reversed(in_out)):
            is_last = ind == num_layers - 1
            upsample = (upsample_cls(x_dim, dim_out_lvl) if not is_last or memory_efficient
                        else nn.Identity())
            if not isinstance(upsample, nn.Identity):
                x_dim = dim_out_lvl
            if not is_last:
                x_dim += skip_dims.pop()
            self.ups.append(nn.ModuleList([
                upsample,
                resnet(x_dim, dim_out_lvl, rev_groups[ind]),
                nn.ModuleList([resnet(dim_out_lvl, dim_out_lvl, rev_groups[ind])
                               for _ in range(rev_blocks[ind])]),
            ]))
            x_dim = dim_out_lvl

        self.final_res_block = (resnet(x_dim, dim, groups[0])
                                if final_resnet_block else None)
        final_in = dim if final_resnet_block else x_dim
        self.final_conv = (PointwiseConv(final_in, self.channels_out)
                           if final_conv_kernel_size == 1
                           else SameConv(final_in, self.channels_out, final_conv_kernel_size))

    # ------------------------------------------------------------------
    def use_ops(self, ops: Ops) -> "UNet3D":
        """Route every 3^3 conv and softmax attention through ``ops``
        (``KERNELS`` or ``PLAIN``)."""
        for m in self.modules():
            if hasattr(m, "ops"):
                m.ops = ops
        return self

    def _resnet(self, block: nn.Module, x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """One ResnetBlock, recomputed in the backward pass under ``remat``
        with the full policy (``remat_policy=None``)."""
        if self.remat and self.remat_policy is None and torch.is_grad_enabled():
            return checkpoint(block, x, t, use_reentrant=False)
        return block(x, t)

    def _on_volume(self, fn, x: torch.Tensor) -> torch.Tensor:
        """``fn`` on each group's merged volume in merged-boundary mode (a
        conv that is not local to a sub-volume), else on ``x`` as it is."""
        if not self.merged:
            return fn(x)
        f = self.batch_sample_factor
        return volume_to_subvolumes(fn(subvolumes_to_volume(x, f)), f)

    def _attend_merged(self, x: torch.Tensor, attn: nn.Module,
                       residual: bool = True) -> torch.Tensor:
        """Merge each group of f^3 sub-volumes into one volume, attend, split
        back (reference imagen_pytorch3D.py:1610-1622). The encoder slots
        add the outer residual; the mid slot does not (the reference's mid
        path never adds its ``res`` back, :1636-1642)."""
        res = x
        if self.batch_sample:
            x = subvolumes_to_volume(x, self.batch_sample_factor)
        x = attn(x)
        if self.batch_sample:
            x = volume_to_subvolumes(x, self.batch_sample_factor)
        return (x + res if residual else x).contiguous()

    def forward(
        self,
        x: torch.Tensor,            # (B, s, s, s, C) noisy input
        time_steps: torch.Tensor,   # raw t in [0, 1] (API parity, unused)
        time: torch.Tensor,         # log-SNR conditioning, (B,)
        *,
        lowres_cond_img: Optional[torch.Tensor] = None,
        cond_images: Optional[torch.Tensor] = None,
        self_cond: Optional[torch.Tensor] = None,
        cond_drop_prob: float = 0.0,
    ) -> torch.Tensor:
        # the IQT U-Net is unconditional: the JAX UNet3D takes
        # cond_drop_prob for API parity and ignores it, and so does this one
        del time_steps, cond_drop_prob
        dt = self.dtype
        x = x.to(dt)
        # conditioning concat, in the JAX module's order (unet3d.py:219-231)
        if self.self_cond:
            x = torch.cat([x, (torch.zeros_like(x) if self_cond is None
                               else self_cond.to(dt))], dim=-1)
        if self.lowres_cond and lowres_cond_img is None:
            raise ValueError("low resolution conditioning image must be present")
        if lowres_cond_img is not None:
            x = torch.cat([x, lowres_cond_img.to(dt)], dim=-1)
        if self.cond_images_channels > 0:
            if cond_images is None:
                raise ValueError("conditioning images not supplied")
            x = torch.cat([resize_volume(cond_images, x.shape[1]).to(dt), x], dim=-1)

        if self._kernel_stem:
            xh = self.ops.halo(x.contiguous(), self.factor)

            def stem(xh, bias):
                return self.ops.conv3d(xh, self.init_conv.weight, self._init_packed) + bias.to(dt)
            x = (stem(xh, self.init_conv.bias) if self.init_conv.tp is None
                 else column_parallel(self.init_conv.tp, xh, stem, self.init_conv.bias))
        else:
            x = self._on_volume(self.init_conv, x)

        if self.merged:
            # one diffusion time per group of f^3 sub-volumes, its first
            # (the JAX merged mode's time[:: f^3])
            f3 = self.batch_sample_factor ** 3
            time = time[::f3].repeat_interleave(f3)
        t = self.to_time_hiddens[0](time).to(dt)
        t = mish(self.to_time_hiddens[1](t))
        t = self.to_time_cond(t)

        hiddens = []
        for ind, (pre, init_block, attn, blocks, post) in enumerate(self.downs):
            x = pre(x)
            x = self._resnet(init_block, x, t)
            if self.attend_enc[ind]:
                x = self._attend_merged(x, attn)
            for block in blocks:
                x = self._resnet(block, x, t)
            if ind < len(self.downs) - 1:
                hiddens.append(x)
            x = post(x)

        if self.mid_attn is not None:
            x = self._attend_merged(x, self.mid_attn, residual=False)
        if self.mid_block is not None:
            x = self._resnet(self.mid_block, x, t)

        for upsample, init_block, blocks in self.ups:
            x = (self._on_volume(upsample, x) if isinstance(upsample, DeconvUpsample)
                 else upsample(x))
            if hiddens:
                skip = hiddens.pop() * self.skip_scale
                x = torch.cat([x, skip.to(x.dtype)], dim=-1)
            x = self._resnet(init_block, x, t)
            for block in blocks:
                x = self._resnet(block, x, t)

        if self.final_res_block is not None:
            x = self._resnet(self.final_res_block, x, t)
        return self._on_volume(self.final_conv, x.float())


class NullUnet(nn.Module):
    """Identity placeholder for untrained cascade stages (reference
    imagen_pytorch3D.py:1688-1698)."""

    lowres_cond = False

    def __init__(self):
        super().__init__()
        self.dummy = nn.Parameter(torch.zeros(1))

    def cast_model_parameters(self, **_ignored) -> "NullUnet":
        return self

    def forward(self, x, *args, **kwargs):
        return x


# the JAX ``UNet3D``'s defaults where the port's differ (unet3d.py:62-143):
# what a preset or a JSON config that leaves a field out gets there
JAX_DEFAULTS = dict(
    num_resnet_blocks=1, dim_mults=(1, 2, 4, 8), channels=3, lowres_cond=False,
    init_dim=32, init_cross_embed=True, boundary=False, deep_feature=True,
    attend_at_middle=True,
)


def SRUnet256(**kwargs) -> UNet3D:
    """Super-resolution preset (JAX unet3d.py:426-433, reference
    imagen_pytorch3D.py:1714-1724) on the JAX ``UNet3D`` defaults: dim
    128, mults (1, 2, 4, 8), ResnetBlocks (2, 4, 8, 8), memory_efficient,
    the cross-embed stem (3, 7, 15), ViT at the middle, deep_feature."""
    defaults = dict(dim=128, dim_mults=(1, 2, 4, 8), num_resnet_blocks=(2, 4, 8, 8),
                    attn_heads=8, memory_efficient=True)
    return UNet3D(**{**JAX_DEFAULTS, **defaults, **kwargs})


def BaseUnet64(**kwargs) -> UNet3D:
    """Base-stage preset (JAX unet3d.py:436-442, reference
    imagen_pytorch3D.py:1702-1712)."""
    defaults = dict(dim=512, dim_mults=(1, 2, 3, 4), num_resnet_blocks=3,
                    attn_heads=8, memory_efficient=False)
    return UNet3D(**{**JAX_DEFAULTS, **defaults, **kwargs})


def SRUnet1024(**kwargs) -> UNet3D:
    """High-res SR preset (JAX unet3d.py:445-451, reference
    imagen_pytorch3D.py:1726-1737)."""
    defaults = dict(dim=128, dim_mults=(1, 2, 4, 8), num_resnet_blocks=(2, 4, 8, 8),
                    attn_heads=8, memory_efficient=True)
    return UNet3D(**{**JAX_DEFAULTS, **defaults, **kwargs})


def iqt_unet_from_config(cfg, device="cuda", **overrides) -> UNet3D:
    """Build the IQT SR U-Net as the JAX ``iqt_unet_from_config`` does
    (reference train.py:83-116 / test.py:77-108), with parameters on
    ``device``; ``overrides`` are ``UNet3D`` arguments that the config does
    not carry (``merged_boundary``). Raises if CUDA is asked for and
    missing."""
    device = resolve_device(device)
    train = cfg.train
    model = UNet3D(
        dim=train.dim,
        img_size=train.patch_size,
        dim_mults=train.dim_mults,
        channels=train.channels,
        num_resnet_blocks=train.num_resnet_blocks,
        init_conv_kernel_size=3,
        lowres_cond=True,
        init_cross_embed=False,
        att_type=train.att_type,
        attn_dim_head=train.att_head_dim,
        attend_at_middle=train.att_mid,
        attend_at_middle_depth=train.att_mid_depth,
        attend_at_middle_heads=train.att_mid_heads,
        attend_at_enc=train.att_enc,
        attend_at_enc_depth=train.att_enc_depth,
        attend_at_enc_heads=train.att_enc_heads,
        att_drop=train.att_drop,
        att_forward_drop=train.att_forward_drop,
        att_forward_expansion=train.att_forward_expansion,
        att_localvit=train.att_localvit,
        init_dim=train.init_dim,
        resnet_groups=train.resnet_groups,
        memory_efficient=train.efficient,
        use_se_attn=train.use_se,
        pixel_shuffle_upsample=True,
        boundary=train.boundary,
        batch_sample=train.batch_sample,
        batch_sample_factor=train.batch_sample_factor,
        deep_feature=train.deep_feature,
        remat=train.remat,
        remat_policy=train.remat_policy,
        dtype=torch.bfloat16 if train.compute_dtype == "bfloat16" else torch.float32,
        **overrides,
    )
    return model.to(device)
