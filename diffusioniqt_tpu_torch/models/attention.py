"""Volumetric attention of the IQT U-Net (counterpart of
``diffusioniqt_tpu/models/attention.py``), channels-last.

The three ``att_type`` families of the reference
(imagen_pytorch3D.py:723-1186):

  * ``LinearAttention``   softmax(q over d) . softmax(k over N), O(N)
  * ``SoftMaxAttention``  full softmax attention through
                          ``ops.attention.scaled_dot_product_attention``
                          (the flash-attention kernel on the card)
  * ``ViT3D``             patch embedding, transformer encoder (its
                          ``MultiHeadAttention`` takes the same route),
                          trilinear-upsample reconstruction

plus ``Patchify`` / ``PatchReconstruct``, ``ChanFeedForward`` and the
``AttentionTransformerBlock`` wrapper. The modules see one merged
``(B, X, Y, Z, C)`` volume; the U-Net merges and splits the sub-volumes.

Depthwise and 1x1 convolutions, layer norms and the linear-attention
products are plain PyTorch in the activation's dtype (the JAX package
leaves them to XLA). Dropout sits where the JAX modules put it
(attention.py:124,335,365,369,394,404) and acts in ``train()`` mode only:
0.05 on the q/k/v inputs of Linear/SoftMax attention (a constant there),
the ViT's ``drop_p`` after its attention and each residual branch and
``forward_drop_p`` in its feed-forward. Dropout slots hold no parameters,
so the names still match the reference ``state_dict`` (``to_q.{1,2}``,
``to_out.{0,1}``, ``layers.{d}.1.{0,1,3,4}``, ViT
``block.{0,1}.fn.{0,1}``, ``reconstruction.{0,3,4}``, ...).

Linear and softmax attention built with ``context_dim`` take a text
``context`` ``(B, L, context_dim)`` (JAX attention.py:162-171, 222-231):
its LayerNorm (flax's, eps 1e-6) and a dense layer without bias
(``to_context.{0,1}``) give per-head keys and values that follow the
voxel tokens', so softmax attention sends Nq = N queries against
Nk = N + L keys to the flash kernel. ``ViT3D`` takes no context, as in the
JAX package, and refuses one.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusioniqt_tpu_torch.models.blocks import ChanLayerNorm, Dense, LecunInit, PointwiseConv
from diffusioniqt_tpu_torch.ops.attention import scaled_dot_product_attention
from diffusioniqt_tpu_torch.ops.kernels import KERNELS
from diffusioniqt_tpu_torch.ops.volume import upsample_trilinear
from diffusioniqt_tpu_torch.parallel.sharding import ColumnParallel
from diffusioniqt_tpu_torch.utils.misc import Mish, mish


class ChannelsLastConv3d(ColumnParallel, LecunInit, nn.Conv3d):
    """``nn.Conv3d`` applied to a channels-last tensor in its dtype (flax's
    initialisers; a depthwise kernel's fan_in is its extent, as in flax).
    A column-sharded depthwise conv reads only this rank's input channels."""

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        if self.groups not in (1, self.in_channels):
            raise ValueError("ChannelsLastConv3d is a dense or a depthwise conv")
        groups = self.groups
        if groups > 1 and self.tp is not None:
            n = self.weight.shape[0]
            x, groups = x[..., self.tp.rank * n:(self.tp.rank + 1) * n], n
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight.to(x.dtype),
                     None if bias is None else bias.to(x.dtype),
                     self.stride, self.padding, self.dilation, groups)
        return y.permute(0, 2, 3, 4, 1)


class LayerNorm(nn.LayerNorm):
    """Token LayerNorm with flax's eps 1e-6, statistics in fp32, result in
    the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class AlignCornersUpsample(nn.Module):
    """``upsample_trilinear`` by ``scale`` with ``align_corners=True``, as a
    parameter-free slot of a ``Sequential`` (not the U-Net's
    ``blocks.TrilinearUpsample``, which resamples half-pixel and convolves)."""

    def __init__(self, scale: int):
        super().__init__()
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return upsample_trilinear(x, self.scale)


class DepthwiseSeparableConv(nn.Module):
    """Depthwise 3D conv (with bias) + 1x1 conv (reference
    ``depthwise_separable_conv3d``, imagen_pytorch3D.py:858-869)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 0):
        super().__init__()
        self.depthwise = ChannelsLastConv3d(dim_in, dim_in, kernel_size, stride,
                                            padding, groups=dim_in)
        self.pointwise = PointwiseConv(dim_in, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class Patchify(nn.Module):
    """ChanLayerNorm, then a depthwise conv with kernel = stride = patch and
    a 1x1 (reference imagen_pytorch3D.py:913-924)."""

    def __init__(self, dim: int, emb_size: int, patch_size: int = 2):
        super().__init__()
        self.norm = ChanLayerNorm(dim)
        self.projection = DepthwiseSeparableConv(dim, emb_size, patch_size, patch_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.projection(self.norm(x))


class PatchReconstruct(nn.Sequential):
    """Trilinear upsample (align_corners) + depthwise separable 3^3 conv +
    ChanLayerNorm (reference imagen_pytorch3D.py:952-959)."""

    def __init__(self, dim: int, patch_size: int = 2):
        super().__init__(AlignCornersUpsample(patch_size),
                         DepthwiseSeparableConv(dim, dim, 3, 1, 1),
                         ChanLayerNorm(dim))


def _split_heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, X, Y, Z, h*d) -> (B*h, N, d), head-major channels."""
    b = t.shape[0]
    d = t.shape[-1] // heads
    t = t.reshape(b, -1, heads, d).permute(0, 2, 1, 3)
    return t.reshape(b * heads, -1, d)


def _merge_heads(t: torch.Tensor, heads: int, spatial) -> torch.Tensor:
    """(B*h, N, d) -> (B, X, Y, Z, h*d)."""
    bh, n, d = t.shape
    t = t.reshape(bh // heads, heads, n, d).permute(0, 2, 1, 3)
    return t.reshape(bh // heads, *spatial, heads * d)


def _qkv_conv(dim: int, inner_dim: int, dropout: float) -> nn.Sequential:
    """Dropout -> 1x1 conv -> depthwise 3^3 SAME conv, no biases (reference
    imagen_pytorch3D.py:960-976)."""
    return nn.Sequential(
        nn.Dropout(dropout),
        PointwiseConv(dim, inner_dim, bias=False),
        ChannelsLastConv3d(inner_dim, inner_dim, 3, padding=1, groups=inner_dim,
                           bias=False),
    )


class _VoxelAttention(nn.Module):
    """What ``LinearAttention`` and ``SoftMaxAttention`` share: optional
    Patchify, ChanLayerNorm, q/k/v projections, Mish -> 1x1 -> ChanLayerNorm
    out, optional PatchReconstruct. Subclasses define :meth:`attend` over
    ``(B*h, N, d)`` heads."""

    def __init__(self, dim: int, dim_head: int = 32, heads: int = 8,
                 patch_size: int = 2, patch: bool = False, dropout: float = 0.05,
                 context_dim: Optional[int] = None):
        super().__init__()
        inner_dim = dim_head * heads
        self.heads = heads
        self.scale = dim_head ** -0.5
        self.patch_embed = Patchify(dim, dim, patch_size) if patch else None
        self.norm = ChanLayerNorm(dim)
        self.to_q = _qkv_conv(dim, inner_dim, dropout)
        self.to_k = _qkv_conv(dim, inner_dim, dropout)
        self.to_v = _qkv_conv(dim, inner_dim, dropout)
        self.to_out = nn.Sequential(PointwiseConv(inner_dim, dim, bias=False),
                                    ChanLayerNorm(dim))
        self.reconstruct = PatchReconstruct(dim, patch_size) if patch else None
        self.to_context = (nn.Sequential(LayerNorm(context_dim),
                                         Dense(context_dim, inner_dim * 2, bias=False))
                           if context_dim is not None else None)

    def attend(self, q, k, v) -> torch.Tensor:
        raise NotImplementedError

    def forward(self, fmap: torch.Tensor, context=None) -> torch.Tensor:
        if self.patch_embed is not None:
            fmap = self.patch_embed(fmap)
        spatial = fmap.shape[1:4]
        fmap = self.norm(fmap)
        q, k, v = (_split_heads(proj(fmap), self.heads)
                   for proj in (self.to_q, self.to_k, self.to_v))
        if context is not None:
            if self.to_context is None:
                raise ValueError("a text context needs the module built with context_dim")
            # the LayerNorm on the context as given, the projection in the
            # activations' dtype
            ctx = self.to_context[1](self.to_context[0](context).to(fmap.dtype))
            ck, cv = (_split_heads(t, self.heads) for t in ctx.chunk(2, dim=-1))
            k, v = torch.cat([k, ck], dim=-2), torch.cat([v, cv], dim=-2)
        out = _merge_heads(self.attend(q, k, v), self.heads, spatial)
        out = self.to_out(mish(out))
        if self.reconstruct is not None:
            out = self.reconstruct(out)
        return out


class LinearAttention(_VoxelAttention):
    """O(N) linear attention over voxel tokens (reference
    imagen_pytorch3D.py:926-1016): softmax of q over d and of k over N,
    then q scaled."""

    def attend(self, q, k, v) -> torch.Tensor:
        q = torch.softmax(q, dim=-1) * self.scale
        k = torch.softmax(k, dim=-2)
        context = torch.einsum("bnd,bne->bde", k, v)
        return torch.einsum("bnd,bde->bne", q, context)


class SoftMaxAttention(_VoxelAttention):
    """Full softmax attention over voxel tokens (reference
    imagen_pytorch3D.py:1018-1106), through the flash-attention kernel on
    the card (``ops`` picks the kernels or their plain versions)."""

    def __init__(self, *args, use_flash: bool = True, **kwargs):
        super().__init__(*args, **kwargs)
        self.use_flash = use_flash
        self.ops = KERNELS

    def attend(self, q, k, v) -> torch.Tensor:
        return scaled_dot_product_attention(q, k, v, self.scale,
                                            use_flash=self.use_flash, ops=self.ops)


class ChanFeedForward(nn.Sequential):
    """ChanLayerNorm -> 1x1 -> GELU (tanh, as ``jax.nn.gelu``) ->
    ChanLayerNorm -> 1x1, no biases (reference imagen_pytorch3D.py:1108-1116)."""

    def __init__(self, dim: int, mult: float = 2.0):
        hidden = int(dim * mult)
        super().__init__(ChanLayerNorm(dim), PointwiseConv(dim, hidden, bias=False),
                         nn.GELU(approximate="tanh"), ChanLayerNorm(hidden),
                         PointwiseConv(hidden, dim, bias=False))


class AttentionTransformerBlock(nn.Module):
    """``depth`` x (attention + ChanFeedForward), each with a residual
    (reference imagen_pytorch3D.py:1118-1186); ``layers.{d}.{0,1}``."""

    def __init__(self, dim: int, att_type: str = "linear", depth: int = 1,
                 heads: int = 8, dim_head: int = 32, ff_mult: float = 2.0,
                 patch_size: int = 2, patch: bool = False, use_flash: bool = True,
                 context_dim: Optional[int] = None):
        super().__init__()
        kw = dict(dim_head=dim_head, heads=heads, patch_size=patch_size, patch=patch,
                  context_dim=context_dim)
        self.layers = nn.ModuleList()
        for _ in range(depth):
            attn = (LinearAttention(dim, **kw) if att_type == "linear"
                    else SoftMaxAttention(dim, use_flash=use_flash, **kw))
            self.layers.append(nn.ModuleList([attn, ChanFeedForward(dim, ff_mult)]))

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        for attn, ff in self.layers:
            x = attn(x, context=context) + x
            x = ff(x) + x
        return x


# ------------------------------------------------------------------- ViT3D

class MultiHeadAttention(nn.Module):
    """Token multi-head attention of ViT3D (reference
    imagen_pytorch3D.py:811-838); the qkv Dense packs channels as
    (h, d, qkv)."""

    def __init__(self, emb_size: int, num_heads: int = 8, dim_head: int = 64,
                 use_flash: bool = True, dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = num_heads, dim_head
        inner = dim_head * num_heads
        self.qkv = Dense(emb_size, inner * 3)
        self.drop = nn.Dropout(dropout)
        self.projection = Dense(inner, emb_size)
        self.use_flash = use_flash
        self.ops = KERNELS

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        qkv = self.qkv(x).reshape(b, n, h, d, 3).permute(4, 0, 2, 1, 3)
        q, k, v = (t.reshape(b * h, n, d) for t in qkv)
        out = scaled_dot_product_attention(q, k, v, d ** -0.5,
                                           use_flash=self.use_flash, ops=self.ops)
        out = out.reshape(b, h, n, d).permute(0, 2, 1, 3).reshape(b, n, h * d)
        return self.projection(self.drop(out))


class FeedForwardBlock(nn.Module):
    """ViT feed-forward (reference imagen_pytorch3D.py:774-809): Dense ->
    Mish -> dropout -> Dense, or with ``local`` (LocalViT) 1x1 -> Mish ->
    depthwise separable 3^3 -> Mish -> 1x1 -> dropout over the
    ``patch_num^3`` token cube."""

    def __init__(self, emb_size: int, expansion: int = 4, patch_num: int = 4,
                 local: bool = False, drop_p: float = 0.0):
        super().__init__()
        hidden = emb_size * expansion
        self.local = local
        self.patch_num = patch_num
        if local:  # slot net.0.0 is the reference's token -> cube rearrange
            self.net = nn.Sequential(
                nn.Sequential(nn.Identity(), PointwiseConv(emb_size, hidden), Mish()),
                nn.Sequential(DepthwiseSeparableConv(hidden, hidden, 3, 1, 1), Mish()),
                nn.Sequential(PointwiseConv(hidden, emb_size), nn.Dropout(drop_p)),
            )
        else:
            self.net = nn.Sequential(Dense(emb_size, hidden), Mish(), nn.Dropout(drop_p),
                                     Dense(hidden, emb_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.local:
            return self.net(x)
        b, n, c = x.shape
        p = self.patch_num
        return self.net(x.reshape(b, p, p, p, c)).reshape(b, n, -1)


class _PreNormResidual(nn.Module):
    """``x + dropout(fn(x))`` with ``fn = Sequential(LayerNorm, module)``."""

    def __init__(self, dim: int, module: nn.Module, drop_p: float = 0.0):
        super().__init__()
        self.fn = nn.Sequential(LayerNorm(dim), module)
        self.drop = nn.Dropout(drop_p)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.drop(self.fn(x))


class TransformerEncoderBlock(nn.Module):
    """Pre-norm MHA and feed-forward, each with a residual (reference
    imagen_pytorch3D.py:723-749); ``block.{0,1}.fn.{0,1}``."""

    def __init__(self, emb_size: int, num_heads: int = 8, dim_head: int = 64,
                 forward_expansion: int = 4, patch_num: int = 4, local: bool = True,
                 drop_p: float = 0.0, forward_drop_p: float = 0.0):
        super().__init__()
        self.block = nn.Sequential(
            _PreNormResidual(emb_size, MultiHeadAttention(
                emb_size, num_heads, dim_head, dropout=drop_p), drop_p),
            _PreNormResidual(emb_size, FeedForwardBlock(
                emb_size, forward_expansion, patch_num, local, forward_drop_p), drop_p),
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.block(x)


class _PatchEmbedding(nn.Module):
    # the token positions ``(patches, emb)`` are added to the tokens: the
    # JAX rule shards them, the column split keeps them whole (sharding
    # them would gather a parameter, not an output)
    replicated_params = ("positions",)

    def __init__(self, in_channels: int, emb_size: int, patch_size: int, patch_num: int):
        super().__init__()
        self.projection = nn.Sequential(
            DepthwiseSeparableConv(in_channels, emb_size, patch_size, patch_size))
        self.positions = nn.Parameter(torch.randn(patch_num ** 3, emb_size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tok = self.projection(x)
        tok = tok.reshape(tok.shape[0], -1, tok.shape[-1])
        return tok + self.positions.to(tok.dtype)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class ViT3D(nn.Module):
    """Patch embedding -> ``depth`` transformer blocks -> LayerNorm ->
    trilinear upsample -> depthwise separable 3^3 conv -> ChanLayerNorm
    (reference imagen_pytorch3D.py:871-910)."""

    def __init__(self, in_channels: int, patch_size: int = 8, num_heads: int = 8,
                 dim_head: int = 64, img_size: int = 96, depth: int = 1,
                 forward_expansion: int = 2, local: bool = True, drop_p: float = 0.1,
                 forward_drop_p: float = 0.3):
        super().__init__()
        emb = in_channels
        self.patch_num = p = img_size // patch_size
        self.patch_embedding = _PatchEmbedding(in_channels, emb, patch_size, p)
        self.transformer_encoder = _Encoder(
            TransformerEncoderBlock(emb, num_heads, dim_head, forward_expansion, p, local,
                                    drop_p, forward_drop_p)
            for _ in range(depth))
        # slot 1 is the reference's token -> cube rearrange
        self.reconstruction = nn.Sequential(
            LayerNorm(emb), nn.Identity(), AlignCornersUpsample(patch_size),
            DepthwiseSeparableConv(emb, emb, 3, 1, 1), ChanLayerNorm(emb))

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        if context is not None:
            raise ValueError("ViT3D takes no text context (as the JAX ViT3D)")
        tok = self.patch_embedding(x)
        for layer in self.transformer_encoder.layers:
            tok = layer(tok)
        tok = self.reconstruction[0](tok)
        p = self.patch_num
        vol = tok.reshape(tok.shape[0], p, p, p, tok.shape[-1])
        return self.reconstruction[2:](vol)
