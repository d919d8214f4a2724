"""The text-conditioned video U-Net (counterpart of
``diffusioniqt_tpu/models/unet_video.py``, the ``imagen_video.Unet3D``
capability), channels-last video ``(B, F, H, W, C)``.

  * :class:`PseudoConv3d`: a frame-wise k x k conv, then a causal temporal
    conv over the frames whose kernel starts as the identity
  * :class:`VideoAttention`: attention with a null key / value, optional
    text context, cosine similarity, a continuous relative position bias
    (:class:`DynamicPositionBias`) with a learned null-column bias, a
    causal mask and a key mask, scores in fp32
  * :class:`TemporalAttention` / :class:`TemporalPEG` over the frames of
    each spatial position, the spatial and temporal (un)shuffles
  * :class:`VideoResnetBlock` (GroupNorm -> scale-shift -> SiLU ->
    PseudoConv3d blocks, token cross-attention to the conditioning, a
    global-context gate), :class:`VideoTransformerBlock`
  * :class:`PerceiverResampler`, which pools the text tokens into latents
  * :class:`Unet3DVideo`, with text conditioning and classifier-free
    dropout, lowres noise-level conditioning, ``ignore_time`` image mode
    and per-resnet-block skips.

The JAX module leaves everything here to XLA (no Pallas kernel), so the
port computes it with PyTorch calls in the compute dtype, parameters fp32
and cast per call: frame-wise convs as ``F.conv2d`` over ``B * F`` frames,
the causal temporal conv as one matrix product over the concatenated taps,
dense layers and 1x1 convs as matrix products, attention as einsums with
fp32 scores. Norms follow the JAX ones: :class:`TokenLayerNorm` (scale
only, eps 1e-5, biased variance in fp32), flax ``LayerNorm`` and
``GroupNorm`` (eps 1e-6). No hand-written kernel runs on this path.

Fresh parameters draw the JAX initialisers (``models/blocks.py``:
``lecun_normal`` kernels, zero biases, unit norm scales), with the JAX
special cases: ``null_kv``, ``null_attn_bias``, ``null_text_embed``,
``null_text_hidden``, the Perceiver's ``latents`` and ``pos_emb`` and the
learned sinusoidal weights normal(1); the ``init_zero`` out gates and the
final conv zeros; the temporal conv the identity at its last tap; the
(temporal) pixel-shuffle convs ICNR over ``kaiming_uniform``.
``utils/convert.py::video_state_dict_from_jax_params`` carries a flax
parameter tree over.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffusioniqt_tpu_torch.models.attention import LayerNorm
from diffusioniqt_tpu_torch.models.blocks import (
    ChanLayerNorm,
    Dense,
    GlobalContext,
    LearnedSinusoidalPosEmb,
    LecunInit,
)
from diffusioniqt_tpu_torch.models.unet2d import GroupNorm
from diffusioniqt_tpu_torch.ops.volume import resize
from diffusioniqt_tpu_torch.parallel.sharding import ColumnParallel
from diffusioniqt_tpu_torch.utils.misc import cast_tuple

# the JAX module's masked score (unet_video.py:39)
NEG_INF = -0.7 * torch.finfo(torch.float32).max


class TokenLayerNorm(ChanLayerNorm):
    """Scale-only LayerNorm over the last axis, eps 1e-5 (the JAX
    ``TokenLayerNorm``); ``stable`` first divides by the detached max."""

    def __init__(self, dim: int, stable: bool = False):
        super().__init__(dim)
        self.stable = stable

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.stable:
            return super().forward(x)
        x32 = x.float()
        x32 = x32 / x32.amax(dim=-1, keepdim=True).detach()
        var, mean = torch.var_mean(x32, dim=-1, unbiased=False, keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + self.eps) * self.g).to(x.dtype)


class SpatialConv(ColumnParallel, LecunInit, nn.Conv3d):
    """Frame-wise k x k conv, weight ``(out, in, 1, k, k)`` (flax ``nn.Conv``
    of kernel ``(1, k, k)``), zero-padded by ``padding`` on H and W: one
    ``F.conv2d`` over the ``B * F`` frames, or a matrix product at k = 1.
    ``init_zero`` starts weight and bias at zero (the final conv).
    Column-parallel under a model axis."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 1, padding: int = 0,
                 init_zero: bool = False):
        super().__init__(dim_in, dim_out, (1, kernel_size, kernel_size))
        self.pad = padding
        if init_zero:
            nn.init.zeros_(self.weight)
            nn.init.zeros_(self.bias)

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        w = self.weight.to(x.dtype)
        bias = None if bias is None else bias.to(x.dtype)
        if self.kernel_size[-1] == 1 and self.pad == 0:
            return F.linear(x, w.reshape(w.shape[0], self.in_channels), bias)
        lead, (h, wd, c) = x.shape[:-3], x.shape[-3:]
        y = F.conv2d(x.reshape(-1, h, wd, c).permute(0, 3, 1, 2), w[:, :, 0], bias,
                     padding=self.pad)
        return y.permute(0, 2, 3, 1).reshape(*lead, y.shape[2], y.shape[3], -1)


class TemporalConv(ColumnParallel, nn.Conv3d):
    """Causal conv over the frame axis, weight ``(out, in, tk, 1, 1)``: the
    input left-padded with ``tk - 1`` zero frames, so output frame t reads
    frames t - tk + 1 .. t; one matrix product over the concatenated taps.
    Starts as the identity (tap ``tk - 1`` the unit matrix, the rest and
    the bias zero; JAX ``_identity_temporal_init``), on the whole weight,
    before a model axis cuts it into column shards."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3):
        super().__init__(dim_in, dim_out, (kernel_size, 1, 1))

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.weight.zero_()
            self.weight[:, :, -1, 0, 0] = torch.eye(self.out_channels, self.in_channels)
            self.bias.zero_()

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        tk, frames = self.kernel_size[0], x.shape[1]
        xp = F.pad(x, (0, 0, 0, 0, 0, 0, tk - 1, 0))
        taps = torch.cat([xp[:, j:j + frames] for j in range(tk)], dim=-1)
        w = self.weight[:, :, :, 0, 0].permute(0, 2, 1).reshape(self.weight.shape[0], -1)
        return F.linear(taps, w.to(x.dtype), None if bias is None else bias.to(x.dtype))


class PseudoConv3d(nn.Module):
    """Frame-wise k x k SAME conv (``spatial``), then the causal temporal
    conv (``temporal``), skipped with ``ignore_time`` (JAX
    ``PseudoConv3d``)."""

    def __init__(self, dim_in: int, dim_out: int, kernel_size: int = 3,
                 temporal_kernel_size: Optional[int] = None):
        super().__init__()
        self.spatial = SpatialConv(dim_in, dim_out, kernel_size, kernel_size // 2)
        self.temporal = (TemporalConv(dim_out, dim_out, temporal_kernel_size or kernel_size)
                         if kernel_size > 1 else None)

    def forward(self, x: torch.Tensor, ignore_time: bool = False) -> torch.Tensor:
        x = self.spatial(x)
        if ignore_time or self.temporal is None:
            return x
        return self.temporal(x)


class DynamicPositionBias(nn.Module):
    """Continuous relative position bias: an MLP from the offset
    ``i - j`` in ``[-n + 1, n - 1]`` to one bias per head, ``(heads, n, n)``
    (JAX ``DynamicPositionBias``); ``mlp.{3k}`` Dense, ``mlp.{3k+1}``
    TokenLayerNorm."""

    def __init__(self, dim: int, heads: int, depth: int = 2):
        super().__init__()
        layers = [Dense(1, dim), TokenLayerNorm(dim), nn.SiLU()]
        for _ in range(max(depth - 1, 0)):
            layers += [Dense(dim, dim), TokenLayerNorm(dim), nn.SiLU()]
        self.mlp = nn.Sequential(*layers, Dense(dim, heads))

    def forward(self, n: int, device, dtype) -> torch.Tensor:
        pos = torch.arange(-n + 1, n, device=device, dtype=torch.float32)[:, None]
        bias = self.mlp(pos.to(dtype))                               # (2n - 1, heads)
        idx = torch.arange(n, device=device)
        return bias[idx[:, None] - idx[None, :] + n - 1].permute(2, 0, 1)


def _l2norm(t: torch.Tensor) -> torch.Tensor:
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, N, h * d) -> (B, h, N, d)."""
    b, n, _ = t.shape
    return t.reshape(b, n, heads, -1).permute(0, 2, 1, 3)


def _attend(q, k, v, sim_scale: float, bias=None, causal: bool = False, key_mask=None):
    """Scores in fp32 from ``q`` ``(B, h, Nq, d)`` and ``k`` (``(B, Nk, d)``
    shared by the heads or ``(B, h, Nk, d)``), plus ``bias``, causal and key
    masks set to :data:`NEG_INF`, fp32 softmax cast to ``v``'s dtype, then
    the product with ``v``."""
    eq = "bhid,bjd->bhij" if k.dim() == 3 else "bhid,bhjd->bhij"
    sim = torch.einsum(eq, q.float(), k.float()) * sim_scale
    if bias is not None:
        sim = sim + bias.float()
    if causal:
        i, j = sim.shape[-2:]
        mask = torch.ones(i, j, dtype=torch.bool, device=sim.device).triu(j - i + 1)
        sim = sim.masked_fill(mask, NEG_INF)
    if key_mask is not None:
        sim = torch.where(key_mask[:, None, None, :], sim, torch.full_like(sim, NEG_INF))
    attn = torch.softmax(sim, dim=-1).to(v.dtype)
    eq = "bhij,bjd->bhid" if v.dim() == 3 else "bhij,bhjd->bhid"
    return torch.einsum(eq, attn, v)


def _merge(out: torch.Tensor) -> torch.Tensor:
    """(B, h, N, d) -> (B, N, h * d)."""
    b, h, n, d = out.shape
    return out.permute(0, 2, 1, 3).reshape(b, n, h * d)


class VideoAttention(nn.Module):
    """Token attention with one shared-head key / value and a learned null
    key / value (JAX ``VideoAttention``): keys are ``[context, null,
    tokens]``. ``rel_pos_bias`` adds :class:`DynamicPositionBias` over the
    tokens and ``null_attn_bias`` over the prefix columns; ``init_zero``
    ends in a TokenLayerNorm times a zero-initialised gate."""

    # not a layer's weight: whole on every rank of a model group
    replicated_params = ("null_kv",)

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, causal: bool = False,
                 context_dim: Optional[int] = None, cosine_sim_attn: bool = False,
                 rel_pos_bias: bool = False, rel_pos_bias_mlp_depth: int = 2,
                 init_zero: bool = False):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.causal = heads, dim_head, causal
        self.cosine_sim_attn = cosine_sim_attn
        self.norm = TokenLayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, dim_head * 2, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_context = (nn.Sequential(LayerNorm(context_dim), Dense(context_dim, dim_head * 2))
                           if context_dim is not None else None)
        self.rel_pos_bias = (DynamicPositionBias(dim, heads, rel_pos_bias_mlp_depth)
                             if rel_pos_bias else None)
        self.null_attn_bias = nn.Parameter(torch.randn(heads)) if rel_pos_bias else None
        self.to_out = Dense(inner, dim, bias=False)
        self.out_norm = TokenLayerNorm(dim)
        self.out_gate = nn.Parameter(torch.zeros(1)) if init_zero else None

    def forward(self, x: torch.Tensor, context=None, mask=None) -> torch.Tensor:
        b, n, _ = x.shape
        x = self.norm(x)
        scale = 1.0 if self.cosine_sim_attn else self.dim_head ** -0.5
        q = _heads(self.to_q(x), self.heads) * scale
        k, v = self.to_kv(x).chunk(2, dim=-1)
        null = self.null_kv.to(x.dtype)[:, None, None, :].expand(2, b, 1, self.dim_head)
        k, v = torch.cat([null[0], k], dim=1), torch.cat([null[1], v], dim=1)
        if context is not None:
            if self.to_context is None:
                raise ValueError("a context needs the module built with context_dim")
            ck, cv = self.to_context[1](self.to_context[0](context).to(x.dtype)).chunk(2, -1)
            k, v = torch.cat([ck, k], dim=1), torch.cat([cv, v], dim=1)
        if self.cosine_sim_attn:
            q, k = _l2norm(q), _l2norm(k)
        bias = None
        if self.rel_pos_bias is not None:
            prefix = k.shape[1] - n
            null_col = self.null_attn_bias.float()[:, None, None].expand(self.heads, n, prefix)
            bias = torch.cat([null_col, self.rel_pos_bias(n, x.device, x.dtype).float()], -1)
        key_mask = None
        if mask is not None:
            key_mask = F.pad(mask.bool(), (k.shape[1] - mask.shape[-1], 0), value=True)
        out = _attend(q, k, v, 16.0 if self.cosine_sim_attn else 1.0, bias=bias,
                      causal=self.causal, key_mask=key_mask)
        out = self.out_norm(self.to_out(_merge(out)))
        if self.out_gate is not None:
            out = out * self.out_gate.to(out.dtype)
        return out


class TemporalAttention(nn.Module):
    """Causal attention over the frames of each spatial position, with the
    relative position bias and a zero-initialised gate, plus the input."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8, causal: bool = True,
                 cosine_sim_attn: bool = False):
        super().__init__()
        self.attn = VideoAttention(dim, dim_head, heads, causal=causal,
                                   cosine_sim_attn=cosine_sim_attn, rel_pos_bias=True,
                                   init_zero=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        tokens = x.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, c)
        out = self.attn(tokens).reshape(b, hh, ww, f, c).permute(0, 3, 1, 2, 4)
        return out + x


class TemporalPEG(ColumnParallel, LecunInit, nn.Conv3d):
    """Depthwise 3-tap conv over the frames (causal: two zero frames on the
    left; else one each side), plus the input; weight ``(dim, 1, 3, 1, 1)``.
    A column shard of the depthwise weight reads only its rank's input
    channels; the residual adds the whole input after the gather."""

    def __init__(self, dim: int, causal: bool = True):
        super().__init__(dim, dim, (3, 1, 1), groups=dim)
        self.causal = causal

    def local(self, x: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
        n = self.weight.shape[0]
        if self.tp is not None:
            x = x[..., self.tp.rank * n:(self.tp.rank + 1) * n]
        frames = x.shape[1]
        xp = F.pad(x, (0, 0, 0, 0, 0, 0) + ((2, 0) if self.causal else (1, 1)))
        w = self.weight[:, 0, :, 0, 0].to(x.dtype)          # (dim, 3)
        return bias.to(x.dtype) + sum(xp[:, j:j + frames] * w[:, j] for j in range(3))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x) + x


class _ICNRConv(SpatialConv):
    """1x1 conv to ``dim_out * r`` channels whose ``r`` consecutive output
    channels start equal (ICNR over flax's ``kaiming_uniform``), zero bias."""

    def __init__(self, dim_in: int, dim_out: int, r: int):
        super().__init__(dim_in, dim_out * r)
        base = torch.empty(dim_out, dim_in, 1, 1, 1)
        nn.init.kaiming_uniform_(base)  # U(+-sqrt(6 / fan_in)), flax's kaiming_uniform
        with torch.no_grad():
            self.weight.copy_(base.repeat_interleave(r, dim=0))


class SpatialDownsample(nn.Module):
    """Pixel-unshuffle by 2 on H and W (channel ``c`` of sub-position
    (dy, dx) to ``4 c + 2 dy + dx``, the JAX order) and a 1x1 conv."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = SpatialConv(dim_in * 4, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        x = x.reshape(b, f, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 2, 4, 6, 3, 5)
        return self.conv(x.reshape(b, f, hh // 2, ww // 2, c * 4))


class SpatialPixelShuffleUpsample(nn.Module):
    """1x1 ICNR conv to 4x the channels, SiLU, pixel shuffle by 2 on H and
    W (channel ``4 c + 2 i + j`` to sub-position (i, j) of ``c``)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = _ICNRConv(dim_in, dim_out, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, _ = x.shape
        x = F.silu(self.conv(x)).reshape(b, f, hh, ww, -1, 2, 2)
        return x.permute(0, 1, 2, 5, 3, 6, 4).reshape(b, f, hh * 2, ww * 2, -1)


class TemporalDownsample(nn.Module):
    """Frame unshuffle by ``stride`` (channel ``c`` of frame offset s to
    ``c * stride + s``) and a 1x1 conv."""

    def __init__(self, dim_in: int, dim_out: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = SpatialConv(dim_in * stride, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        s = self.stride
        x = x.reshape(b, f // s, s, hh, ww, c).permute(0, 1, 3, 4, 5, 2)
        return self.conv(x.reshape(b, f // s, hh, ww, c * s))


class TemporalPixelShuffleUpsample(nn.Module):
    """1x1 ICNR conv to ``stride`` x the channels, SiLU, frame shuffle
    (channel ``c * stride + s`` to frame offset s of ``c``)."""

    def __init__(self, dim_in: int, dim_out: int, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.conv = _ICNRConv(dim_in, dim_out, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, _ = x.shape
        s = self.stride
        x = F.silu(self.conv(x)).reshape(b, f, hh, ww, -1, s).permute(0, 1, 5, 2, 3, 4)
        return x.reshape(b, f * s, hh, ww, -1)


class VideoBlock(nn.Module):
    """flax GroupNorm (eps 1e-6) -> optional (scale + 1, shift) -> SiLU ->
    PseudoConv3d."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8):
        super().__init__()
        self.groupnorm = GroupNorm(groups, dim_in)
        self.project = PseudoConv3d(dim_in, dim_out, 3)

    def forward(self, x, scale_shift=None, ignore_time: bool = False):
        x = self.groupnorm(x)
        if scale_shift is not None:
            scale, shift = scale_shift
            x = x * (scale + 1) + shift
        return self.project(F.silu(x), ignore_time=ignore_time)


class VideoCrossAttention(nn.Module):
    """Cross-attention of tokens to conditioning tokens with a per-head
    null key / value (JAX ``VideoCrossAttention``); ``linear`` is the
    linear-attention variant (softmax of q over d, of k over the keys)."""

    replicated_params = ("null_kv",)

    def __init__(self, dim: int, context_dim: int, dim_head: int = 64, heads: int = 8,
                 linear: bool = False, cosine_sim_attn: bool = False):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.linear = heads, dim_head, linear
        self.cosine_sim_attn = cosine_sim_attn
        self.norm = TokenLayerNorm(dim)
        self.norm_context = TokenLayerNorm(context_dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(context_dim, inner * 2, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = Dense(inner, dim, bias=False)
        self.out_norm = TokenLayerNorm(dim)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h = x.shape[0], self.heads
        x, context = self.norm(x), self.norm_context(context.to(x.dtype))
        q = _heads(self.to_q(x), h)
        k, v = (_heads(t, h) for t in self.to_kv(context).chunk(2, dim=-1))
        null = self.null_kv.to(x.dtype)[:, None, None, None, :].expand(2, b, h, 1, self.dim_head)
        k, v = torch.cat([null[0], k], dim=-2), torch.cat([null[1], v], dim=-2)
        if self.linear:
            q = torch.softmax(q * self.dim_head ** -0.5, dim=-1)
            k = torch.softmax(k, dim=-2)
            out = torch.einsum("bhnd,bhde->bhne", q, torch.einsum("bhnd,bhne->bhde", k, v))
        else:
            q = q * (1.0 if self.cosine_sim_attn else self.dim_head ** -0.5)
            if self.cosine_sim_attn:
                q, k = _l2norm(q), _l2norm(k)
            out = _attend(q, k, v, 16.0 if self.cosine_sim_attn else 1.0)
        return self.out_norm(self.to_out(_merge(out)))


class VideoResnetBlock(nn.Module):
    """VideoBlock, optional cross-attention of the block's tokens to the
    conditioning tokens (plus residual), VideoBlock with the time
    scale-shift, optional global-context gate, and the input (through a
    1x1 conv where the width changes)."""

    def __init__(self, dim_in: int, dim_out: int, cond_dim: Optional[int] = None,
                 time_cond_dim: Optional[int] = None, groups: int = 8,
                 linear_attn: bool = False, use_gca: bool = False, attn_dim_head: int = 64,
                 attn_heads: int = 8):
        super().__init__()
        self.time_mlp = (nn.Sequential(nn.SiLU(), Dense(time_cond_dim, dim_out * 2))
                         if time_cond_dim is not None else None)
        self.block1 = VideoBlock(dim_in, dim_out, groups)
        self.cross_attn = (VideoCrossAttention(dim_out, cond_dim, attn_dim_head, attn_heads,
                                               linear=linear_attn)
                           if cond_dim is not None else None)
        self.block2 = VideoBlock(dim_out, dim_out, groups)
        self.gca = GlobalContext(dim_out, dim_out) if use_gca else None
        self.res_conv = SpatialConv(dim_in, dim_out) if dim_in != dim_out else None

    def forward(self, x, time_emb=None, cond=None, ignore_time: bool = False):
        scale_shift = None
        if self.time_mlp is not None and time_emb is not None:
            scale_shift = self.time_mlp(time_emb)[:, None, None, None, :].chunk(2, dim=-1)
        h = self.block1(x, ignore_time=ignore_time)
        if self.cross_attn is not None:
            if cond is None:
                raise ValueError("this block cross-attends: pass the conditioning tokens")
            b, f, hh, ww, c = h.shape
            tokens = h.reshape(b, f * hh * ww, c)
            h = (self.cross_attn(tokens, cond) + tokens).reshape(b, f, hh, ww, c)
        h = self.block2(h, scale_shift=scale_shift, ignore_time=ignore_time)
        if self.gca is not None:
            h = h * self.gca(h)
        return h + (x if self.res_conv is None else self.res_conv(x))


class VideoTransformerBlock(nn.Module):
    """``depth`` x (token attention over every position of every frame,
    plus residual; channel feed-forward ChanLayerNorm -> dense -> GELU
    (tanh) -> ChanLayerNorm -> dense, plus residual); ``linear`` uses
    linear self-attention (``layers.{d}.{0,1}``)."""

    def __init__(self, dim: int, depth: int = 1, heads: int = 8, dim_head: int = 64,
                 ff_mult: float = 2.0, context_dim: Optional[int] = None, linear: bool = False,
                 cosine_sim_attn: bool = False):
        super().__init__()
        hidden = int(dim * ff_mult)
        self.linear = linear
        self.layers = nn.ModuleList()
        for _ in range(depth):
            attn = (VideoCrossAttention(dim, dim, dim_head, heads, linear=True) if linear
                    else VideoAttention(dim, dim_head, heads, context_dim=context_dim,
                                        cosine_sim_attn=cosine_sim_attn))
            ff = nn.Sequential(ChanLayerNorm(dim), Dense(dim, hidden, bias=False),
                               nn.GELU(approximate="tanh"), ChanLayerNorm(hidden),
                               Dense(hidden, dim, bias=False))
            self.layers.append(nn.ModuleList([attn, ff]))

    def forward(self, x: torch.Tensor, context=None) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        for attn, ff in self.layers:
            tokens = x.reshape(b, f * hh * ww, c)
            out = attn(tokens, tokens) if self.linear else attn(tokens, context=context)
            x = (out + tokens).reshape(b, f, hh, ww, c)
            x = ff(x) + x
        return x


class PerceiverAttention(nn.Module):
    """Latents attend to ``[tokens, latents]`` (flax LayerNorms on both,
    the key mask padded with the latents' columns)."""

    def __init__(self, dim: int, dim_head: int = 64, heads: int = 8,
                 cosine_sim_attn: bool = False):
        super().__init__()
        inner = dim_head * heads
        self.heads, self.dim_head, self.cosine_sim_attn = heads, dim_head, cosine_sim_attn
        self.norm = LayerNorm(dim)
        self.norm_latents = LayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, inner * 2, bias=False)
        self.to_out = Dense(inner, dim, bias=False)
        self.out_norm = LayerNorm(dim)

    def forward(self, x, latents, mask=None):
        h = self.heads
        x, latents = self.norm(x), self.norm_latents(latents)
        q = _heads(self.to_q(latents), h)
        k, v = (_heads(t, h) for t in self.to_kv(torch.cat([x, latents], dim=-2)).chunk(2, -1))
        q = q * (1.0 if self.cosine_sim_attn else self.dim_head ** -0.5)
        if self.cosine_sim_attn:
            q, k = _l2norm(q), _l2norm(k)
        key_mask = None
        if mask is not None:
            key_mask = F.pad(mask.bool(), (0, latents.shape[-2]), value=True)
        out = _attend(q, k, v, 16.0 if self.cosine_sim_attn else 1.0, key_mask=key_mask)
        return self.out_norm(self.to_out(_merge(out)))


class PerceiverResampler(nn.Module):
    """Pools text tokens into ``num_latents`` learned latents, plus
    ``num_latents_mean_pooled`` latents made from the tokens' mean, through
    ``depth`` x (PerceiverAttention + feed-forward), each with a residual."""

    # learned tokens, not a layer's weight: whole on every rank of a model
    # group (the JAX rule shards them from 4096 elements)
    replicated_params = ("pos_emb", "latents")

    def __init__(self, dim: int, depth: int = 2, dim_head: int = 64, heads: int = 8,
                 num_latents: int = 32, num_latents_mean_pooled: int = 4,
                 max_seq_len: int = 512, ff_mult: float = 4.0, cosine_sim_attn: bool = False):
        super().__init__()
        hidden = int(dim * ff_mult)
        self.pos_emb = nn.Parameter(torch.randn(max_seq_len, dim))
        self.latents = nn.Parameter(torch.randn(num_latents, dim))
        self.num_latents_mean_pooled = num_latents_mean_pooled
        self.to_latents_from_mean_pooled = (
            nn.Sequential(TokenLayerNorm(dim), Dense(dim, dim * num_latents_mean_pooled))
            if num_latents_mean_pooled > 0 else None)
        self.layers = nn.ModuleList(
            nn.ModuleList([PerceiverAttention(dim, dim_head, heads, cosine_sim_attn),
                           nn.Sequential(TokenLayerNorm(dim), Dense(dim, hidden, bias=False),
                                         nn.GELU(approximate="tanh"),
                                         Dense(hidden, dim, bias=False))])
            for _ in range(depth))

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        b, n, d = x.shape
        x_pos = x + self.pos_emb[:n].to(x.dtype)
        latents = self.latents.to(x.dtype)[None].expand(b, -1, -1)
        if self.to_latents_from_mean_pooled is not None:
            pooled = self.to_latents_from_mean_pooled(x.mean(dim=1))
            latents = torch.cat([pooled.reshape(b, self.num_latents_mean_pooled, d), latents], 1)
        for attn, ff in self.layers:
            latents = attn(x_pos, latents, mask=mask) + latents
            latents = ff(latents) + latents
        return latents


class Unet3DVideo(nn.Module):
    """The video U-Net with every field of the JAX ``Unet3DVideo``
    (unet_video.py:659-704); ``dtype`` is the compute dtype (parameters
    stay fp32). ``pixel_shuffle_upsample`` is kept for the signature: the
    JAX module upsamples by pixel shuffle either way (:1022-1024,
    1088-1091). The temporal layers exist whatever ``ignore_time`` a call
    takes; ``out_dim`` is unused, as in the JAX module. Modules carry the JAX module names where the JAX module
    names them (``down{i}_init``, ``down{i}_block{j}``, ``down{i}_attn``,
    ``down{i}_peg``, ``down{i}_tattn``, ``down{i}_tdown``, ``down{i}_pre``,
    ``down{i}_post``, ``down{i}_post_a`` / ``_b``, ``mid_block1``,
    ``mid_attn``, ``mid_peg``, ``mid_tattn``, ``mid_block2``,
    ``up{i}_tup``, ``up{i}_init``, ``up{i}_block{j}``, ``up{i}_attn``,
    ``up{i}_peg``, ``up{i}_tattn``, ``up{i}_upsample``,
    ``init_resnet_block``, ``final_res_block``, ``final_conv``) and the
    reference ``imagen_video`` names elsewhere (``init_conv.{i}``,
    ``init_temporal_peg``, ``init_temporal_attn``, ``to_time_hiddens``,
    ``to_time_tokens``, ``to_time_cond``, their ``to_lowres_*``
    counterparts, ``text_to_cond``, ``null_text_embed``, ``attn_pool``,
    ``to_text_non_attn_cond``, ``null_text_hidden``, ``norm_cond``).

    Under a ``model`` mesh axis every conv and dense layer is
    column-parallel (``parallel/sharding.py``); the learned null text
    embeddings, like the Perceiver's tokens and the attention's null key /
    value, stay whole on every rank (``replicated_params``)."""

    replicated_params = ("null_text_embed", "null_text_hidden")

    def __init__(
        self,
        dim: int,
        text_embed_dim: int = 768,
        num_resnet_blocks: Union[int, Tuple[int, ...]] = 1,
        cond_dim: Optional[int] = None,
        num_time_tokens: int = 2,
        learned_sinu_pos_emb_dim: int = 16,
        out_dim: Optional[int] = None,
        dim_mults: Tuple[int, ...] = (1, 2, 4, 8),
        temporal_strides: Union[int, Tuple[int, ...]] = 1,
        cond_images_channels: int = 0,
        channels: int = 3,
        channels_out: Optional[int] = None,
        attn_dim_head: int = 64,
        attn_heads: int = 8,
        ff_mult: float = 2.0,
        lowres_cond: bool = False,
        layer_attns: Union[bool, Tuple[bool, ...]] = False,
        layer_attns_depth: Union[int, Tuple[int, ...]] = 1,
        attend_at_middle: bool = True,
        time_rel_pos_bias_depth: int = 2,
        time_causal_attn: bool = True,
        layer_cross_attns: Union[bool, Tuple[bool, ...]] = True,
        use_linear_attn: bool = False,
        use_linear_cross_attn: bool = False,
        cond_on_text: bool = True,
        max_text_len: int = 256,
        init_dim: Optional[int] = None,
        resnet_groups: Union[int, Tuple[int, ...]] = 8,
        init_conv_kernel_size: int = 7,
        init_cross_embed: bool = True,
        init_cross_embed_kernel_sizes: Tuple[int, ...] = (3, 7, 15),
        attn_pool_text: bool = True,
        attn_pool_num_latents: int = 32,
        memory_efficient: bool = False,
        init_conv_to_final_conv_residual: bool = False,
        use_global_context_attn: bool = True,
        scale_skip_connection: bool = True,
        final_resnet_block: bool = True,
        final_conv_kernel_size: int = 3,
        cosine_sim_attn: bool = False,
        self_cond: bool = False,
        pixel_shuffle_upsample: bool = True,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.config = {k: v for k, v in locals().items() if k not in ("self", "__class__")}
        num_layers = len(dim_mults)
        self.num_layers = num_layers
        self.num_blocks = num_blocks = cast_tuple(num_resnet_blocks, num_layers)
        groups = cast_tuple(resnet_groups, num_layers)
        self.layer_attns = layer_attns = cast_tuple(layer_attns, num_layers)
        attn_depths = cast_tuple(layer_attns_depth, num_layers)
        layer_cross = cast_tuple(layer_cross_attns, num_layers)
        self.temporal_strides = strides = cast_tuple(temporal_strides, num_layers)
        init_dim = init_dim or dim
        self.channels, self.channels_out = channels, channels_out or channels
        self.lowres_cond, self.self_cond = lowres_cond, self_cond
        self.cond_images_channels = cond_images_channels
        self.cond_on_text, self.max_text_len = cond_on_text, max_text_len
        self.text_embed_dim = text_embed_dim
        self.memory_efficient, self.use_linear_attn = memory_efficient, use_linear_attn
        self.init_conv_to_final_conv_residual = init_conv_to_final_conv_residual
        self.skip_scale = 2 ** -0.5 if scale_skip_connection else 1.0
        self.num_time_tokens = num_time_tokens
        self.dtype = dtype
        cond_dim = cond_dim or dim
        self.cond_dim = cond_dim
        time_cond_dim = dim * 4 * (2 if lowres_cond else 1)
        attn_kw = dict(dim_head=attn_dim_head, heads=attn_heads, cosine_sim_attn=cosine_sim_attn)
        temporal_kw = dict(causal=time_causal_attn, **attn_kw)
        res_kw = dict(time_cond_dim=time_cond_dim, attn_dim_head=attn_dim_head,
                      attn_heads=attn_heads)

        in_ch = channels * (1 + int(self_cond) + int(lowres_cond)) + cond_images_channels
        if init_cross_embed:
            kernels = sorted(init_cross_embed_kernel_sizes)
            scales = [int(init_dim / (2 ** i)) for i in range(1, len(kernels))]
            scales = [*scales, init_dim - sum(scales)]
            self.init_conv = nn.ModuleList(SpatialConv(in_ch, d, k, k // 2)
                                           for k, d in zip(kernels, scales))
        else:
            k = init_conv_kernel_size
            self.init_conv = nn.ModuleList([SpatialConv(in_ch, init_dim, k, k // 2)])
        self.init_temporal_peg = TemporalPEG(init_dim, causal=time_causal_attn)
        self.init_temporal_attn = TemporalAttention(init_dim, **temporal_kw)

        sinu = learned_sinu_pos_emb_dim
        self.to_time_hiddens = nn.Sequential(LearnedSinusoidalPosEmb(sinu),
                                             Dense(sinu + 1, time_cond_dim))
        self.to_time_tokens = Dense(time_cond_dim, cond_dim * num_time_tokens)
        self.to_time_cond = Dense(time_cond_dim, time_cond_dim)
        if lowres_cond:
            self.to_lowres_time_hiddens = nn.Sequential(LearnedSinusoidalPosEmb(sinu),
                                                        Dense(sinu + 1, time_cond_dim))
            self.to_lowres_time_tokens = Dense(time_cond_dim, cond_dim * num_time_tokens)
            self.to_lowres_time_cond = Dense(time_cond_dim, time_cond_dim)
        if cond_on_text:
            self.text_to_cond = Dense(text_embed_dim, cond_dim)
            self.null_text_embed = nn.Parameter(torch.randn(1, max_text_len, cond_dim))
            self.attn_pool = (PerceiverResampler(cond_dim, 2, attn_dim_head, attn_heads,
                                                 num_latents=attn_pool_num_latents,
                                                 cosine_sim_attn=cosine_sim_attn)
                              if attn_pool_text else None)
            self.to_text_non_attn_cond = nn.Sequential(
                LayerNorm(cond_dim), Dense(cond_dim, time_cond_dim), nn.SiLU(),
                Dense(time_cond_dim, time_cond_dim))
            self.null_text_hidden = nn.Parameter(torch.randn(1, time_cond_dim))
        self.norm_cond = LayerNorm(cond_dim)

        dims = [init_dim, *(dim * m for m in dim_mults)]
        in_out = list(zip(dims[:-1], dims[1:]))
        mid_dim = dims[-1]
        if memory_efficient:
            self.init_resnet_block = VideoResnetBlock(
                init_dim, init_dim, groups=groups[0], use_gca=use_global_context_attn, **res_kw)

        def cross(on):  # (cond_dim or None, linear)
            linear = not on and use_linear_cross_attn
            return (cond_dim if on or linear else None), linear

        x_ch = init_dim
        skips = []
        for ind, (dim_in, dim_out) in enumerate(in_out):
            is_last = ind == num_layers - 1
            cur = dim_in
            if memory_efficient:
                self.add_module(f"down{ind}_pre", SpatialDownsample(x_ch, dim_out))
                cur = x_ch = dim_out
            cdim, lin = cross(layer_cross[ind])
            self.add_module(f"down{ind}_init", VideoResnetBlock(
                x_ch, cur, cond_dim=cdim, groups=groups[ind], linear_attn=lin, **res_kw))
            for bi in range(num_blocks[ind]):
                self.add_module(f"down{ind}_block{bi}", VideoResnetBlock(
                    cur, cur, groups=groups[ind], use_gca=use_global_context_attn, **res_kw))
                skips.append(cur)
            if layer_attns[ind]:
                self.add_module(f"down{ind}_attn", VideoTransformerBlock(
                    cur, attn_depths[ind], attn_heads, attn_dim_head, ff_mult,
                    context_dim=cond_dim, cosine_sim_attn=cosine_sim_attn))
            elif use_linear_attn:
                self.add_module(f"down{ind}_attn", VideoTransformerBlock(
                    cur, attn_depths[ind], attn_heads, attn_dim_head, ff_mult, linear=True))
            self.add_module(f"down{ind}_peg", TemporalPEG(cur, causal=time_causal_attn))
            self.add_module(f"down{ind}_tattn", TemporalAttention(cur, **temporal_kw))
            skips.append(cur)
            if strides[ind] > 1:
                self.add_module(f"down{ind}_tdown", TemporalDownsample(cur, cur, strides[ind]))
            x_ch = cur
            if not memory_efficient:
                if not is_last:
                    self.add_module(f"down{ind}_post", SpatialDownsample(cur, dim_out))
                else:
                    self.add_module(f"down{ind}_post_a", SpatialConv(cur, dim_out, 3, 1))
                    self.add_module(f"down{ind}_post_b", SpatialConv(cur, dim_out, 1))
                x_ch = dim_out

        self.mid_block1 = VideoResnetBlock(mid_dim, mid_dim, cond_dim=cond_dim,
                                           groups=groups[-1], **res_kw)
        self.mid_attn = VideoAttention(mid_dim, **attn_kw) if attend_at_middle else None
        self.mid_peg = TemporalPEG(mid_dim, causal=time_causal_attn)
        self.mid_tattn = TemporalAttention(mid_dim, **temporal_kw)
        self.mid_block2 = VideoResnetBlock(mid_dim, mid_dim, cond_dim=cond_dim,
                                           groups=groups[-1], **res_kw)

        x_ch = mid_dim
        rev = list(reversed(range(num_layers)))
        for ind, lvl in enumerate(rev):
            dim_in, dim_out = in_out[lvl]
            is_last = ind == num_layers - 1
            cdim, lin = cross(layer_cross[lvl])
            if strides[lvl] > 1:
                self.add_module(f"up{ind}_tup",
                                TemporalPixelShuffleUpsample(x_ch, dim_out, strides[lvl]))
                x_ch = dim_out
            self.add_module(f"up{ind}_init", VideoResnetBlock(
                x_ch + skips.pop(), dim_out, cond_dim=cdim, groups=groups[lvl], linear_attn=lin,
                **res_kw))
            for bi in range(num_blocks[lvl]):
                self.add_module(f"up{ind}_block{bi}", VideoResnetBlock(
                    dim_out + skips.pop(), dim_out, groups=groups[lvl],
                    use_gca=use_global_context_attn, **res_kw))
            x_ch = dim_out
            if layer_attns[lvl]:
                self.add_module(f"up{ind}_attn", VideoTransformerBlock(
                    dim_out, attn_depths[lvl], attn_heads, attn_dim_head, ff_mult,
                    context_dim=cond_dim, cosine_sim_attn=cosine_sim_attn))
            self.add_module(f"up{ind}_peg", TemporalPEG(dim_out, causal=time_causal_attn))
            self.add_module(f"up{ind}_tattn", TemporalAttention(dim_out, **temporal_kw))
            if not is_last or memory_efficient:
                self.add_module(f"up{ind}_upsample", SpatialPixelShuffleUpsample(dim_out, dim_in))
                x_ch = dim_in

        if init_conv_to_final_conv_residual:
            x_ch += init_dim
        self.final_res_block = (VideoResnetBlock(x_ch, dim, groups=groups[0], use_gca=True,
                                                 **res_kw)
                                if final_resnet_block else None)
        x_ch = dim if final_resnet_block else x_ch
        if lowres_cond:
            x_ch += channels
        k = final_conv_kernel_size
        self.final_conv = SpatialConv(x_ch, self.channels_out, k, k // 2, init_zero=True)

    # -- the JAX module's helpers -------------------------------------------
    def cast_model_parameters(self, *, lowres_cond: bool, channels: int,
                              channels_out: Optional[int], text_embed_dim=None,
                              cond_on_text=None, **_ignored) -> "Unet3DVideo":
        """This module where the cascade's settings match it, else a fresh
        one with them (its parameters drawn anew, on this one's device)."""
        changes = dict(lowres_cond=lowres_cond, channels=channels, channels_out=channels_out)
        if text_embed_dim is not None:
            changes["text_embed_dim"] = text_embed_dim
        if cond_on_text is not None:
            changes["cond_on_text"] = cond_on_text
        current = dict(self.config, channels_out=self.channels_out)
        wanted = dict(changes, channels_out=channels_out or channels)
        if all(current[k] == v for k, v in wanted.items()):
            return self
        device = next(self.parameters()).device
        return Unet3DVideo(**{**self.config, **changes}).to(device)

    @property
    def total_temporal_divisor(self) -> int:
        out = 1
        for s in self.temporal_strides:
            out *= s
        return out

    def _text_conditioning(self, text_embeds, text_mask, cond_drop_prob, generator, t):
        """The text tokens (pooled by the Perceiver) and ``t`` plus the
        text hiddens, with rows dropped to the null embeddings where the
        keep mask is off (JAX unet_video.py:834-888)."""
        dt, b = self.dtype, text_embeds.shape[0]
        device = text_embeds.device
        if cond_drop_prob == 0.0 or cond_drop_prob == 1.0:
            keep = torch.full((b,), cond_drop_prob == 0.0, dtype=torch.bool, device=device)
        else:
            if generator is None:
                raise ValueError("a cond_drop_prob between 0 and 1 needs a torch.Generator")
            keep = torch.rand(b, generator=generator, device=generator.device).to(device)
            keep = keep < 1 - cond_drop_prob
        tokens = self.text_to_cond(text_embeds.to(dt))[:, :self.max_text_len]
        remainder = self.max_text_len - tokens.shape[1]
        tokens = F.pad(tokens, (0, 0, 0, max(remainder, 0)))
        keep_embed = keep[:, None, None]
        if text_mask is not None:
            text_mask = text_mask.bool()[:, :self.max_text_len]
            text_mask = F.pad(text_mask, (0, max(remainder, 0)), value=False)
            keep_embed = text_mask[..., None] & keep_embed
        tokens = torch.where(keep_embed, tokens, self.null_text_embed.to(dt))
        if self.attn_pool is not None:
            tokens = self.attn_pool(tokens)
        hiddens = self.to_text_non_attn_cond(tokens.mean(dim=-2))
        hiddens = torch.where(keep[:, None], hiddens, self.null_text_hidden.to(dt))
        return tokens, t + hiddens

    def forward(
        self,
        x: torch.Tensor,                 # (B, F, H, W, C)
        time_steps: torch.Tensor,        # unused; the wrappers' signature
        time: torch.Tensor,              # (B,) log-SNR conditioning
        *,
        lowres_cond_img: Optional[torch.Tensor] = None,
        lowres_noise_times: Optional[torch.Tensor] = None,
        text_embeds: Optional[torch.Tensor] = None,
        text_mask: Optional[torch.Tensor] = None,
        cond_images: Optional[torch.Tensor] = None,
        self_cond: Optional[torch.Tensor] = None,
        cond_drop_prob: float = 0.0,
        ignore_time: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        del time_steps
        if x.dim() != 5:
            raise ValueError(f"video input must be (B, F, H, W, C), got {tuple(x.shape)}")
        b, frames = x.shape[:2]
        if not ignore_time and frames % self.total_temporal_divisor:
            raise ValueError(f"{frames} frames are not divisible by the temporal strides' "
                             f"product {self.total_temporal_divisor}")
        dt = self.dtype
        x = x.to(dt)
        # conditioning concat in the JAX module's order (unet_video.py:764-779)
        if self.self_cond:
            x = torch.cat([x, torch.zeros_like(x) if self_cond is None else self_cond.to(dt)],
                          dim=-1)
        if self.lowres_cond and (lowres_cond_img is None or lowres_noise_times is None):
            raise ValueError("a lowres-conditioned U-Net needs lowres_cond_img and "
                             "lowres_noise_times")
        if lowres_cond_img is not None:
            x = torch.cat([x, lowres_cond_img.to(dt)], dim=-1)
        if self.cond_images_channels > 0:
            if cond_images is None:
                raise ValueError("conditioning images not supplied")
            if cond_images.shape[2] != x.shape[2]:
                cond_images = resize(cond_images.float(),
                                     (*cond_images.shape[:2], *x.shape[2:4],
                                      cond_images.shape[-1]), "trilinear")
            x = torch.cat([cond_images.to(dt), x], dim=-1)

        x = torch.cat([conv(x) for conv in self.init_conv], dim=-1)
        if not ignore_time:
            x = self.init_temporal_attn(self.init_temporal_peg(x))
        init_conv_residual = x if self.init_conv_to_final_conv_residual else None

        th = F.silu(self.to_time_hiddens[1](self.to_time_hiddens[0](time).to(dt)))
        time_tokens = self.to_time_tokens(th).reshape(b, self.num_time_tokens, self.cond_dim)
        t = self.to_time_cond(th)
        if self.lowres_cond:
            lh = self.to_lowres_time_hiddens[0](lowres_noise_times).to(dt)
            lh = F.silu(self.to_lowres_time_hiddens[1](lh))
            lowres_tokens = self.to_lowres_time_tokens(lh).reshape(b, self.num_time_tokens,
                                                                   self.cond_dim)
            t = t + self.to_lowres_time_cond(lh)
            time_tokens = torch.cat([time_tokens, lowres_tokens], dim=-2)
        c = time_tokens
        if text_embeds is not None and self.cond_on_text:
            text_tokens, t = self._text_conditioning(text_embeds, text_mask, cond_drop_prob,
                                                     generator, t)
            c = torch.cat([time_tokens, text_tokens], dim=-2)
        c = self.norm_cond(c)

        if self.memory_efficient:
            x = self.init_resnet_block(x, t, ignore_time=ignore_time)

        hiddens = []
        for ind in range(self.num_layers):
            if self.memory_efficient:
                x = getattr(self, f"down{ind}_pre")(x)
            x = getattr(self, f"down{ind}_init")(x, t, cond=c, ignore_time=ignore_time)
            for bi in range(self.num_blocks[ind]):
                x = getattr(self, f"down{ind}_block{bi}")(x, t, ignore_time=ignore_time)
                hiddens.append(x)
            if self.layer_attns[ind]:
                x = getattr(self, f"down{ind}_attn")(x, context=c)
            elif self.use_linear_attn:
                x = getattr(self, f"down{ind}_attn")(x)
            if not ignore_time:
                x = getattr(self, f"down{ind}_tattn")(getattr(self, f"down{ind}_peg")(x))
            hiddens.append(x)
            if self.temporal_strides[ind] > 1 and not ignore_time:
                x = getattr(self, f"down{ind}_tdown")(x)
            if not self.memory_efficient:
                if ind < self.num_layers - 1:
                    x = getattr(self, f"down{ind}_post")(x)
                else:
                    x = (getattr(self, f"down{ind}_post_a")(x)
                         + getattr(self, f"down{ind}_post_b")(x))

        x = self.mid_block1(x, t, cond=c, ignore_time=ignore_time)
        if self.mid_attn is not None:
            bsz, f, hh, ww, cc = x.shape
            tokens = x.reshape(bsz, f * hh * ww, cc)
            x = (self.mid_attn(tokens) + tokens).reshape(bsz, f, hh, ww, cc)
        if not ignore_time:
            x = self.mid_tattn(self.mid_peg(x))
        x = self.mid_block2(x, t, cond=c, ignore_time=ignore_time)

        for ind in range(self.num_layers):
            lvl = self.num_layers - 1 - ind
            if self.temporal_strides[lvl] > 1 and not ignore_time:
                x = getattr(self, f"up{ind}_tup")(x)
            x = torch.cat([x, (hiddens.pop() * self.skip_scale).to(x.dtype)], dim=-1)
            x = getattr(self, f"up{ind}_init")(x, t, cond=c, ignore_time=ignore_time)
            for bi in range(self.num_blocks[lvl]):
                x = torch.cat([x, (hiddens.pop() * self.skip_scale).to(x.dtype)], dim=-1)
                x = getattr(self, f"up{ind}_block{bi}")(x, t, ignore_time=ignore_time)
            if self.layer_attns[lvl]:
                x = getattr(self, f"up{ind}_attn")(x, context=c)
            if not ignore_time:
                x = getattr(self, f"up{ind}_tattn")(getattr(self, f"up{ind}_peg")(x))
            if hasattr(self, f"up{ind}_upsample"):
                x = getattr(self, f"up{ind}_upsample")(x)

        if init_conv_residual is not None:
            x = torch.cat([x, init_conv_residual], dim=-1)
        if self.final_res_block is not None:
            x = self.final_res_block(x, t, ignore_time=ignore_time)
        if lowres_cond_img is not None:
            x = torch.cat([x, lowres_cond_img.to(x.dtype)], dim=-1)
        # the output conv in fp32 on an fp32 cast (JAX unet_video.py:1108-1112)
        return self.final_conv(x.float())
