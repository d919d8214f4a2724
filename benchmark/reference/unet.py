"""The 3D IQT U-Net in plain fp32 PyTorch, as functions over a dict of raw
weights: the yardstick the benchmark holds the port's denoiser against.

It imports nothing of the port (nor JAX). It follows the published
architecture (imagen-pytorch's ``Unet`` as the DiffusionIQT fork extends it,
imagen_pytorch3D.py:535-1737), on channels-last ``(B, X, Y, Z, C)`` tensors
whose rows are the 32^3 sub-volumes of the served windows, ``f^3``
consecutive rows to a window (row ``(gx * f + gy) * f + gz`` covers
``window[gx*s:(gx+1)*s, gy*s:(gy+1)*s, gz*s:(gz+1)*s]``):

* Block: GroupNorm with statistics per row, its affine, the time
  ``(scale + 1, shift)``, Mish, then a 3^3 conv. With the boundary halo
  (``boundary``) the conv is the SAME conv over the whole window that the
  row belongs to, which is what a halo exchange followed by a VALID conv per
  sub-volume computes; without it, a SAME conv over each row alone.
* ResnetBlock: Block, Block with the time scale-shift, squeeze-excite over
  the row, plus the residual (a 1x1 conv where the width changes).
* pixel-unshuffle + 1x1 downsample, 1x1 + Mish + pixel-shuffle upsample,
  the cross-embed stem (3 / 7 / 15), the learned sinusoidal time embedding,
  the ViT at the middle (patch embedding, pre-norm multi-head attention and
  the LocalViT feed-forward, trilinear reconstruction), on the whole window.

Every convolution and matrix product goes through ``ctx.q``, which rounds
both operands: the identity for the reference, a float8 rounding for the
control (:func:`fp8_round`). Everything else runs in fp32. ``ctx.blocks``,
when a list, receives ``(rows, edge, cin, cout)`` of every Block's conv, for
the work arithmetic (``benchmark/work.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude at 448), back in fp32: a product's operand in fp8."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    return (t / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def fp8_round_st(t: torch.Tensor) -> torch.Tensor:
    """:func:`fp8_round` in the forward, the identity in the backward."""
    return t + (fp8_round(t) - t).detach()


@dataclass
class Ctx:
    """How the reference computes: ``q`` rounds the operands of every
    product; ``blocks`` collects the Blocks' conv shapes when a list."""

    q: Callable[[torch.Tensor], torch.Tensor] = identity
    blocks: Optional[List[tuple]] = field(default=None)


def mish(x):
    return x * torch.tanh(F.softplus(x))


# -- layout ------------------------------------------------------------------

def merge(x, f):
    """(N*f^3, s, s, s, C) rows -> (N, f*s, f*s, f*s, C) windows."""
    n, s, c = x.shape[0], x.shape[1], x.shape[-1]
    x = x.reshape(n // f ** 3, f, f, f, s, s, s, c).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(n // f ** 3, f * s, f * s, f * s, c)


def split(x, f):
    """Inverse of :func:`merge`."""
    b, e, c = x.shape[0], x.shape[1], x.shape[-1]
    s = e // f
    x = x.reshape(b, f, s, f, s, f, s, c).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(b * f ** 3, s, s, s, c)


def unshuffle(x):
    """(B, 2X, 2Y, 2Z, C) -> (B, X, Y, Z, 8C), channel ``c * 8 + (rx * 2 + ry)
    * 2 + rz``."""
    b, X, Y, Z, c = x.shape
    x = x.reshape(b, X // 2, 2, Y // 2, 2, Z // 2, 2, c).permute(0, 1, 3, 5, 7, 2, 4, 6)
    return x.reshape(b, X // 2, Y // 2, Z // 2, c * 8)


def shuffle(x):
    """Inverse of :func:`unshuffle`."""
    b, X, Y, Z, c = x.shape
    x = x.reshape(b, X, Y, Z, c // 8, 2, 2, 2).permute(0, 1, 5, 2, 6, 3, 7, 4)
    return x.reshape(b, X * 2, Y * 2, Z * 2, c // 8)


# -- layers ------------------------------------------------------------------

def linear(ctx, x, w, b=None):
    """Dense layer, or a 1x1 conv (weight ``(Cout, Cin, 1, 1, 1)``)."""
    w = w.reshape(w.shape[0], -1)
    return F.linear(ctx.q(x), ctx.q(w), b)


def conv(ctx, x, w, b=None, padding=0, stride=1, groups=1):
    """A conv of a channels-last tensor."""
    y = F.conv3d(ctx.q(x).permute(0, 4, 1, 2, 3), ctx.q(w), b, stride=stride,
                 padding=padding, groups=groups)
    return y.permute(0, 2, 3, 4, 1)


def group_norm(x, w, b, groups, eps=1e-5):
    """GroupNorm with statistics per row."""
    shape = x.shape
    xv = x.reshape(shape[0], -1, groups, shape[-1] // groups)
    var, mean = torch.var_mean(xv, dim=(1, 3), unbiased=False, keepdim=True)
    return ((xv - mean) * torch.rsqrt(var + eps)).reshape(shape) * w + b


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w, b, eps)


def chan_layer_norm(x, g, eps=1e-5):
    var, mean = torch.var_mean(x, dim=-1, unbiased=False, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * g.reshape(-1)


def block(ctx, P, name, x, f, groups, scale_shift=None):
    h = group_norm(x, P[name + ".groupnorm.weight"], P[name + ".groupnorm.bias"], groups)
    if scale_shift is not None:
        scale, shift = scale_shift
        h = h * (scale + 1) + shift
    h = mish(h)
    w, b = P[name + ".project.weight"], P[name + ".project.bias"]
    if ctx.blocks is not None:
        ctx.blocks.append((x.shape[0], x.shape[1], w.shape[1], w.shape[0]))
    if f == 1:
        return conv(ctx, h, w, b, padding=1)
    return split(conv(ctx, merge(h, f), w, b, padding=1), f)


def resnet(ctx, P, name, x, t, f, groups):
    w = P[name + ".time_mlp.1.weight"]
    ss = linear(ctx, mish(t), w, P[name + ".time_mlp.1.bias"])[:, None, None, None, :]
    h = block(ctx, P, name + ".block1", x, f, groups)
    h = block(ctx, P, name + ".block2", h, f, groups, ss.chunk(2, dim=-1))
    if name + ".se.fc.0.weight" in P:
        y = torch.relu(linear(ctx, h.mean(dim=(1, 2, 3)), P[name + ".se.fc.0.weight"]))
        y = torch.sigmoid(linear(ctx, y, P[name + ".se.fc.2.weight"]))
        h = h * y[:, None, None, None, :]
    if name + ".res_conv.weight" in P:
        x = linear(ctx, x, P[name + ".res_conv.weight"], P[name + ".res_conv.bias"])
    return h + x


def separable(ctx, P, name, x, stride=1, padding=0):
    w = P[name + ".depthwise.weight"]
    x = conv(ctx, x, w, P[name + ".depthwise.bias"], padding=padding, stride=stride,
             groups=w.shape[0])
    return linear(ctx, x, P[name + ".pointwise.weight"], P[name + ".pointwise.bias"])


def vit(ctx, P, name, x, arch, patch):
    """ViT3D on whole windows ``(N, S, S, S, C)``: eval mode, no dropout."""
    n_win, c = x.shape[0], x.shape[-1]
    heads, dh = arch["attend_at_middle_heads"], arch["attn_dim_head"]
    tok = separable(ctx, P, name + ".patch_embedding.projection.0", x, stride=patch)
    p = tok.shape[1]
    tok = tok.reshape(n_win, p ** 3, c) + P[name + ".patch_embedding.positions"]
    for d in range(arch["attend_at_middle_depth"]):
        layer = f"{name}.transformer_encoder.layers.{d}.block"
        h = layer_norm(tok, P[layer + ".0.fn.0.weight"], P[layer + ".0.fn.0.bias"], 1e-6)
        qkv = linear(ctx, h, P[layer + ".0.fn.1.qkv.weight"], P[layer + ".0.fn.1.qkv.bias"])
        qkv = qkv.reshape(n_win, -1, heads, dh, 3).permute(4, 0, 2, 1, 3)
        q, k, v = qkv[0], qkv[1], qkv[2]
        att = torch.softmax(ctx.q(q) @ ctx.q(k).transpose(-1, -2) * dh ** -0.5, dim=-1)
        out = (ctx.q(att) @ ctx.q(v)).permute(0, 2, 1, 3).reshape(n_win, -1, heads * dh)
        tok = tok + linear(ctx, out, P[layer + ".0.fn.1.projection.weight"],
                           P[layer + ".0.fn.1.projection.bias"])
        h = layer_norm(tok, P[layer + ".1.fn.0.weight"], P[layer + ".1.fn.0.bias"], 1e-6)
        ff = layer + ".1.fn.1.net"
        h = h.reshape(n_win, p, p, p, c)
        h = mish(linear(ctx, h, P[ff + ".0.1.weight"], P[ff + ".0.1.bias"]))
        h = mish(separable(ctx, P, ff + ".1.0", h, padding=1))
        h = linear(ctx, h, P[ff + ".2.0.weight"], P[ff + ".2.0.bias"])
        tok = tok + h.reshape(n_win, p ** 3, c)
    tok = layer_norm(tok, P[name + ".reconstruction.0.weight"],
                     P[name + ".reconstruction.0.bias"], 1e-6)
    vol = tok.reshape(n_win, p, p, p, c)
    if patch > 1:
        vol = F.interpolate(vol.permute(0, 4, 1, 2, 3), scale_factor=patch,
                            mode="trilinear", align_corners=True).permute(0, 2, 3, 4, 1)
    vol = separable(ctx, P, name + ".reconstruction.3", vol, padding=1)
    return chan_layer_norm(vol, P[name + ".reconstruction.4.g"])


def time_embedding(ctx, P, log_snr):
    x = log_snr[:, None]
    freqs = x * P["to_time_hiddens.0.weights"][None, :] * 2 * math.pi
    t = torch.cat([x, freqs.sin(), freqs.cos()], dim=-1)
    t = mish(linear(ctx, t, P["to_time_hiddens.1.weight"], P["to_time_hiddens.1.bias"]))
    return linear(ctx, t, P["to_time_cond.0.weight"], P["to_time_cond.0.bias"])


def forward(P: Weights, arch: dict, x, log_snr, lowres, ctx: Optional[Ctx] = None):
    """The denoiser's output ``(B, s, s, s, 1)`` for noisy rows ``x``, their
    log-SNR ``(B,)`` and the lowres rows, all fp32 (one or more whole
    windows of rows)."""
    ctx = ctx or Ctx()
    f = arch["batch_sample_factor"] if arch["boundary"] else 1
    groups = arch["resnet_groups"]
    levels = len(arch["dim_mults"])
    efficient = arch["memory_efficient"]
    h = torch.cat([x, lowres], dim=-1)
    if arch["init_cross_embed"]:
        h = torch.cat([conv(ctx, h, P[f"init_conv.convs.{i}.weight"],
                            P[f"init_conv.convs.{i}.bias"], padding=(k - 1) // 2)
                       for i, k in enumerate(sorted(arch["cross_embed_kernel_sizes"]))], dim=-1)
    elif f == 1:
        h = conv(ctx, h, P["init_conv.weight"], P["init_conv.bias"], padding=1)
    else:
        h = split(conv(ctx, merge(h, f), P["init_conv.weight"], P["init_conv.bias"],
                       padding=1), f)
    t = time_embedding(ctx, P, log_snr)

    skips = []
    for i in range(levels):
        name = f"downs.{i}"
        if efficient:
            h = linear(ctx, unshuffle(h), P[name + ".0.1.weight"], P[name + ".0.1.bias"])
        h = resnet(ctx, P, name + ".1", h, t, f, groups)
        for j in range(arch["num_resnet_blocks"][i]):
            h = resnet(ctx, P, f"{name}.3.{j}", h, t, f, groups)
        last = i == levels - 1
        if not last:
            skips.append(h)
        if efficient or last:
            h = linear(ctx, h, P[name + ".4.weight"], P[name + ".4.bias"])
        else:
            h = linear(ctx, unshuffle(h), P[name + ".4.1.weight"], P[name + ".4.1.bias"])

    if arch["deep_feature"]:
        if arch["attend_at_middle"]:
            window = merge(h, arch["batch_sample_factor"])
            patch = max(arch["init_patch_size"] // 2 ** (levels - 1), 1)
            h = split(vit(ctx, P, "mid_attn", window, arch, patch), arch["batch_sample_factor"])
        h = resnet(ctx, P, "mid_block", h, t, f, groups)

    for i in range(levels):
        name = f"ups.{i}"
        if i < levels - 1 or efficient:
            w = P[name + ".0.net.0.weight"]
            h = shuffle(mish(linear(ctx, h, w, P[name + ".0.net.0.bias"])))
        if skips:
            h = torch.cat([h, skips.pop()], dim=-1)
        h = resnet(ctx, P, name + ".1", h, t, f, groups)
        for j in range(arch["num_resnet_blocks"][levels - 1 - i]):
            h = resnet(ctx, P, f"{name}.2.{j}", h, t, f, groups)
    h = resnet(ctx, P, "final_res_block", h, t, f, groups)
    return linear(ctx, h, P["final_conv.weight"], P["final_conv.bias"])


def param_shapes(arch: dict) -> Dict[str, tuple]:
    """Every weight of the configuration, by the published ``Unet``'s
    parameter names, with its shape: what :func:`forward` reads."""
    shapes: Dict[str, tuple] = {}
    dim, init_dim, ch = arch["dim"], arch["init_dim"], arch["channels"]
    tc, levels = dim * 4, len(arch["dim_mults"])
    efficient, se = arch["memory_efficient"], arch["use_se"]

    def conv_(name, cout, cin, k=1, bias=True):
        shapes[name + ".weight"] = (cout, cin, k, k, k)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def dense(name, cout, cin, bias=True):
        shapes[name + ".weight"] = (cout, cin)
        if bias:
            shapes[name + ".bias"] = (cout,)

    def res(name, din, dout, use_se=se):
        dense(name + ".time_mlp.1", 2 * dout, tc)
        for b, cin in (("block1", din), ("block2", dout)):
            shapes[f"{name}.{b}.groupnorm.weight"] = shapes[f"{name}.{b}.groupnorm.bias"] = (cin,)
            conv_(f"{name}.{b}.project", dout, cin, 3)
        if use_se:
            hidden = max(dout // 16, 1)
            dense(name + ".se.fc.0", hidden, dout, bias=False)
            dense(name + ".se.fc.2", dout, hidden, bias=False)
        if din != dout:
            conv_(name + ".res_conv", dout, din)

    in_ch = 2 * ch
    if arch["init_cross_embed"]:
        ks = sorted(arch["cross_embed_kernel_sizes"])
        scales = [int(init_dim / 2 ** i) for i in range(1, len(ks))]
        for i, (k, d) in enumerate(zip(ks, [*scales, init_dim - sum(scales)])):
            conv_(f"init_conv.convs.{i}", d, in_ch, k)
    else:
        conv_("init_conv", init_dim, in_ch, 3)
    emb = arch["learned_sinu_pos_emb_dim"]
    shapes["to_time_hiddens.0.weights"] = (emb // 2,)
    dense("to_time_hiddens.1", tc, emb + 1)
    dense("to_time_cond.0", tc, tc)

    dims = [init_dim, *(dim * m for m in arch["dim_mults"])]
    pairs = list(zip(dims[:-1], dims[1:]))
    size, patch, skips = arch["img_size"], arch["init_patch_size"], []
    for i, (din, dout) in enumerate(pairs):
        last = i == levels - 1
        if efficient:
            conv_(f"downs.{i}.0.1", dout, din * 8)
            cur = dout
            size //= 2
        else:
            cur = din
        res(f"downs.{i}.1", cur, cur)
        for j in range(arch["num_resnet_blocks"][i]):
            res(f"downs.{i}.3.{j}", cur, cur)
        if efficient:
            conv_(f"downs.{i}.4", dout, dout)
        elif last:
            conv_(f"downs.{i}.4", dout, din)
        else:
            conv_(f"downs.{i}.4.1", dout, din * 8)
        if not last:
            skips.append(cur)
            size = size if efficient else size // 2
            patch = max(patch // 2, 1)

    x_dim = dims[-1]
    if arch["deep_feature"]:
        if arch["attend_at_middle"]:
            c, e = x_dim, arch["att_forward_expansion"] * x_dim
            inner = arch["attend_at_middle_heads"] * arch["attn_dim_head"]
            vit_ = "mid_attn"
            shapes[vit_ + ".patch_embedding.positions"] = ((size // patch) ** 3, c)
            shapes[vit_ + ".patch_embedding.projection.0.depthwise.weight"] = (c, 1, patch, patch, patch)
            shapes[vit_ + ".patch_embedding.projection.0.depthwise.bias"] = (c,)
            conv_(vit_ + ".patch_embedding.projection.0.pointwise", c, c)
            for d in range(arch["attend_at_middle_depth"]):
                layer = f"{vit_}.transformer_encoder.layers.{d}.block"
                for n in (".0.fn.0", ".1.fn.0"):
                    shapes[layer + n + ".weight"] = shapes[layer + n + ".bias"] = (c,)
                dense(layer + ".0.fn.1.qkv", 3 * inner, c)
                dense(layer + ".0.fn.1.projection", c, inner)
                ff = layer + ".1.fn.1.net"
                conv_(ff + ".0.1", e, c)
                shapes[ff + ".1.0.depthwise.weight"] = (e, 1, 3, 3, 3)
                shapes[ff + ".1.0.depthwise.bias"] = (e,)
                conv_(ff + ".1.0.pointwise", e, e)
                conv_(ff + ".2.0", c, e)
            shapes[vit_ + ".reconstruction.0.weight"] = shapes[vit_ + ".reconstruction.0.bias"] = (c,)
            shapes[vit_ + ".reconstruction.3.depthwise.weight"] = (c, 1, 3, 3, 3)
            shapes[vit_ + ".reconstruction.3.depthwise.bias"] = (c,)
            conv_(vit_ + ".reconstruction.3.pointwise", c, c)
            shapes[vit_ + ".reconstruction.4.g"] = (c,)
        res("mid_block", x_dim, x_dim, use_se=False)

    for i, (dol, _) in enumerate(reversed(pairs)):
        if i < levels - 1 or efficient:
            conv_(f"ups.{i}.0.net.0", dol * 8, x_dim)
            x_dim = dol
        if i < levels - 1:
            x_dim += skips.pop()
        res(f"ups.{i}.1", x_dim, dol)
        for j in range(arch["num_resnet_blocks"][levels - 1 - i]):
            res(f"ups.{i}.2.{j}", dol, dol)
        x_dim = dol
    res("final_res_block", x_dim, dim)
    conv_("final_conv", ch, dim)
    return shapes
