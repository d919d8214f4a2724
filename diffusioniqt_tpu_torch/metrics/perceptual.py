"""Perceptual losses (counterpart of ``diffusioniqt_tpu/metrics/perceptual.py``;
reference ``percept_loss.py`` and the 3D-to-slices step of the VGG-LPIPS
loss, ``utils_mine.py:69-101``).

  * :func:`volume_to_slices` — 3D volume -> stacked 3-channel coronal and
    sagittal slices every 9 voxels, bilinear-resized as ``jax.image.resize``
    resizes (``ops/volume.py::resize_volume``), min-max normalised over the
    whole slice stack ``(B, X, Y, 3)`` with eps 1e-8
  * :class:`ResNet10Features` — the 3D ResNet-10 feature pyramid with
    flax's ``"SAME"`` padding (asymmetric at stride 2 on an even extent:
    (0, 1) for 3^3, (2, 3) for 7^3) and GroupNorm at flax's eps 1e-6
  * :class:`MedPerceptualLoss` — mean squared feature distance over the
    five taps plus an optional Gram style term (Gram divided by the voxel
    count), averaged over the taps

No pretrained weights ship with the repository. Built without weights, a
network draws its own fixed-seed init: LeCun-normal conv kernels (the
distribution flax's default draws, not its numbers) and identity norms. It
is a random-feature proxy, and its numbers are not the JAX proxy's; load
the JAX package's parameters with ``utils/convert.py`` to compute the
same thing.

Modules take channels-last inputs, as the JAX modules do, and compute in
NC(D)HW for cuDNN; their feature maps come back channels-first. The
networks are frozen (no parameter asks for a gradient): a loss term's
gradient flows to its prediction only, and the target's features are
computed without a graph (JAX's ``stop_gradient``).
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffusioniqt_tpu_torch.ops.volume import resize_volume
from diffusioniqt_tpu_torch.parallel.sharding import global_extremes

# flax's GroupNorm epsilon (torch's default is 1e-5)
_GN_EPS = 1e-6
# std of a standard normal truncated to [-2, 2], which flax's
# variance_scaling(1, "fan_in", "truncated_normal") divides out
_TRUNC_STD = 0.87962566103423978


def init_frozen_(module: nn.Module, seed: int) -> nn.Module:
    """Fixed-seed init of ``module``'s convs (LeCun normal, truncated at two
    standard deviations, biases zero; norms and affines keep their identity
    init), then freeze every parameter."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Conv3d)):
                fan_in = m.weight[0].numel()
                std = fan_in ** -0.5 / _TRUNC_STD
                nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=gen)
                if m.bias is not None:
                    m.bias.zero_()
    return module.requires_grad_(False)


def pad_same(x: torch.Tensor, kernel: int, stride: int) -> torch.Tensor:
    """flax ``padding="SAME"`` on every spatial axis of an NC(D)HW tensor:
    ``ceil(n / stride)`` outputs, the padding's odd voxel at the high end."""
    pads = []
    for n in reversed(x.shape[2:]):  # F.pad lists the last axis first
        total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads)


class _BasicBlock3D(nn.Module):
    """conv3 (stride) - GN - relu - conv3 - GN, plus a strided 1^3
    projection of the input when the shape changes; relu of the sum."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = nn.Conv3d(cin, filters, 3, stride=stride, bias=False)
        self.norm1 = nn.GroupNorm(8, filters, eps=_GN_EPS)
        self.conv2 = nn.Conv3d(filters, filters, 3, bias=False)
        self.norm2 = nn.GroupNorm(8, filters, eps=_GN_EPS)
        self.downsample = (nn.Conv3d(cin, filters, 1, stride=stride, bias=False)
                           if stride != 1 or cin != filters else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(pad_same(x, 3, self.stride))))
        y = self.norm2(self.conv2(pad_same(y, 3, 1)))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class ResNet10Features(nn.Module):
    """3D ResNet-10 feature pyramid (JAX perceptual.py:51-68): the stem
    (7^3 stride 2, GN, relu) and four blocks of 64, 128, 256, 512 filters.
    Input (B, X, Y, Z, C); returns the five NCDHW feature maps."""

    def __init__(self, in_channels: int = 1, seed: int = 0):
        super().__init__()
        self.stem = nn.Conv3d(in_channels, 64, 7, stride=2, bias=False)
        self.stem_norm = nn.GroupNorm(8, 64, eps=_GN_EPS)
        blocks, cin = [], 64
        for filters, stride in ((64, 1), (128, 2), (256, 2), (512, 2)):
            blocks.append(_BasicBlock3D(cin, filters, stride))
            cin = filters
        self.blocks = nn.ModuleList(blocks)
        init_frozen_(self, seed)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = x.movedim(-1, 1)
        x = F.relu(self.stem_norm(self.stem(pad_same(x, 7, 2))))
        feats = [x]
        for block in self.blocks:
            x = block(x)
            feats.append(x)
        return feats


def gram(feat: torch.Tensor, normalize: bool) -> torch.Tensor:
    """(B, C, ...) -> (B, C, C) sum over voxels of the channel products,
    divided by the voxel count when ``normalize``."""
    flat = feat.flatten(2)
    g = flat @ flat.transpose(1, 2)
    return g / flat.shape[-1] if normalize else g


class MedPerceptualLoss(nn.Module):
    """3D perceptual + optional Gram style loss (JAX perceptual.py:79-102;
    reference ``MedPercept``, percept_loss.py:104-126). ``state`` is a
    :class:`ResNet10Features` state dict; without one the fixed-seed init
    of ``seed``."""

    def __init__(self, state: Optional[dict] = None, style_weight: float = 0.0,
                 seed: int = 0):
        super().__init__()
        self.model = ResNet10Features(seed=seed)
        if state is not None:
            self.model.load_state_dict(state)
        self.style_weight = style_weight

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        f_pred = self.model(pred)
        with torch.no_grad():
            f_tgt = self.model(target)
        loss = pred.new_zeros(())
        for a, b in zip(f_pred, f_tgt):
            loss = loss + torch.mean((a - b) ** 2)
            if self.style_weight > 0:
                loss = loss + self.style_weight * torch.mean(
                    (gram(a, True) - gram(b, True)) ** 2)
        return loss / len(f_pred)


def volume_to_slices(volume: torch.Tensor, target_size: int = 224,
                     group=None) -> torch.Tensor:
    """3D volume -> stacked 3-channel 2D slices for 2D LPIPS (JAX
    perceptual.py:105-124; reference ``volume_to_slices``,
    utils_mine.py:69-101). Input (B, X, Y, Z, C); output (N, target,
    target, 3), for each depth ``d`` in ``0, 9, 18, ...`` the coronal stack
    of ``d..d+2`` and then the sagittal one, each min-max normalised over
    the whole stack and resized bilinearly. With ``group`` (a process group
    whose ranks each hold a share of the batch's rows) a stack's min and max
    are those over every rank's share, as the one-process call over the
    whole batch takes them (``parallel/sharding.py::global_extremes``)."""
    stacks: List[torch.Tensor] = []
    depth = volume.shape[3]
    for d in range(0, depth - 2, 9):
        stacks.append(torch.cat([volume[:, :, :, d + i, :] for i in range(3)], dim=-1))
        stacks.append(torch.cat([volume[:, :, d + i, :, 0:1] for i in range(3)], dim=-1))
    if group is None:
        lo = [s.min() for s in stacks]
        hi = [s.max() for s in stacks]
    else:
        lo, hi = global_extremes(stacks, group)
    slices = [resize_volume((s - lo[i]) / (hi[i] - lo[i] + 1e-8), target_size, "linear")
              for i, s in enumerate(stacks)]
    return torch.cat(slices, dim=0)
