"""MedicalNet 3D perceptual loss: counterpart of
``diffusioniqt_tpu/metrics/medicalnet.py`` (reference ``MedPercept``,
percept_loss.py:29-126, over the Med3D ResNet-10 checkpoint
``resnet_10_23dataset.pth``).

  * :class:`MedicalNetResNet10` — the Med3D ResNet-10 trunk: conv1 7^3
    stride 2 (padding 3) -> BN -> relu -> maxpool 3^3 stride 2 (padding 1)
    -> BasicBlocks with type-B (1^3 conv + BN) downsampling. BatchNorm is
    folded to an eval-mode per-channel affine (``scale``, ``bias``), as the
    reference always runs the network in ``.eval()``
  * :func:`load_medicalnet_state_dict` — the torch checkpoint (its
    ``state_dict`` wrapper, the DataParallel ``module.`` prefix) as a
    :class:`MedicalNetResNet10` state dict, each BN folded from its running
    statistics with eps 1e-5
  * :class:`MedicalNetPerceptual` — the loss as the reference wires it:
    optional 2x trilinear resize (``jax.image.resize``'s weights), L1
    feature distances at relu1, layer1 and layer2, and L1 Gram taps (no
    voxel-count division) only where ``style_layers`` asks

No checkpoint ships with the repository. Without one a network draws the
port's own fixed-seed init (``metrics/perceptual.py::init_frozen_``,
identity affines): a random-feature proxy whose numbers are not the JAX
proxy's. The network is frozen; the target's features take no gradient.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffusioniqt_tpu_torch.metrics.perceptual import gram, init_frozen_
from diffusioniqt_tpu_torch.ops.volume import resize_volume

_BN_EPS = 1e-5


class _Affine(nn.Module):
    """Eval-mode BatchNorm as a per-channel scale and bias."""

    def __init__(self, channels: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = (1, -1) + (1,) * (x.dim() - 2)
        return x * self.scale.view(shape) + self.bias.view(shape)


class _BasicBlock(nn.Module):
    """Med3D BasicBlock: conv3-bn-relu-conv3-bn (+ type-B downsample)."""

    def __init__(self, cin: int, filters: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv3d(cin, filters, 3, stride=stride, padding=1, bias=False)
        self.bn1 = _Affine(filters)
        self.conv2 = nn.Conv3d(filters, filters, 3, padding=1, bias=False)
        self.bn2 = _Affine(filters)
        if stride != 1 or cin != filters:
            self.downsample_conv = nn.Conv3d(cin, filters, 1, stride=stride, bias=False)
            self.downsample_bn = _Affine(filters)
        else:
            self.downsample_conv = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        residual = x if self.downsample_conv is None else self.downsample_bn(
            self.downsample_conv(x))
        return F.relu(y + residual)


class MedicalNetResNet10(nn.Module):
    """Med3D ResNet-10 trunk (JAX medicalnet.py:82-105). Input (B, X, Y, Z,
    C); returns the reference's block outputs [conv1, bn1, relu1, maxpool,
    layer1, layer2, ...], NCDHW, ``num_layers`` residual layers."""

    def __init__(self, num_layers: int = 2, in_channels: int = 1, seed: int = 0):
        super().__init__()
        self.conv1 = nn.Conv3d(in_channels, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = _Affine(64)
        cin = 64
        for i, (filters, stride) in enumerate(((64, 1), (128, 2), (256, 2), (512, 2))[:num_layers]):
            setattr(self, f"layer{i + 1}", _BasicBlock(cin, filters, stride))
            cin = filters
        self.num_layers = num_layers
        init_frozen_(self, seed)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        outs = [self.conv1(x.movedim(-1, 1))]
        outs.append(self.bn1(outs[-1]))
        outs.append(F.relu(outs[-1]))
        outs.append(F.max_pool3d(outs[-1], 3, stride=2, padding=1))
        for i in range(self.num_layers):
            outs.append(getattr(self, f"layer{i + 1}")(outs[-1]))
        return outs


def _fold_bn(sd: Dict[str, Any], prefix: str, key: str, out: Dict[str, torch.Tensor]) -> None:
    w, b, rm, rv = (np.asarray(sd[f"{prefix}.{k}"], np.float32)
                    for k in ("weight", "bias", "running_mean", "running_var"))
    scale = w / np.sqrt(rv + _BN_EPS)
    out[f"{key}.scale"] = torch.from_numpy(scale)
    out[f"{key}.bias"] = torch.from_numpy(b - rm * scale)


def _conv(sd: Dict[str, Any], prefix: str, key: str, out: Dict[str, torch.Tensor]) -> None:
    out[f"{key}.weight"] = torch.from_numpy(np.asarray(sd[f"{prefix}.weight"], np.float32))


def load_medicalnet_state_dict(sd: Dict[str, Any], num_layers: int = 2) -> Dict[str, torch.Tensor]:
    """MedicalNet ``resnet_10_23dataset.pth`` contents -> a
    :class:`MedicalNetResNet10` state dict (JAX medicalnet.py:122-151).
    Accepts the raw checkpoint (with a ``state_dict`` key), the
    DataParallel-prefixed form (``module.*``) or a plain state dict."""
    if "state_dict" in sd and not hasattr(sd["state_dict"], "shape"):
        sd = sd["state_dict"]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v for k, v in sd.items()}
    out: Dict[str, torch.Tensor] = {}
    _conv(sd, "conv1", "conv1", out)
    _fold_bn(sd, "bn1", "bn1", out)
    for i in range(num_layers):
        name = f"layer{i + 1}"
        for part in ("conv1", "conv2"):
            _conv(sd, f"{name}.0.{part}", f"{name}.{part}", out)
        for part in ("bn1", "bn2"):
            _fold_bn(sd, f"{name}.0.{part}", f"{name}.{part}", out)
        if f"{name}.0.downsample.0.weight" in sd:
            _conv(sd, f"{name}.0.downsample.0", f"{name}.downsample_conv", out)
            _fold_bn(sd, f"{name}.0.downsample.1", f"{name}.downsample_bn", out)
    return out


class MedicalNetPerceptual(nn.Module):
    """The reference loss (JAX medicalnet.py:154-199; percept_loss.py:78-103)
    on (B, X, Y, Z, 1) volumes. ``style_layers`` defaults to ``()``: the
    reference's wired call passes ``style_layers=[]``; ``(0, 1)`` adds the
    conv1 / bn1 Gram taps. ``state``: a :class:`MedicalNetResNet10` state
    dict, else the fixed-seed proxy of ``seed``."""

    def __init__(self, state: Optional[Dict[str, torch.Tensor]] = None, resize: bool = True,
                 seed: int = 0, num_layers: int = 2, style_layers: Sequence[int] = ()):
        super().__init__()
        self.model = MedicalNetResNet10(num_layers=num_layers, seed=seed)
        if state is not None:
            self.model.load_state_dict(state)
        self.resize = resize
        self.style_layers = tuple(style_layers)

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        if self.resize:
            size = pred.shape[1] * 2
            pred = resize_volume(pred, size, "trilinear")
            target = resize_volume(target, size, "trilinear")
        f_pred = self.model(pred)
        with torch.no_grad():
            f_tgt = self.model(target)
        loss = pred.new_zeros(())
        for i in (2, 4, 5):  # relu1, layer1, layer2
            loss = loss + torch.mean(torch.abs(f_pred[i] - f_tgt[i]))
        for i in self.style_layers:
            loss = loss + torch.mean(torch.abs(gram(f_pred[i], False) - gram(f_tgt[i], False)))
        return loss


def medicalnet_perceptual_from_checkpoint(path: str, resize: bool = True) -> MedicalNetPerceptual:
    """The loss from a torch MedicalNet checkpoint file (JAX
    medicalnet.py:202-211)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return MedicalNetPerceptual(state=load_medicalnet_state_dict(sd), resize=resize)
