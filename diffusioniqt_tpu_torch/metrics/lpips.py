"""LPIPS (Learned Perceptual Image Patch Similarity, Zhang et al. 2018, the
"vgg" variant): counterpart of ``diffusioniqt_tpu/metrics/lpips.py``.

The reference uses torchmetrics' VGG-LPIPS in two places, and so does the
port:

  * the auxiliary training loss ``loss + 0.1 * lpips(slices(pred),
    slices(target))`` (reference imagen_pytorch3D.py:1775-1778,
    2372-2385): :func:`make_lpips_fn`, plugged into
    ``Imagen(lpips_fn=...)`` by ``diffusion/gaussian.py``;
  * the evaluation metric over central slices of the stitched volume
    (reference test_all.py:43, 68-81): :func:`lpips_volume_metric`, which
    ``evaluate.py --lpips`` reports.

:class:`VGG16Features` is laid out as torchvision's VGG16 ``features``
Sequential, so a torchvision state dict loads natively; the taps are each
block's last relu (relu1_2 .. relu5_3). :class:`LPIPS` maps inputs in
[0, 1] to [-1, 1], applies LPIPS's scaling layer, unit-normalises each
tap's channel vectors, and sums the per-layer non-negative 1x1 ``lin``
heads' spatial means.

No trained VGG16 or lin weights ship with the repository. Without them the
default is a fixed-seed random VGG (the port's own init, see
``metrics/perceptual.py::init_frozen_``; not the JAX proxy's numbers) with
uniform ``1/C`` lin heads: a perceptual proxy, labelled as such. The
loaders read torchvision / ``lpips`` / torchmetrics state dicts.

Precision on the card: the training loss's VGG convs follow torch's cuDNN
TF32 switch, which is on by default (the training entry point keeps it);
:func:`lpips_volume_metric` turns TF32 off for its convs, so the metric on
the card is the fp32 one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from diffusioniqt_tpu_torch.metrics.image import _no_tf32
from diffusioniqt_tpu_torch.metrics.perceptual import init_frozen_, volume_to_slices

# (channels, num convs) per VGG16 block; taps after each block's last relu
_VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))

# torchvision ``features`` Sequential indices of the conv layers, per block
_TV_CONV_IDX = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))

# LPIPS ScalingLayer constants (Zhang et al. reference implementation)
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


class VGG16Features(nn.Module):
    """VGG16 conv trunk as torchvision's ``features`` (up to relu5_3),
    returning the five LPIPS taps, NCHW. Input (N, 3, H, W)."""

    def __init__(self, seed: int = 0):
        super().__init__()
        layers: List[nn.Module] = []
        self.taps = []
        cin = 3
        for bi, (ch, n_convs) in enumerate(_VGG16_BLOCKS):
            if bi > 0:
                layers.append(nn.MaxPool2d(2, 2))
            for _ in range(n_convs):
                layers += [nn.Conv2d(cin, ch, 3, padding=1), nn.ReLU(inplace=True)]
                cin = ch
            self.taps.append(len(layers) - 1)
        self.features = nn.Sequential(*layers)
        init_frozen_(self, seed)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        feats = []
        for i, layer in enumerate(self.features):
            x = layer(x)
            if i in self.taps:
                feats.append(x)
        return feats


def _unit_normalize(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return x / (torch.sqrt(torch.sum(x * x, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS distance between batches of (N, H, W, 3) images in [0, 1]
    (torchmetrics' ``normalize=True``, reference test_all.py:43).
    ``vgg_state``: a :class:`VGG16Features` state dict; ``lin_weights``:
    five per-channel head weights. Without them the proxy: the fixed-seed
    VGG of ``seed`` and uniform heads."""

    def __init__(self, vgg_state: Optional[Dict[str, torch.Tensor]] = None,
                 lin_weights: Optional[Sequence] = None, seed: int = 0):
        super().__init__()
        self.net = VGG16Features(seed=seed)
        if vgg_state is not None:
            self.net.load_state_dict(vgg_state)
        if lin_weights is None:
            # uniform average over channels (the paper's "baseline" variant)
            lin_weights = [torch.full((ch,), 1.0 / ch) for ch, _ in _VGG16_BLOCKS]
        for i, w in enumerate(lin_weights):
            self.register_buffer(f"lin{i}", torch.as_tensor(
                np.asarray(w, np.float32).reshape(-1)))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))

    def _prep(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float().permute(0, 3, 1, 2) * 2.0 - 1.0
        return (x - self.shift) / self.scale

    def distances(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Per-image LPIPS distance, (N,)."""
        fa = self.net(self._prep(a))
        fb = self.net(self._prep(b))
        total = a.new_zeros(a.shape[0], dtype=torch.float32)
        for i, (xa, xb) in enumerate(zip(fa, fb)):
            d = (_unit_normalize(xa) - _unit_normalize(xb)) ** 2
            w = torch.clamp(getattr(self, f"lin{i}"), min=0.0)
            total = total + torch.einsum("nchw,c->n", d, w) / (d.shape[2] * d.shape[3])
        return total

    def forward(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Mean LPIPS distance between image batches ``a`` and ``b``."""
        return self.distances(a, b).mean()


# ---------------------------------------------------------------------------
# torch checkpoint loaders
# ---------------------------------------------------------------------------

def load_torch_vgg16(state_dict) -> Dict[str, torch.Tensor]:
    """A torchvision VGG16 ``features.*`` state dict, or one whose conv keys
    are bare indices (``{idx}.*``) or the ``lpips`` package's
    ``net.slice{block}.{idx}.*``, as a :class:`VGG16Features` state dict."""
    out = {}
    for bi, idxs in enumerate(_TV_CONV_IDX):
        for idx in idxs:
            for prefix in (f"features.{idx}", str(idx), f"net.slice{bi + 1}.{idx}"):
                if f"{prefix}.weight" in state_dict:
                    for part in ("weight", "bias"):
                        out[f"features.{idx}.{part}"] = torch.as_tensor(
                            np.asarray(state_dict[f"{prefix}.{part}"], np.float32))
                    break
            else:
                raise KeyError(f"VGG16 conv features.{idx} (block {bi}) not found in "
                               "the state dict")
    return out


def load_torch_lpips(state_dict) -> List[torch.Tensor]:
    """The five trained ``lin`` head weights, (C,) each, from an ``lpips``
    package / torchmetrics state dict: keys ``lin{i}.model.1.weight``,
    ``lins.{i}.model.1.weight`` or ``net.lin{i}.model.1.weight``, each
    (1, C, 1, 1)."""
    out = []
    for i in range(5):
        for key in (f"lin{i}.model.1.weight", f"lins.{i}.model.1.weight",
                    f"net.lin{i}.model.1.weight"):
            if key in state_dict:
                out.append(torch.as_tensor(
                    np.asarray(state_dict[key], np.float32).reshape(-1)))
                break
        else:
            raise KeyError(f"LPIPS lin{i} weights not found in the state dict")
    return out


def lpips_from_torch_checkpoint(path: str) -> LPIPS:
    """An :class:`LPIPS` from a ``.pt`` / ``.pth`` state dict holding VGG16
    features and, optionally, trained lin heads (else the uniform ones)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    try:
        lin = load_torch_lpips(sd)
    except KeyError:
        lin = None
    return LPIPS(vgg_state=load_torch_vgg16(sd), lin_weights=lin)


# ---------------------------------------------------------------------------
# volume-level entry points (training loss + evaluation metric)
# ---------------------------------------------------------------------------

class SliceLPIPS(nn.Module):
    """The training loss term over volumes: :func:`volume_to_slices` of
    ``pred`` and of ``target`` (no gradient), then the mean LPIPS."""

    def __init__(self, model: LPIPS, target_size: int = 224):
        super().__init__()
        self.model = model
        self.target_size = target_size

    def forward(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        pred_rgb = volume_to_slices(pred, self.target_size)
        with torch.no_grad():
            target_rgb = volume_to_slices(target, self.target_size)
        return self.model(pred_rgb, target_rgb)


def make_lpips_fn(weights_path: Optional[str] = None, seed: int = 0,
                  target_size: int = 224, device="cpu") -> SliceLPIPS:
    """Training-loss LPIPS over (B, X, Y, Z, 1) volumes (JAX
    lpips.py:196-214; reference imagen_pytorch3D.py:2372-2385), on
    ``device``: trained weights from ``weights_path``, else the proxy."""
    model = (lpips_from_torch_checkpoint(weights_path) if weights_path
             else LPIPS(seed=seed))
    return SliceLPIPS(model, target_size).to(device)


def lpips_volume_metric(gt: np.ndarray, pred: np.ndarray,
                        model: Optional[LPIPS] = None) -> float:
    """Slice-wise LPIPS over a stitched volume (JAX lpips.py:217-240;
    reference test_all.py:68-81): the central +/-40 window of axis 1,
    every 10th slice, each slice min-max normalised (eps 1e-12) and stacked
    to RGB; the mean over the slices. Runs on ``model``'s device with fp32
    convs."""
    if model is None:
        model = LPIPS()
    device = model.shift.device
    gt = np.asarray(gt, np.float32)
    pred = np.asarray(pred, np.float32)
    n = gt.shape[1]
    half_window = min(40, n // 2)
    start = max(n // 2 - half_window, 0)
    end = min(n // 2 + half_window, n)
    gs, ps = [], []
    for idx in range(start, end, 10):
        g, p = gt[:, idx], pred[:, idx]
        gs.append((g - g.min()) / (g.max() - g.min() + 1e-12))
        ps.append((p - p.min()) / (p.max() - p.min() + 1e-12))
    if not gs:
        return float("nan")

    def rgb(slices):
        return torch.from_numpy(np.stack([np.stack((s,) * 3, axis=-1) for s in slices]))

    with torch.no_grad(), _no_tf32():
        vals = model.distances(rgb(gs).to(device), rgb(ps).to(device))
    return float(vals.double().mean())

