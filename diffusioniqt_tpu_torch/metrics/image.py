"""Image quality metrics for 3D volumes: PSNR, SSIM and MS-SSIM (counterpart
of ``diffusioniqt_tpu/metrics/image.py``; reference ``metrics.py:17-34``,
which wraps torchmetrics):

  * ``PSNR``  — min-max normalise pred and target independently, then PSNR
    with data_range=1.0
  * ``SSIM``  — kernel_size=3 Gaussian-window SSIM
  * ``MSSIM`` — multi-scale SSIM, torchmetrics defaults

Volumes are channels-last ``(B, X, Y, Z, C)``, fp32, on any device. The
separable Gaussian filter is a depthwise ``F.conv3d`` per axis, VALID, run
with cuDNN's TF32 off so that a CUDA tensor gives the fp32 result.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F


def _min_max_norm(x: torch.Tensor) -> torch.Tensor:
    return (x - x.min()) / (x.max() - x.min())


def psnr(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0) -> torch.Tensor:
    """PSNR over the full batch tensor (torchmetrics default reduction)."""
    mse = torch.mean((pred - target) ** 2)
    return 10.0 * torch.log10(data_range ** 2 / mse)


def PSNR(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Reference ``PSNR``: min-max normalise each input, data_range=1.0."""
    return psnr(_min_max_norm(pred), _min_max_norm(target), data_range=1.0)


def _gaussian_kernel1d(size: int, sigma: float) -> np.ndarray:
    coords = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


@contextlib.contextmanager
def _no_tf32():
    """cuDNN convolutions in full fp32 for the duration (restored after)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _filter3d(x: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 3D Gaussian filter on (B, X, Y, Z, C), VALID padding: one
    depthwise conv per spatial axis."""
    c = x.shape[-1]
    k = torch.from_numpy(k1d).to(device=x.device, dtype=x.dtype)
    v = x.permute(0, 4, 1, 2, 3)
    with _no_tf32():
        for axis in range(3):
            shape = [1, 1, 1]
            shape[axis] = k.numel()
            v = F.conv3d(v, k.reshape(1, 1, *shape).expand(c, 1, *shape), groups=c)
    return v.permute(0, 2, 3, 4, 1)


def ssim3d(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
           kernel_size: int = 11, sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03,
           return_contrast_sensitivity: bool = False):
    """Gaussian-window SSIM for 3D volumes (B, X, Y, Z, C)."""
    k1d = _gaussian_kernel1d(kernel_size, sigma)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    # the five local means in one depthwise pass, one channel group each
    c = pred.shape[-1]
    stats = _filter3d(torch.cat([pred, target, pred * pred, target * target,
                                 pred * target], dim=-1), k1d)
    mu_x, mu_y, mu_xx, mu_yy, mu_xy = stats.split(c, dim=-1)

    sigma_x = mu_xx - mu_x ** 2
    sigma_y = mu_yy - mu_y ** 2
    sigma_xy = mu_xy - mu_x * mu_y

    cs_map = (2 * sigma_xy + c2) / (sigma_x + sigma_y + c2)
    ssim_map = ((2 * mu_x * mu_y + c1) / (mu_x ** 2 + mu_y ** 2 + c1)) * cs_map

    ssim_val = ssim_map.mean()
    if return_contrast_sensitivity:
        return ssim_val, cs_map.mean()
    return ssim_val


def SSIM(pred, target, kernel_size: int = 3, data_range=None):
    """Reference ``SSIM``: kernel_size=3; when data_range is None both inputs
    are min-max normalised first (metrics.py:23-30)."""
    if data_range is None:
        pred = _min_max_norm(pred)
        target = _min_max_norm(target)
        data_range = 1.0
    return ssim3d(pred, target, data_range=data_range, kernel_size=kernel_size)


_MSSSIM_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def _avg_pool3d(x: torch.Tensor) -> torch.Tensor:
    """2x2x2 mean pool, VALID, on (B, X, Y, Z, C)."""
    return F.avg_pool3d(x.permute(0, 4, 1, 2, 3), 2).permute(0, 2, 3, 4, 1)


def MSSIM(pred: torch.Tensor, target: torch.Tensor, data_range: float = 1.0,
          kernel_size: int = 11, sigma: float = 1.5,
          betas: Sequence[float] = _MSSSIM_BETAS) -> torch.Tensor:
    """Multi-scale SSIM, torchmetrics defaults (reference metrics.py:32-34).

    Scales that would shrink the volume below the filter size are dropped
    (with the remaining beta weights renormalised) so small test volumes
    yield a defined value instead of NaN."""
    min_edge = min(pred.shape[1:4])
    if min_edge < kernel_size:
        kernel_size = max(3, min_edge if min_edge % 2 else min_edge - 1)
    feasible = 1
    while feasible < len(betas) and min_edge // (2 ** feasible) >= kernel_size:
        feasible += 1
    if feasible < len(betas):
        total = sum(betas[:feasible])
        betas = [b / total for b in betas[:feasible]]
    vals = []
    for i in range(len(betas)):
        if i == len(betas) - 1:
            s = ssim3d(pred, target, data_range=data_range, kernel_size=kernel_size,
                       sigma=sigma)
            vals.append(torch.clamp(s, min=1e-6))
        else:
            _, cs = ssim3d(pred, target, data_range=data_range, kernel_size=kernel_size,
                           sigma=sigma, return_contrast_sensitivity=True)
            vals.append(torch.clamp(cs, min=1e-6))
            pred = _avg_pool3d(pred)
            target = _avg_pool3d(target)
    vals = torch.stack(vals)
    betas = torch.tensor(list(betas), dtype=vals.dtype, device=vals.device)
    return torch.prod(vals ** betas)
