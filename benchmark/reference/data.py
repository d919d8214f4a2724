"""The benchmark's inputs and the data arithmetic the reference redoes.

* :func:`generate_pair`: the structured phantom pair (HR and its degraded
  LR on the same grid), a frozen numpy copy of the generator the port ships
  (``data/synthetic.py::generate_pair``), so that no later change to the
  program changes the benchmark's data.
* :func:`window_starts`, :func:`gather_windows`: the sliding windows of a
  served volume (stride ``overlap``, windows with at least 5% non-zero
  voxels), z-scored and split into ``f^3`` rows each.
* :func:`trim_stitch`: trim-mode stitching (``overlap // 2`` off every
  interior face, later windows win), DiffusionIQT's test.py:184-243.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.unet import split


def _field(size, corr, rng):
    noise = rng.standard_normal((size,) * 3).astype(np.float32)
    spec = np.fft.rfftn(noise)
    fx = np.fft.fftfreq(size)[:, None, None]
    fy = np.fft.fftfreq(size)[None, :, None]
    fz = np.fft.rfftfreq(size)[None, None, :]
    filt = np.exp(-2.0 * (np.pi * corr) ** 2 * (fx ** 2 + fy ** 2 + fz ** 2))
    field = np.fft.irfftn(spec * filt, s=(size,) * 3).astype(np.float32)
    field -= field.mean()
    return field / (field.std() + 1e-8)


def _envelope(size, rng):
    ax = rng.uniform(0.36, 0.44, size=3) * size
    center = size / 2 + rng.uniform(-0.03, 0.03, size=3) * size
    grid = np.arange(size, dtype=np.float32)
    r = np.sqrt(((grid[:, None, None] - center[0]) / ax[0]) ** 2
                + ((grid[None, :, None] - center[1]) / ax[1]) ** 2
                + ((grid[None, None, :] - center[2]) / ax[2]) ** 2)
    return np.clip((1.05 - r) / 0.08, 0.0, 1.0).astype(np.float32)


def _lerp_axis(vol, factor, axis):
    n = vol.shape[axis]
    pos = (np.arange(n * factor, dtype=np.float32) + 0.5) / factor - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    shape = [1, 1, 1]
    shape[axis] = -1
    w = np.clip(pos - lo, 0.0, 1.0).astype(np.float32).reshape(shape)
    return np.take(vol, lo, axis=axis) * (1.0 - w) + np.take(vol, hi, axis=axis) * w


def generate_pair(size: int, seed: int, factor: int = 4, noise_sigma: float = 12.0):
    """(hr, lr) raw-intensity phantoms of edge ``size`` from ``seed``:
    three tissue plateaus from a coarse random field, fine texture and a
    smooth bias inside an ellipsoid, zero outside; LR is the block average
    by ``factor``, upsampled trilinearly, plus noise, background zeroed."""
    rng = np.random.default_rng(seed)
    coarse = _field(size, 9.0, rng)
    fine = _field(size, 2.0, rng)
    bias = _field(size, 30.0, rng)
    tissue = np.where(coarse < -0.4, 0.35, np.where(coarse < 0.45, 0.7, 1.0)).astype(np.float32)
    env = _envelope(size, rng)
    hr = (np.clip((tissue * 650.0 + fine * 90.0) * (1.0 + 0.12 * bias), 0.0, None)
          * env).astype(np.float32)
    rng = np.random.default_rng(seed + 100003)
    s = size // factor
    small = hr.reshape(s, factor, s, factor, s, factor).mean(axis=(1, 3, 5))
    lr = small.astype(np.float32)
    for axis in range(3):
        lr = _lerp_axis(lr, factor, axis)
    lr = lr + rng.standard_normal(lr.shape).astype(np.float32) * noise_sigma
    lr = np.where(hr > 0, np.clip(lr, 0.0, None), 0.0).astype(np.float32)
    return hr, lr


def window_starts(volume: np.ndarray, patch: int, overlap: int, ratio: float = 0.05):
    """(N, 3) starts of the windows at stride ``overlap`` with at least
    ``ratio`` non-zero voxels, in x, y, z order."""
    starts = []
    for i in range(0, volume.shape[0] - patch + 1, overlap):
        for j in range(0, volume.shape[1] - patch + 1, overlap):
            for k in range(0, volume.shape[2] - patch + 1, overlap):
                w = volume[i:i + patch, j:j + patch, k:k + patch]
                if np.count_nonzero(w) >= ratio * patch ** 3:
                    starts.append((i, j, k))
    return starts


def gather_windows(volume: torch.Tensor, starts, patch: int, f: int, mean: float,
                   std: float) -> torch.Tensor:
    """The z-scored windows at ``starts`` of a raw ``(X, Y, Z)`` volume, as
    ``(len(starts) * f^3, s, s, s, 1)`` rows."""
    z = (volume - mean) / std
    wins = torch.stack([z[i:i + patch, j:j + patch, k:k + patch] for i, j, k in starts])
    return split(wins[..., None], f)


def trim_stitch(shape, windows: torch.Tensor, starts, patch: int, overlap: int,
                fill: float) -> torch.Tensor:
    """Windows ``(N, p, p, p)`` placed into a volume of ``shape``: each
    window's centre, with ``overlap // 2`` trimmed off every face that is not
    on the volume's border, in order (later windows win); ``fill`` elsewhere."""
    out = torch.full(tuple(shape), fill, dtype=torch.float32, device=windows.device)
    half = overlap // 2
    for win, start in zip(windows, starts):
        lo = [0 if s == 0 else half for s in start]
        hi = [0 if s + patch == e else half for s, e in zip(start, shape)]
        if overlap >= patch:
            lo, hi = [0, 0, 0], [0, 0, 0]
        out[tuple(slice(s + a, s + patch - b) for s, a, b in zip(start, lo, hi))] = \
            win[tuple(slice(a, patch - b) for a, b in zip(lo, hi))]
    return out


def crop_pairs(pairs, positions, patch: int, mean: float, std: float, device):
    """z-scored ``(hr, lr)`` crops, ``(N, patch, patch, patch, 1)`` each, at
    ``positions`` rows of ``(pair, x, y, z)``."""
    hr, lr = [], []
    for k, x, y, z in np.asarray(positions).tolist():
        h, l = pairs[k]
        hr.append(h[x:x + patch, y:y + patch, z:z + patch])
        lr.append(l[x:x + patch, y:y + patch, z:z + patch])
    to = lambda a: ((torch.from_numpy(np.stack(a)).to(device) - mean) / std)[..., None]
    return to(hr), to(lr)
