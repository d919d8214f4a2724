"""Structured synthetic LR/HR volume generator for end-to-end quality proof
(a copy of ``diffusioniqt_tpu/data/synthetic.py``, numpy only; the port
keeps its own because importing the JAX package imports JAX, and
``tests/test_torch_data.py`` holds the two equal bit for bit).

No HCP data ships with the repository, so trained-quality evidence (QUALITY.md)
uses procedurally generated "phantom" volumes that exercise the same
learning dynamics as the reference's low-field MRI task
(reference ``data.py:50-137``):

  * HR: band-limited Gaussian random fields composed into piecewise tissue
    classes (sharp interfaces — the structure super-resolution must restore)
    inside a smooth ellipsoid "brain" envelope with a zero background
    (the non-zero rejection sampling and background masking paths depend on
    real zeros, reference data.py:125-126 / test_all.py:300);
  * LR: block-average downsample by ``factor`` then trilinear upsample back
    plus Gaussian noise — the synthetic analog of the x8 low-field
    acquisitions the reference trains on (``lr_norm*`` files, the Harry_x8
    dataset in config/config.yaml), which live on the HR grid.

Intensities are on an MRI-like raw scale; training/eval z-score them with
the population stats from :func:`population_stats` exactly like the
reference (data.py:104-124).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def gaussian_random_field(size: int, corr_length: float,
                          rng: np.random.Generator) -> np.ndarray:
    """Zero-mean, unit-std band-limited Gaussian random field (FFT filter
    with a Gaussian spectral envelope of spatial scale ``corr_length``)."""
    noise = rng.standard_normal((size,) * 3).astype(np.float32)
    spec = np.fft.rfftn(noise)
    fx = np.fft.fftfreq(size)[:, None, None]
    fy = np.fft.fftfreq(size)[None, :, None]
    fz = np.fft.rfftfreq(size)[None, None, :]
    k2 = fx ** 2 + fy ** 2 + fz ** 2
    filt = np.exp(-2.0 * (np.pi * corr_length) ** 2 * k2)
    field = np.fft.irfftn(spec * filt, s=(size,) * 3).astype(np.float32)
    field -= field.mean()
    std = field.std()
    return field / (std + 1e-8)


def _ellipsoid_envelope(size: int, rng: np.random.Generator) -> np.ndarray:
    """Soft-edged ellipsoid mask (the "brain") with a randomized center and
    semi-axes; ~0 outside, ~1 inside."""
    ax = rng.uniform(0.36, 0.44, size=3) * size
    center = size / 2 + rng.uniform(-0.03, 0.03, size=3) * size
    grid = np.arange(size, dtype=np.float32)
    dx = ((grid[:, None, None] - center[0]) / ax[0]) ** 2
    dy = ((grid[None, :, None] - center[1]) / ax[1]) ** 2
    dz = ((grid[None, None, :] - center[2]) / ax[2]) ** 2
    r = np.sqrt(dx + dy + dz)
    # smooth edge over ~4% of the radius
    return np.clip((1.05 - r) / 0.08, 0.0, 1.0).astype(np.float32)


def synthetic_hr_volume(size: int = 192, seed: int = 0) -> np.ndarray:
    """One HR phantom: three tissue classes from a coarse field (sharp
    interfaces), fine texture, smooth intensity bias, ellipsoid envelope,
    zero background. Raw intensity scale roughly matches a T1w brain."""
    rng = np.random.default_rng(seed)
    coarse = gaussian_random_field(size, corr_length=9.0, rng=rng)
    fine = gaussian_random_field(size, corr_length=2.0, rng=rng)
    bias = gaussian_random_field(size, corr_length=30.0, rng=rng)

    # piecewise "tissue" map: CSF-, GM-, WM-like plateaus with hard edges
    tissue = np.where(coarse < -0.4, 0.35,
                      np.where(coarse < 0.45, 0.7, 1.0)).astype(np.float32)
    env = _ellipsoid_envelope(size, rng)
    intensity = (tissue * 650.0 + fine * 90.0) * (1.0 + 0.12 * bias)
    hr = np.clip(intensity, 0.0, None) * env
    return hr.astype(np.float32)


def degrade_to_lr(hr: np.ndarray, factor: int = 4, noise_sigma: float = 12.0,
                  seed: int = 0) -> np.ndarray:
    """LR on the HR grid: block-average downsample by ``factor``, trilinear
    upsample back, additive Gaussian noise, background re-zeroed."""
    rng = np.random.default_rng(seed)
    s = hr.shape[0]
    if s % factor:
        raise ValueError(f"volume edge {s} is not a multiple of factor {factor}")
    small = hr.reshape(s // factor, factor, s // factor, factor,
                       s // factor, factor).mean(axis=(1, 3, 5))
    lr = _trilinear_upsample(small, factor)
    lr = lr + rng.standard_normal(lr.shape).astype(np.float32) * noise_sigma
    mask = hr > 0
    return np.where(mask, np.clip(lr, 0.0, None), 0.0).astype(np.float32)


def _trilinear_upsample(vol: np.ndarray, factor: int) -> np.ndarray:
    """Align-corners-False trilinear upsampling by an integer factor."""
    out = vol.astype(np.float32)
    for axis in range(3):
        out = _lerp_axis(out, factor, axis)
    return out


def _lerp_axis(vol: np.ndarray, factor: int, axis: int) -> np.ndarray:
    n = vol.shape[axis]
    # sample positions of the fine grid in coarse coordinates
    pos = (np.arange(n * factor, dtype=np.float32) + 0.5) / factor - 0.5
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n - 1)
    hi = np.clip(lo + 1, 0, n - 1)
    w = np.clip(pos - lo, 0.0, 1.0).astype(np.float32)
    shape = [1, 1, 1]
    shape[axis] = -1
    w = w.reshape(shape)
    a = np.take(vol, lo, axis=axis)
    b = np.take(vol, hi, axis=axis)
    return a * (1.0 - w) + b * w


def generate_pair(size: int = 192, seed: int = 0, factor: int = 4,
                  noise_sigma: float = 12.0) -> Tuple[np.ndarray, np.ndarray]:
    """(hr, lr) raw-intensity phantom pair on the same grid."""
    hr = synthetic_hr_volume(size, seed=seed)
    lr = degrade_to_lr(hr, factor=factor, noise_sigma=noise_sigma,
                       seed=seed + 100003)
    return hr, lr


def population_stats(volumes) -> Tuple[float, float]:
    """Mean/std over raw LR volumes — the z-score normalizer constants the
    reference precomputes over its dataset (config/config.yaml Data.mean/std)."""
    flat = np.concatenate([np.asarray(v, np.float32).ravel() for v in volumes])
    return float(flat.mean()), float(flat.std())


class SyntheticIQTDataset:
    """Patch dataset over pre-generated phantom pairs — the drop-in synthetic
    analog of ``SupervisedIQT`` (random crops, non-zero rejection,
    z-score normalization; reference data.py:96-137)."""

    def __init__(self, config, n_volumes: int = 4, size: int = 192,
                 seed: int = 0, factor: int = 4, noise_sigma: float = 12.0,
                 samples_per_volume: int = 8, train: bool = True,
                 pairs=None):
        self.config = config
        self.patch_size = config.train.patch_size
        self.norm = config.data.norm
        self.ratio = 0.2 if train else 0.8
        self.samples_per_volume = samples_per_volume
        self.pairs = pairs if pairs is not None else [
            generate_pair(size, seed=seed + i, factor=factor,
                          noise_sigma=noise_sigma)
            for i in range(n_volumes)
        ]
        self._rng = np.random.default_rng(seed + 777)

    def __len__(self):
        return len(self.pairs) * self.samples_per_volume

    def normalize(self, img: np.ndarray) -> np.ndarray:
        if self.norm == "min-max":
            return 2 * (((img - img.min()) / (img.max() - img.min())) - 0.5)
        return (img - self.config.data.mean) / self.config.data.std

    def __getitem__(self, idx: int):
        hr, lr = self.pairs[idx % len(self.pairs)]
        p = self.patch_size
        high = hr.shape[0] - p + 1  # inclusive crop-origin range
        total = p ** 3
        best, best_nz = None, -1.0
        for _ in range(64):
            r = self._rng.integers(0, high, size=3)
            lr_patch = lr[r[0]:r[0] + p, r[1]:r[1] + p, r[2]:r[2] + p]
            nz = np.count_nonzero(lr_patch) / total
            if nz >= self.ratio:
                best = r
                break
            if nz > best_nz:
                best_nz, best = nz, r
        r = best
        lr_patch = lr[r[0]:r[0] + p, r[1]:r[1] + p, r[2]:r[2] + p]
        hr_patch = hr[r[0]:r[0] + p, r[1]:r[1] + p, r[2]:r[2] + p]
        return (
            self.normalize(hr_patch)[..., None].astype(np.float32),
            self.normalize(lr_patch)[..., None].astype(np.float32),
        )
