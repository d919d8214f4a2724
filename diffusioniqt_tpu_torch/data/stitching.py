"""Whole-volume re-stitching of sliding-window predictions (a copy of
``diffusioniqt_tpu/data/stitching.py``, which the port cannot import
without importing JAX; ``tests/test_torch_data.py`` holds the two equal).

Re-design of the reference's inference stitcher (the in-line loop at
reference ``test.py:174-243`` / ``test_all.py:225-298``):

  * ``trim`` mode — write each patch's overlap-trimmed centre (overlap//2 off
    every interior face, untrimmed at volume borders), the reference's exact
    behavior
  * ``gaussian`` mode — accumulate Gaussian-weighted patches and normalise
    by the weight sum. Smoother seams at the same stride

Host-side numpy: assembly is IO-bound bookkeeping, not accelerator work.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def sliding_window_grid(vol_shape: Sequence[int], patch_size: int,
                        stride: int) -> np.ndarray:
    """All patch start indices (reference data.py:159-162)."""
    idx = []
    for i in range(0, vol_shape[0] - patch_size + 1, stride):
        for j in range(0, vol_shape[1] - patch_size + 1, stride):
            for k in range(0, vol_shape[2] - patch_size + 1, stride):
                idx.append([i, j, k])
    return np.asarray(idx, np.int32)


def _gaussian_weight(patch_size: int, sigma_frac: float = 0.125) -> np.ndarray:
    coords = np.arange(patch_size, dtype=np.float64) - (patch_size - 1) / 2.0
    sigma = patch_size * sigma_frac
    g = np.exp(-(coords ** 2) / (2 * sigma ** 2))
    w = g[:, None, None] * g[None, :, None] * g[None, None, :]
    return (w / w.max()).astype(np.float32)


def trim_slices(index: Sequence[int], vol_shape: Sequence[int], patch_size: int,
                overlap: int):
    """Trim mode's (volume, patch) slices of one window (reference
    test.py:184-243): ``overlap // 2`` off every interior face; faces on the
    volume border stay untrimmed; the whole window when ``overlap >=
    patch_size``. Shared by the host and the device stitcher."""
    p, op = patch_size, overlap // 2
    if overlap >= p:
        return tuple(slice(s, s + p) for s in index), (slice(None),) * 3
    lo = [0 if s == 0 else op for s in index]
    hi = [0 if s + p == edge else op for s, edge in zip(index, vol_shape)]
    dst = tuple(slice(s + a, s + p - b) for s, a, b in zip(index, lo, hi))
    src = tuple(slice(a, p - b) for a, b in zip(lo, hi))
    return dst, src


class VolumeStitcher:
    """Accumulates predicted patches into a full volume."""

    def __init__(self, vol_shape: Sequence[int], patch_size: int,
                 overlap: int, mode: str = "trim",
                 fill_value: float = 0.0):
        assert mode in ("trim", "gaussian")
        self.vol_shape = tuple(vol_shape)
        self.patch_size = patch_size
        self.overlap = overlap
        self.mode = mode
        self.pred = np.full(self.vol_shape, fill_value, np.float32)
        if mode == "gaussian":
            self.pred = np.zeros(self.vol_shape, np.float32)
            self.weight = np.zeros(self.vol_shape, np.float32)
            self._w = _gaussian_weight(patch_size)

    def add(self, patch: np.ndarray, index: Sequence[int]):
        """patch: (p, p, p) prediction; index: (i, j, k) volume start."""
        p = self.patch_size
        i, j, k = (int(v) for v in index)
        patch = np.asarray(patch, np.float32).reshape(p, p, p)

        if self.mode == "gaussian":
            self.pred[i:i + p, j:j + p, k:k + p] += patch * self._w
            self.weight[i:i + p, j:j + p, k:k + p] += self._w
            return

        dst, src = trim_slices((i, j, k), self.vol_shape, p, self.overlap)
        self.pred[dst] = patch[src]

    def result(self, background_mask: np.ndarray = None,
               background_value: float = 0.0) -> np.ndarray:
        """Final volume; optional background masking (reference
        test_all.py:300 sets non-brain voxels to the lowres min)."""
        if self.mode == "gaussian":
            out = np.where(self.weight > 0, self.pred / np.maximum(self.weight, 1e-8),
                           background_value)
        else:
            out = self.pred.copy()
        if background_mask is not None:
            out[background_mask] = background_value
        return out
