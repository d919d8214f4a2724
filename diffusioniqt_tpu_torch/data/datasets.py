"""Volume IO, the training datasets and sliding-window inference patches
(copied from ``diffusioniqt_tpu/data/datasets.py``: ``load_volume``,
``load_affine``, ``save_volume``, ``SupervisedIQT`` (paired LR/HR random
crops, seeded per ``(seed, epoch, idx)``), ``SupervisedIQTInference`` with
``valid_indices``, and ``FakeIQTDataset``; ``tests/test_torch_data.py`` and
``tests/test_torch_stitch_device.py`` hold them equal). Items are numpy,
channels-last ``(X, Y, Z, 1)``; ``data/loader.py`` batches them.

nibabel is optional: without it NIfTI goes through ``data/nifti.py``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

try:  # optional
    import nibabel as _nib
except ImportError:  # pragma: no cover
    _nib = None


def load_volume(path: str) -> np.ndarray:
    """Load a 3D volume from .nii/.nii.gz or .npy.

    NIfTI goes through nibabel when installed, else the self-contained
    NIfTI-1 reader (data/nifti.py) — the pipeline has no hard IO deps."""
    if path.endswith(".npy"):
        return np.load(path).astype(np.float32)
    if _nib is not None:
        return _nib.load(path).get_fdata().astype(np.float32)
    from diffusioniqt_tpu_torch.data import nifti

    return nifti.read(path)[0]


def load_affine(path: str):
    if path.endswith(".npy"):
        return np.eye(4, dtype=np.float32)
    if _nib is not None:
        return _nib.load(path).affine
    from diffusioniqt_tpu_torch.data import nifti

    return nifti.read(path)[1]


def save_volume(path: str, data: np.ndarray, affine=None):
    if path.endswith(".npy"):
        np.save(path, data)
        return
    if _nib is not None:
        img = _nib.Nifti1Image(data, np.eye(4) if affine is None else affine)
        _nib.save(img, path)
        return
    from diffusioniqt_tpu_torch.data import nifti

    nifti.write(path, data, affine)


class SupervisedIQT:
    """Paired LR/HR patch dataset (reference ``supervisedIQT``)."""

    def __init__(self, config, lr_files: Sequence[str], hr_files: Sequence[str],
                 train: bool = True, max_retries: int = 100,
                 volume_size: int = 256, seed: int = 0):
        self.config = config
        self.seed = seed
        self.files_lr = list(lr_files)
        self.files_hr = list(hr_files)
        self.mean_lr = config.data.mean
        self.std_lr = config.data.std
        self.norm = config.data.norm
        self.patch_size = config.train.patch_size
        self.train = train
        self.ratio = 0.2 if train else 0.8  # reference data.py:64-67
        self.max_retries = max_retries
        self.volume_size = volume_size
        self._epoch = 0
        self._cache: dict = {}

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.files_lr)

    def normalize(self, img: np.ndarray) -> np.ndarray:
        if self.norm == "min-max":
            return 2 * (((img - img.min()) / (img.max() - img.min())) - 0.5)
        return (img - self.mean_lr) / self.std_lr

    def _load_pair(self, idx: int) -> Tuple[np.ndarray, np.ndarray]:
        if idx in self._cache:
            return self._cache[idx]
        lr_path = self.files_lr[idx]
        # reference derives the HR path by filename substitution (data.py:99)
        hr_path = (
            self.files_hr[idx]
            if idx < len(self.files_hr)
            else lr_path.replace("lr_norm", self.config.data.groundtruth_fname)
        )
        lr = load_volume(lr_path)
        hr = load_volume(hr_path)
        s = self.volume_size
        for name, vol in (("lr", lr), ("hr", hr)):
            if vol.shape != (s, s, s):
                raise ValueError(f"{name} must be {s}^3 but got {vol.shape}")
        if len(self._cache) < 4:  # small LRU-ish cache for worker reuse
            self._cache[idx] = (lr, hr)
        return lr, hr

    def __getitem__(self, idx: int):
        lr, hr = self._load_pair(idx)
        p = self.patch_size
        high = lr.shape[0] - p
        # deterministic per (seed, epoch, idx): crop positions are
        # reproducible, thread-safe (no shared global np.random stream —
        # a prefetch worker and the main thread would race it), and
        # identical across multi-host processes (every process must see
        # the same global batch; the DataLoader advances the epoch each
        # pass so crops still vary over training)
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self._epoch, idx])
        )
        total_voxel = p ** 3
        best = None
        best_nz = -1.0
        for _ in range(self.max_retries):
            r = rng.integers(0, high, size=3)
            lr_patch = lr[r[0]:r[0] + p, r[1]:r[1] + p, r[2]:r[2] + p]
            nz = np.count_nonzero(lr_patch) / total_voxel
            if nz >= self.ratio:
                hr_patch = hr[r[0]:r[0] + p, r[1]:r[1] + p, r[2]:r[2] + p]
                best = (lr_patch, hr_patch)
                break
            # track the highest-occupancy below-threshold candidate so the
            # bounded-retry fallback matches the reference's retry-forever
            # distribution as closely as possible (data.py:125-126)
            if nz > best_nz:
                best_nz = nz
                best = (
                    lr_patch,
                    hr[r[0]:r[0] + p, r[1]:r[1] + p, r[2]:r[2] + p],
                )
        lr_patch, hr_patch = best
        lr_patch = self.normalize(lr_patch)[..., None]
        hr_patch = self.normalize(hr_patch)[..., None]
        return hr_patch.astype(np.float32), lr_patch.astype(np.float32)


class SupervisedIQTInference:
    """Sliding-window inference patches over one LR volume (reference
    ``supervisedIQT_INF``). Yields ``(patch, index_xyz)`` or None for
    sub-5%-brain patches."""

    def __init__(self, config, lr_file: str, ratio: float = 0.05,
                 volume: Optional[np.ndarray] = None):
        self.config = config
        self.mean_lr = config.data.mean
        self.std_lr = config.data.std
        self.patch_size = config.train.patch_size
        self.overlap = config.eval.overlap
        self.ratio = ratio
        self.total_voxel = self.patch_size ** 3

        self.lr_data = volume if volume is not None else load_volume(lr_file)
        self.lr_idx: List[List[int]] = []
        p, o = self.patch_size, self.overlap
        for i in range(0, self.lr_data.shape[0] - p + 1, o):
            for j in range(0, self.lr_data.shape[1] - p + 1, o):
                for k in range(0, self.lr_data.shape[2] - p + 1, o):
                    self.lr_idx.append([i, j, k])

    def __len__(self):
        return len(self.lr_idx)

    def normalize(self, img: np.ndarray) -> np.ndarray:
        return (img - self.mean_lr) / self.std_lr

    def __getitem__(self, idx: int):
        i, j, k = self.lr_idx[idx]
        p = self.patch_size
        patch = self.lr_data[i:i + p, j:j + p, k:k + p].astype(np.float32)
        if np.count_nonzero(patch) / self.total_voxel < self.ratio:
            return None
        patch = self.normalize(patch)[..., None]
        return patch, np.asarray([i, j, k], np.int32)

    def valid_indices(self) -> np.ndarray:
        """(N, 3) start indices of windows that pass the >=5%-content
        filter — the device-resident inference path gathers these windows
        on-device instead of materialising host patches."""
        p = self.patch_size
        keep = []
        for i, j, k in self.lr_idx:
            patch = self.lr_data[i:i + p, j:j + p, k:k + p]
            if np.count_nonzero(patch) / self.total_voxel >= self.ratio:
                keep.append([i, j, k])
        return np.asarray(keep, np.int32).reshape(-1, 3)


class FakeIQTDataset:
    """Random-noise LR/HR pairs for smoke tests (reference
    ``IQTDataset(fake=True)``, data.py:243-261)."""

    def __init__(self, size: int = 32, length: int = 16, seed: int = 0,
                 correlated: bool = True):
        self.size = size
        self.length = length
        self.rng = np.random.default_rng(seed)
        self.correlated = correlated

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        s = self.size
        hr = self.rng.standard_normal((s, s, s, 1)).astype(np.float32)
        if self.correlated:
            lr = hr + 0.1 * self.rng.standard_normal((s, s, s, 1)).astype(np.float32)
        else:
            lr = self.rng.standard_normal((s, s, s, 1)).astype(np.float32)
        return hr, lr
