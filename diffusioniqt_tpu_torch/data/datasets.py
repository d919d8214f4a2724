"""Volume IO and sliding-window inference patches (copied from
``diffusioniqt_tpu/data/datasets.py``: ``load_volume``, ``load_affine``,
``save_volume`` and ``SupervisedIQTInference`` with ``valid_indices``;
``tests/test_torch_data.py`` and ``tests/test_torch_stitch_device.py`` hold
them equal). The training datasets are not ported yet.

nibabel is optional: without it NIfTI goes through ``data/nifti.py``.
"""

from __future__ import annotations

from typing import List, Optional

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
