"""Device-resident sliding-window stitching for full-volume inference
(counterpart of ``diffusioniqt_tpu/ops/stitch_device.py``).

Full-volume inference (``infer.py``) copies the normalised volume to the
device once, slices the windows out of it there (:func:`gather_windows`),
stitches the predictions into device buffers (:class:`DeviceVolumeStitcher`),
and ``result()`` makes the run's one device-to-host copy.

Both modes match the host ``VolumeStitcher`` (``data/stitching.py``), which
stays as the reference this is tested against:
  - ``trim``: each window's overlap-trimmed centre is written in the order
    the windows come (later windows win); faces on the volume border stay
    untrimmed (``data/stitching.py::trim_slices``);
  - ``gaussian``: Gaussian-weighted accumulation into ``(pred, weight)``
    with the host stitcher's window, normalised in ``result()``.

Window starts are host integers (they come from
``SupervisedIQTInference.valid_indices``), so every slice is a plain
tensor slice and nothing waits for the device. A ``valid`` mask drops the
padded rows of a ragged last batch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from diffusioniqt_tpu_torch.data.stitching import _gaussian_weight, trim_slices


def gather_windows(volume: torch.Tensor, starts, patch: int) -> torch.Tensor:
    """(G, patch, patch, patch, 1) windows of the (X, Y, Z) ``volume``, on
    its device and in its dtype; ``starts`` is (G, 3) integers."""
    return torch.stack([volume[i:i + patch, j:j + patch, k:k + patch]
                        for i, j, k in np.asarray(starts).tolist()])[..., None]


class DeviceVolumeStitcher:
    """Device-resident counterpart of ``data.stitching.VolumeStitcher``:
    the buffers live on ``device``, accumulate in fp32, and ``result()``
    returns the host volume."""

    def __init__(self, vol_shape: Sequence[int], patch_size: int, overlap: int,
                 mode: str = "trim", fill_value: float = 0.0, device="cpu"):
        if mode not in ("trim", "gaussian"):
            raise ValueError(f"unknown stitch mode {mode}")
        self.vol_shape = tuple(int(v) for v in vol_shape)
        self.patch_size = int(patch_size)
        self.overlap = int(overlap)
        self.mode = mode
        if mode == "gaussian":
            self.pred = torch.zeros(self.vol_shape, dtype=torch.float32, device=device)
            self.weight = torch.zeros_like(self.pred)
            self._w = torch.from_numpy(_gaussian_weight(self.patch_size)).to(device)
        else:
            self.pred = torch.full(self.vol_shape, fill_value, dtype=torch.float32,
                                   device=device)

    def add_batch(self, outs: torch.Tensor, starts, valid: Optional[Sequence[bool]] = None):
        """``outs``: (G, p, p, p) predictions on the device (any float
        dtype); ``starts``: (G, 3) integers; ``valid``: (G,) booleans, False
        for a padded row (default: every row is valid)."""
        p = self.patch_size
        starts = np.asarray(starts).tolist()
        valid = [True] * len(starts) if valid is None else [bool(v) for v in valid]
        outs = outs.float()
        for g, (index, keep) in enumerate(zip(starts, valid)):
            if not keep:
                continue
            if self.mode == "gaussian":
                dst = tuple(slice(s, s + p) for s in index)
                self.pred[dst] += outs[g] * self._w
                self.weight[dst] += self._w
            else:
                dst, src = trim_slices(index, self.vol_shape, p, self.overlap)
                self.pred[dst] = outs[g][src]

    def result(self, background_mask: Optional[np.ndarray] = None,
               background_value: float = 0.0) -> np.ndarray:
        """The stitched volume on the host (the run's one device-to-host
        copy); the host ``VolumeStitcher.result`` semantics."""
        if self.mode == "gaussian":
            out = torch.where(self.weight > 0,
                              self.pred / torch.clamp(self.weight, min=1e-8),
                              torch.full_like(self.pred, background_value))
        else:
            out = self.pred
        out = out.cpu().numpy().copy()
        if background_mask is not None:
            out[background_mask] = background_value
        return out
