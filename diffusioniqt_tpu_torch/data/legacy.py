"""Upstream-style datasets kept for capability parity (counterpart of
``diffusioniqt_tpu/data/legacy.py``; reference ``data.py:206-364``:
``IQTDataset``, the text ``Collator`` and the image-folder ``Dataset``).
The IQT training path never uses them; they serve the text-conditional and
2D-image workflows of a user migrating from the reference.

Host-side numpy, as the JAX module is: items and batches are numpy arrays,
channels last. Volumes load through :func:`data.datasets.load_volume`;
captions embed through :func:`utils.t5.hash_text_encode` unless an
``encode_fn`` is given; 2D images resize through :func:`ops.volume.resize`,
which follows ``jax.image.resize`` (antialiased when it downsamples).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

import numpy as np
import torch

from diffusioniqt_tpu_torch.data.datasets import load_volume
from diffusioniqt_tpu_torch.ops.volume import resize
from diffusioniqt_tpu_torch.utils.t5 import hash_text_encode


class IQTDataset:
    """Paired-volume dataset with a ``fake`` smoke mode (reference
    data.py:206-262: ``IQTDataset(fake=True)`` yields random pairs of
    ``size``^3, drawn from ``numpy.random.default_rng(seed)`` in item
    order)."""

    def __init__(self, hr_files: Sequence[str] = (), lr_files: Sequence[str] = (),
                 fake: bool = False, size: int = 32, length: int = 8, seed: int = 0):
        self.fake = fake
        self.hr_files = list(hr_files)
        self.lr_files = list(lr_files)
        self.size = size
        self.length = length if fake else len(self.hr_files)
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return self.length

    def __getitem__(self, idx: int):
        if self.fake:
            s = self.size
            hr = self.rng.standard_normal((s, s, s, 1)).astype(np.float32)
            lr = self.rng.standard_normal((s, s, s, 1)).astype(np.float32)
            return hr, lr
        hr = load_volume(self.hr_files[idx])[..., None].astype(np.float32)
        lr = load_volume(self.lr_files[idx])[..., None].astype(np.float32)
        return hr, lr


class TextCollator:
    """Batch images with encoded captions (reference ``Collator``,
    data.py:264-317, without the URL fetching). ``encode_fn(texts)``
    returns ``(embeds, mask)``; the default is the hash stand-in at
    ``embed_dim`` x ``max_length`` (pass a wrapper of
    ``utils.t5.t5_encode_text`` where T5 weights are available). Items that
    are None are dropped."""

    def __init__(self, image_size: int, encode_fn=None, channels: int = 3,
                 max_length: int = 16, embed_dim: int = 768):
        self.image_size = image_size
        self.channels = channels
        self.max_length = max_length
        self.embed_dim = embed_dim
        self.encode_fn = encode_fn or (
            lambda texts: hash_text_encode(texts, dim=embed_dim, max_length=max_length,
                                           return_attn_mask=True))

    def __call__(self, batch: List[Tuple[np.ndarray, str]]):
        images, texts = zip(*[item for item in batch if item is not None])
        embeds, masks = self.encode_fn(list(texts))
        return (np.stack([np.asarray(im, np.float32) for im in images]),
                np.asarray(embeds, np.float32), np.asarray(masks, bool))


class ImageFolderDataset:
    """Image-folder dataset for the 2D model (reference ``Dataset``,
    data.py:319-364): the folder's ``.npy`` 2D arrays in name order, each
    ``(H, W)`` or ``(H, W, C)``, resized to ``image_size`` x ``image_size``
    with ``jax.image.resize``'s bilinear weights where it differs."""

    EXTS = (".npy",)

    def __init__(self, folder: str, image_size: int):
        self.folder = folder
        self.image_size = image_size
        self.paths = sorted(os.path.join(folder, f) for f in os.listdir(folder)
                            if f.endswith(self.EXTS))

    def __len__(self):
        return len(self.paths)

    def __getitem__(self, idx: int) -> np.ndarray:
        img = np.load(self.paths[idx]).astype(np.float32)
        if img.ndim == 2:
            img = img[..., None]
        s = self.image_size
        if img.shape[0] != s or img.shape[1] != s:
            img = resize(torch.from_numpy(img), (s, s, img.shape[-1]), "linear").numpy()
        return img
