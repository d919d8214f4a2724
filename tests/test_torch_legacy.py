"""The port's ``data/legacy.py`` (``IQTDataset``, ``TextCollator``,
``ImageFolderDataset``) held item for item against
``diffusioniqt_tpu/data/legacy.py`` on the same seeds and files."""

import numpy as np
import pytest
import torch

from diffusioniqt_tpu.data import legacy as jl
from diffusioniqt_tpu_torch.data import legacy as tl

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 7])
def test_fake_iqt_dataset_equal(seed):
    """The fake pairs: the same numpy draws, item after item (exact)."""
    a = tl.IQTDataset(fake=True, size=8, length=3, seed=seed)
    b = jl.IQTDataset(fake=True, size=8, length=3, seed=seed)
    assert len(a) == len(b) == 3
    for i in range(3):
        (ha, la), (hb, lb) = a[i], b[i]
        assert ha.shape == (8, 8, 8, 1) and ha.dtype == np.float32
        np.testing.assert_array_equal(ha, hb)
        np.testing.assert_array_equal(la, lb)


def test_file_iqt_dataset_equal(tmp_path):
    """Volumes from ``.npy`` files: equal, exactly, with a channel axis."""
    rng = np.random.default_rng(3)
    hr, lr = [], []
    for i in range(2):
        for name, files in (("hr", hr), ("lr", lr)):
            path = str(tmp_path / f"{name}{i}.npy")
            np.save(path, rng.standard_normal((6, 5, 4)).astype(np.float32))
            files.append(path)
    a, b = tl.IQTDataset(hr, lr), jl.IQTDataset(hr, lr)
    assert len(a) == len(b) == 2
    for i in range(2):
        for x, y in zip(a[i], b[i]):
            assert x.shape == (6, 5, 4, 1)
            np.testing.assert_array_equal(x, y)


def test_text_collator_equal():
    """Images stacked, captions embedded by the hash stand-in (bit for bit
    the JAX one's), None items dropped."""
    batch = [(np.zeros((8, 8, 3)), "hello"), None, (np.ones((8, 8, 3)), "brain mri scan")]
    got = tl.TextCollator(image_size=8, embed_dim=16, max_length=4)(batch)
    want = jl.TextCollator(image_size=8, embed_dim=16, max_length=4)(batch)
    assert [g.shape for g in got] == [(2, 8, 8, 3), (2, 4, 16), (2, 4)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_image_folder_dataset_equal(tmp_path):
    """Images in name order, resized like ``jax.image.resize(...,
    "bilinear")``: one at the size, one downsampled 20 -> 8 (antialiased),
    one upsampled 5 -> 8 with 3 channels, one wide 12 x 8; within 1e-5 of
    the largest entry (the weights' fp32 products)."""
    rng = np.random.default_rng(5)
    shapes = {"a.npy": (8, 8), "b.npy": (20, 20), "c.npy": (5, 5, 3), "d.npy": (12, 8)}
    for name, shape in shapes.items():
        np.save(str(tmp_path / name), rng.standard_normal(shape).astype(np.float32))
    (tmp_path / "notes.txt").write_text("not an image")
    a, b = tl.ImageFolderDataset(str(tmp_path), 8), jl.ImageFolderDataset(str(tmp_path), 8)
    assert len(a) == len(b) == 4
    for i in range(4):
        x, y = a[i], b[i]
        assert x.shape == y.shape and x.shape[:2] == (8, 8) and x.dtype == np.float32
        np.testing.assert_allclose(x, y, rtol=0, atol=1e-5 * float(np.abs(y).max()))
    # the downsampled image is antialiased: not the plain two-tap bilinear
    plain = torch.nn.functional.interpolate(
        torch.from_numpy(np.load(str(tmp_path / "b.npy")))[None, None], size=(8, 8),
        mode="bilinear", align_corners=False)[0, 0].numpy()
    assert np.abs(a[1][..., 0] - plain).max() > 1e-2
