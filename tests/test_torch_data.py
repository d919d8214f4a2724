"""The port's copies of the host data path (stitching, sliding-window
inference patches, volume IO, NIfTI) held equal to the JAX package's."""

import numpy as np
import pytest
import torch

from diffusioniqt_tpu.config import Config as JConfig
from diffusioniqt_tpu.data import datasets as jd
from diffusioniqt_tpu.data import nifti as jn
from diffusioniqt_tpu.data import stitching as js
from diffusioniqt_tpu_torch.config import Config as TConfig
from diffusioniqt_tpu_torch.data import datasets as td
from diffusioniqt_tpu_torch.data import nifti as tn
from diffusioniqt_tpu_torch.data import stitching as ts

torch.set_num_threads(1)


def test_sliding_window_grid_equal():
    for shape, p, stride in (((20, 24, 28), 12, 8), ((96, 96, 96), 96, 32)):
        np.testing.assert_array_equal(ts.sliding_window_grid(shape, p, stride),
                                      js.sliding_window_grid(shape, p, stride))


@pytest.mark.parametrize("mode", ["trim", "gaussian"])
def test_volume_stitcher_equal(mode):
    rng = np.random.default_rng(0)
    shape, p, overlap = (20, 20, 28), 12, 8
    a = ts.VolumeStitcher(shape, p, overlap, mode=mode, fill_value=-0.7)
    b = js.VolumeStitcher(shape, p, overlap, mode=mode, fill_value=-0.7)
    for idx in js.sliding_window_grid(shape, p, overlap):
        patch = rng.standard_normal((p, p, p)).astype(np.float32)
        a.add(patch, idx)
        b.add(patch, idx)
    mask = rng.random(shape) < 0.1
    np.testing.assert_array_equal(a.result(), b.result())
    np.testing.assert_array_equal(a.result(mask, -1.0), b.result(mask, -1.0))


def _cfg(klass):
    cfg = klass()
    cfg.train.batch_sample, cfg.train.patch_size_sub = True, 4
    cfg.eval.overlap = 8
    return cfg


def test_inference_dataset_equal():
    rng = np.random.default_rng(1)
    vol = np.abs(rng.standard_normal((28, 20, 20))).astype(np.float32) * 300
    vol[:12, :12, :12] = 0.0  # one window below the 5% content filter
    a = td.SupervisedIQTInference(_cfg(TConfig), lr_file=None, volume=vol)
    b = jd.SupervisedIQTInference(_cfg(JConfig), lr_file=None, volume=vol)
    assert len(a) == len(b) > 1
    for i in range(len(a)):
        ia, ib = a[i], b[i]
        assert (ia is None) == (ib is None)
        if ia is not None:
            np.testing.assert_array_equal(ia[0], ib[0])
            np.testing.assert_array_equal(ia[1], ib[1])
    assert any(a[i] is None for i in range(len(a)))


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_nifti_cross_read_write(tmp_path, suffix):
    rng = np.random.default_rng(2)
    data = rng.standard_normal((5, 6, 7)).astype(np.float32)
    affine = np.diag([1.5, 2.0, 2.5, 1.0])
    affine[:3, 3] = [3.0, -4.0, 5.0]
    for writer, reader in ((tn, jn), (jn, tn)):
        path = str(tmp_path / f"v_{writer.__name__.split('.')[0]}{suffix}")
        writer.write(path, data, affine)
        got, aff = reader.read(path)
        np.testing.assert_array_equal(got, data)
        np.testing.assert_allclose(aff, affine)
    pa, pb = str(tmp_path / f"a{suffix}"), str(tmp_path / f"b{suffix}")
    tn.write(pa, data, affine)
    jn.write(pb, data, affine)
    np.testing.assert_array_equal(tn.read(pa)[0], jn.read(pb)[0])


def test_volume_io_helpers(tmp_path):
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    for name in ("v.npy", "v.nii.gz"):
        path = str(tmp_path / name)
        td.save_volume(path, data, np.eye(4))
        np.testing.assert_array_equal(td.load_volume(path), jd.load_volume(path))
        np.testing.assert_allclose(td.load_affine(path), jd.load_affine(path))
