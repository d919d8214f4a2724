"""The port's copies of the host data path (stitching, sliding-window
inference patches, volume IO, NIfTI, the training datasets, the synthetic
phantoms, the loader) held equal to the JAX package's, and one CPU run of
the training entry point."""

import os

import numpy as np
import pytest
import torch
import yaml

from diffusioniqt_tpu.config import Config as JConfig
from diffusioniqt_tpu.data import datasets as jd
from diffusioniqt_tpu.data import loader as jl
from diffusioniqt_tpu.data import nifti as jn
from diffusioniqt_tpu.data import stitching as js
from diffusioniqt_tpu.data import synthetic as jsyn
from diffusioniqt_tpu_torch.config import Config as TConfig
from diffusioniqt_tpu_torch.data import datasets as td
from diffusioniqt_tpu_torch.data import loader as tl
from diffusioniqt_tpu_torch.data import nifti as tn
from diffusioniqt_tpu_torch.data import stitching as ts
from diffusioniqt_tpu_torch.data import synthetic as tsyn

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


def _assert_items_equal(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_synthetic_phantoms_equal():
    """generate_pair, population_stats and SyntheticIQTDataset's crops equal
    the JAX module's bit for bit."""
    for seed in (0, 3):
        for a, b in zip(tsyn.generate_pair(24, seed=seed), jsyn.generate_pair(24, seed=seed)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    vols = [tsyn.generate_pair(16, seed=s)[1] for s in (1, 2)]
    assert tsyn.population_stats(vols) == jsyn.population_stats(vols)
    a = tsyn.SyntheticIQTDataset(_cfg(TConfig), n_volumes=2, size=24, seed=1, samples_per_volume=3)
    b = jsyn.SyntheticIQTDataset(_cfg(JConfig), n_volumes=2, size=24, seed=1, samples_per_volume=3)
    assert len(a) == len(b) == 6
    for i in (0, 5, 2, 2):
        _assert_items_equal(a[i], b[i])


@pytest.mark.parametrize("train", [True, False])
def test_supervised_iqt_equal(tmp_path, train):
    """Paired random crops seeded per (seed, epoch, idx) from .npy volumes."""
    rng = np.random.default_rng(4)
    lr_files, hr_files = [], []
    for i in range(2):
        vol = np.abs(rng.standard_normal((16, 16, 16))).astype(np.float32) * 300
        vol[:6] = 0.0  # background the rejection sampling has to avoid
        for name, v, files in (("lr_norm", vol, lr_files), ("hr", vol * 1.1, hr_files)):
            path = str(tmp_path / f"{name}{i}.npy")
            np.save(path, v)
            files.append(path)
    kw = dict(train=train, volume_size=16, seed=2)
    a = td.SupervisedIQT(_cfg(TConfig), lr_files, hr_files, **kw)
    b = jd.SupervisedIQT(_cfg(JConfig), lr_files, hr_files, **kw)
    for epoch in (0, 3):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for i in range(len(a)):
            _assert_items_equal(a[i], b[i])
    with pytest.raises(ValueError, match="must be 8"):
        td.SupervisedIQT(_cfg(TConfig), lr_files, hr_files, volume_size=8)[0]


def test_fake_dataset_equal():
    a, b = td.FakeIQTDataset(size=6, length=5, seed=3), jd.FakeIQTDataset(size=6, length=5, seed=3)
    for i in (0, 1, 1, 4):
        _assert_items_equal(a[i], b[i])


class _Holes:
    """Items with Nones (rejected patches), as the reference's collate sees them."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i % 3 == 1:
            return None
        return (np.full((2, 2), i, np.float32), np.full((1,), -i, np.float32))


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_equal(prefetch):
    """Shuffled batches over two epochs, Nones dropped, an all-None batch
    skipped, with and without the prefetch thread."""
    kw = dict(batch_size=2, shuffle=True, seed=5, prefetch=prefetch)
    for ds in (_Holes(7), td.FakeIQTDataset(size=4, length=5, seed=1)):
        a = tl.DataLoader(ds, **kw)
        b = jl.DataLoader(ds if isinstance(ds, _Holes) else jd.FakeIQTDataset(4, 5, 1), **kw)
        assert len(a) == len(b)
        for _ in range(2):
            got, want = list(a), list(b)
            assert len(got) == len(want)
            for x, y in zip(got, want):
                _assert_items_equal(x, y)
    assert tl.collate_drop_none([None, None]) is None


def test_device_transfer_map_casts_and_copies():
    batch = (np.arange(6, dtype=np.float32).reshape(2, 3) / 7, np.ones((2, 1), np.float32))
    moved = tl.device_transfer_map("cpu", "bfloat16")(batch)
    for got, a in zip(moved, batch):
        assert got.dtype == torch.bfloat16 and got.device.type == "cpu"
        assert torch.equal(got, torch.from_numpy(a).to(torch.bfloat16))
    same = tl.device_transfer_map("cpu")(moved)
    assert all(x is y for x, y in zip(same, moved))  # already there: passed through
    with pytest.raises(ValueError, match="transfer dtype"):
        tl.device_transfer_map("cpu", "float7")


def test_train_entry_point_runs_on_cpu(tmp_path, monkeypatch):
    """``python -m diffusioniqt_tpu_torch.train --fake-data --device cpu
    --steps 2`` on a tiny EDM config: the CSVs, the .npy dumps and the two
    bundles, which infer serves (EMA weights); without --device cpu it
    refuses to run where CUDA is missing."""
    from diffusioniqt_tpu_torch import infer
    from diffusioniqt_tpu_torch.train import __main__ as train_main

    raw = yaml.safe_load(open("config/eval_edm.yaml"))
    raw["Train"].update(dim=8, init_dim=8, dim_mults=[1, 2], num_resnet_blocks=[1, 1],
                        resnet_groups=4, patch_size_sub=4, compute_dtype="float32",
                        att_enc=[False, False], pretrain=False, edm_num_sample_steps=2)
    raw["Eval"]["repeat"] = 1
    raw["Results"] = str(tmp_path / "results")
    cfg_path = tmp_path / "tiny.yaml"
    cfg_path.write_text(yaml.safe_dump(raw))
    torch.set_num_threads(1)
    train_main.main(["--config", str(cfg_path), "--fake-data", "--device", "cpu",
                     "--steps", "2", "--eval-every", "1"])
    project = tmp_path / "results" / raw["ProjectName"]
    losses = (project / "train_log" / "train_loss.csv").read_text().splitlines()
    assert losses[0] == "loss" and len(losses) == 3
    assert all(np.isfinite(float(v)) for v in losses[1:])
    valid = (project / "train_log" / "valid_loss.csv").read_text().splitlines()
    assert valid[0] == "loss,ssim,psnr" and len(valid) == 3
    dumps = sorted(os.listdir(project / "figures"))
    assert "conditional_iqt_0_pred.npy" in dumps and len(dumps) % 4 == 0
    assert np.load(project / "figures" / "conditional_iqt_0_pred.npy").shape[1:] == (4, 4, 4, 1)
    for name in ("checkpoint.pt", "last_checkpoint.pt"):
        sd = infer.load_unet_state_dict(str(project / "model" / name))
        assert "init_conv.weight" in sd
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main.main(["--config", str(cfg_path), "--fake-data", "--steps", "1"])
