"""The port's device-resident stitch (diffusioniqt_tpu_torch/ops/stitch_device.py)
and ``SupervisedIQTInference.valid_indices`` against the port's host
``VolumeStitcher`` and the JAX package's ``DeviceVolumeStitcher`` on the CPU:
a 64^3 volume, 32^3 windows at overlaps 16 and 32, the last batch ragged."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.config import load_config as j_load_config
from diffusioniqt_tpu.data.datasets import SupervisedIQTInference as JInference
from diffusioniqt_tpu.ops.stitch_device import DeviceVolumeStitcher as JDeviceStitcher
from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.data.datasets import SupervisedIQTInference
from diffusioniqt_tpu_torch.data.stitching import VolumeStitcher, sliding_window_grid
from diffusioniqt_tpu_torch.ops.stitch_device import DeviceVolumeStitcher, gather_windows

torch.set_num_threads(1)

EDGE, PATCH, BATCH = 64, 32, 5


def test_gather_windows_matches_numpy_slices():
    vol = np.random.default_rng(0).standard_normal((EDGE, 40, 48)).astype(np.float32)
    starts = np.asarray([[0, 0, 0], [32, 8, 16], [16, 8, 0]], np.int32)
    got = gather_windows(torch.from_numpy(vol), starts, PATCH)
    assert got.shape == (3, PATCH, PATCH, PATCH, 1)
    for g, (i, j, k) in enumerate(starts):
        np.testing.assert_array_equal(got[g, ..., 0].numpy(),
                                      vol[i:i + PATCH, j:j + PATCH, k:k + PATCH])


@pytest.mark.parametrize("overlap", [16, 32])
@pytest.mark.parametrize("mode", ["trim", "gaussian"])
def test_device_stitcher_matches_host_and_jax(mode, overlap):
    starts = sliding_window_grid((EDGE,) * 3, PATCH, overlap)
    preds = np.random.default_rng(overlap).standard_normal(
        (len(starts), PATCH, PATCH, PATCH)).astype(np.float32)
    host = VolumeStitcher((EDGE,) * 3, PATCH, overlap, mode=mode, fill_value=-0.7)
    for p, idx in zip(preds, starts):
        host.add(p, idx)
    dev = DeviceVolumeStitcher((EDGE,) * 3, PATCH, overlap, mode=mode, fill_value=-0.7)
    jdev = JDeviceStitcher((EDGE,) * 3, PATCH, overlap, mode=mode, fill_value=-0.7)
    for b in range(0, len(starts), BATCH):
        # the last batch is ragged: pad it to BATCH rows that `valid` drops
        n = len(starts[b:b + BATCH])
        rows = np.arange(b, b + BATCH) % len(starts)
        outs, idx = preds[rows] + 100.0 * (np.arange(BATCH) >= n)[:, None, None, None], starts[rows]
        valid = np.arange(BATCH) < n
        dev.add_batch(torch.from_numpy(outs), idx, valid)
        jdev.add_batch(jnp.asarray(outs), jnp.asarray(idx), jnp.asarray(valid))
    assert len(starts) % BATCH != 0
    mask = np.zeros((EDGE,) * 3, bool)
    mask[:3] = True
    got = dev.result(background_mask=mask, background_value=-2.0)
    want = host.result(background_mask=mask, background_value=-2.0)
    if mode == "trim":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, jdev.result(background_mask=mask, background_value=-2.0),
                               rtol=0, atol=1e-6)


def test_valid_indices_match_jax():
    rng = np.random.default_rng(1)
    vol = np.abs(rng.standard_normal((EDGE, EDGE, EDGE))).astype(np.float32)
    vol[:40, :40] = 0.0  # windows here fall under the 5% content floor
    cfg, jcfg = load_config("config/eval_config.yaml"), j_load_config("config/eval_config.yaml")
    for c in (cfg, jcfg):
        c.train.patch_size_sub, c.eval.overlap = 8, 16
    got = SupervisedIQTInference(cfg, None, volume=vol).valid_indices()
    want = JInference(jcfg, None, volume=vol).valid_indices()
    assert got.dtype == np.int32 and 0 < len(got) < len(sliding_window_grid(vol.shape, 24, 16))
    np.testing.assert_array_equal(got, want)
