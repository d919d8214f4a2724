"""The port's 2D-slice quality run (``diffusioniqt_tpu_torch/quality_run_2d.py``)
against the JAX tool it ports (``tools/quality_run_2d.py``): its copy of
``SliceIQTDataset`` item for item, and ``--quick --device cpu`` through
training, a resume and the evaluation, writing the JAX tool's report keys."""

import importlib.util
import json
import os

import numpy as np
import torch

from diffusioniqt_tpu_torch import quality_run_2d

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_quality_run_2d_quick_on_the_cpu(tmp_path):
    """``--quick --device cpu``: 6 training steps, the bundle, a resume for
    6 more, an ``--eval-only`` of the resumed bundle giving the same scores
    as the run that wrote it, and the JAX tool's report keys."""
    out = tmp_path / "q2d"
    first = quality_run_2d.main(["--quick", "--device", "cpu", "--out", str(out)])
    jax_keys = {"steps", "final_loss_mean_50", "first_loss_mean_50", "eval_slices",
                "sample_seconds", "pred_msssim", "pred_psnr", "lr_msssim", "lr_psnr",
                "pred_beats_lr_msssim", "pred_beats_lr_psnr", "config"}
    written = json.loads((out / "quality_eval_2d.json").read_text())
    assert jax_keys <= set(written) and written["bundle_steps"] == 6
    assert all(np.isfinite(written[k]) for k in ("pred_msssim", "pred_psnr", "lr_msssim",
                                                 "lr_psnr", "final_loss_mean_50"))
    ckpt = str(out / "ckpt.pt")
    resumed = quality_run_2d.main(["--quick", "--device", "cpu", "--out", str(out),
                                   "--resume", ckpt])
    assert resumed["bundle_steps"] == 12
    lines = (out / "train_loss.csv").read_text().splitlines()
    assert lines[0] == "step,loss,seconds" and len(lines) == 1 + 2 * 6
    again = quality_run_2d.main(["--quick", "--device", "cpu", "--out", str(out),
                                 "--resume", ckpt, "--eval-only"])
    assert again["steps"] == 0 and again["bundle_steps"] == 12
    for k in ("pred_msssim", "pred_psnr", "lr_msssim", "lr_psnr"):
        assert again[k] == resumed[k]
    assert first["lr_msssim"] == resumed["lr_msssim"]  # the same held-out slices


def test_slice_dataset_matches_jax_tool():
    """The port's copy of ``SliceIQTDataset``: the same foreground slices
    and the same crops, item for item."""
    before = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "jax_quality_run_2d", os.path.join(ROOT, "tools", "quality_run_2d.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for k in set(os.environ) - set(before):
        del os.environ[k]
    pairs = [quality_run_2d.generate_pair(48, seed=i) for i in range(2)]
    mean, std = 100.0, 50.0
    want = module.SliceIQTDataset(pairs, mean, std, crop=16, seed=3)
    got = quality_run_2d.SliceIQTDataset(pairs, mean, std, crop=16, seed=3)
    assert len(got) == len(want)
    for i in range(5):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
