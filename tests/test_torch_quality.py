"""The port's quality gate (``quality_run`` / ``quality_eval``) against the
JAX tools it ports (``tools/quality_run.py``, ``tools/quality_eval.py``):
the same config, phantoms, stats, border rule, background mask and report
keys; the held-out LR baseline's metrics at the gate's 192^3; and one tiny
end-to-end run on the CPU (dim 8: two steps, a resume for one more, an
evaluation of the bundle)."""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from diffusioniqt_tpu.data import synthetic as jsyn
from diffusioniqt_tpu_torch import quality_eval, quality_run

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys tools/quality_run.py writes to quality.json, and those of each
# held-out volume's row
JAX_SUMMARY_KEYS = {"sampler", "steps", "final_loss_mean_100", "first_loss_mean_100",
                    "volumes", "pred_beats_lr_msssim", "pred_beats_lr_psnr", "config"}
JAX_ROW_KEYS = {"volume", "pred_msssim", "pred_psnr", "lr_msssim", "lr_psnr", "seconds"}
JAX_EVAL_KEYS = {"ckpt", "steps", "stitch", "sampler", "edm_s_churn", "edm_sigma_data",
                 "volumes", "pred_beats_lr_msssim", "pred_beats_lr_psnr"}


@pytest.fixture(scope="module")
def jax_tool():
    """``tools/quality_run.py``, imported in the test only (the port never
    imports it); its import-time environment defaults are undone."""
    before = dict(os.environ)
    spec = importlib.util.spec_from_file_location(
        "jax_quality_run", os.path.join(ROOT, "tools", "quality_run.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key in set(os.environ) - set(before):
        del os.environ[key]
    return module


@pytest.mark.parametrize("quick", [False, True])
@pytest.mark.parametrize("elucidated", [False, True])
def test_flagship_cfg_matches_jax(jax_tool, quick, elucidated):
    want = jax_tool.flagship_cfg(quick=quick, elucidated=elucidated)
    got = quality_run.flagship_cfg(quick, elucidated, device="cpu")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.train.compute_dtype == "float32"
    assert quality_run.flagship_cfg(quick, elucidated, "cuda").train.compute_dtype == "bfloat16"


def test_phantoms_stats_border_and_mask_match_jax(tmp_path):
    size, volumes = 32, 2
    pairs = quality_run.training_pairs(size, volumes)
    for i, (hr, lr) in enumerate(pairs):  # training seeds 0 .. volumes - 1
        jhr, jlr = jsyn.generate_pair(size, seed=i)
        np.testing.assert_array_equal(hr, jhr)
        np.testing.assert_array_equal(lr, jlr)
    # held-out seeds 10_000 + i (tools/quality_run.py:237)
    assert quality_run.HELDOUT_SEED == 10_000
    mean, std = jsyn.population_stats([lr for _, lr in pairs])
    row = quality_run.write_stats(str(tmp_path), mean, std, size, volumes, 1.0)
    with open(tmp_path / "stats.json") as fh:
        assert json.load(fh) == row == {"mean": mean, "std": std, "size": size,
                                        "volumes": volumes, "edm_sigma_data": 1.0}
    quality_run.write_stats(str(tmp_path), mean, std, size, volumes)
    with open(tmp_path / "stats.json") as fh:
        assert "edm_sigma_data" not in json.load(fh)
    for edge in (32, 96, 97, 128, 192, 240):  # tools/quality_run.py:268
        assert quality_run.metric_border(edge) == min(32, (edge - 1) // 3)
    lr_n = np.random.default_rng(0).standard_normal((8, 8, 8)).astype(np.float32)
    lr_n[:2] = -3.0
    pred = np.random.default_rng(1).standard_normal((8, 8, 8)).astype(np.float32)
    want = pred.copy()
    want[lr_n == lr_n.min()] = lr_n.min()  # tools/quality_run.py:264-266
    np.testing.assert_array_equal(quality_run.mask_background(pred, lr_n), want)


def test_quick_run_resume_and_eval_on_cpu(tmp_path, monkeypatch):
    """``--quick --device cpu`` at dim 8: two steps, then a resume for one
    more (the CSV grows, the steps continue, quality.json has the JAX
    tool's keys), then ``quality_eval`` of the bundle, which reads
    ``edm_sigma_data`` back from ``stats.json``."""
    quick_cfg = quality_run.flagship_cfg

    def dim8(*args, **kwargs):
        cfg = quick_cfg(*args, **kwargs)
        cfg.train.dim = cfg.train.init_dim = 8
        return cfg

    monkeypatch.setattr(quality_run, "flagship_cfg", dim8)
    out = str(tmp_path / "q")
    common = ["--quick", "--elucidated", "--sigma-data", "1.0", "--device", "cpu",
              "--out", out]
    assert quality_run.main(common + ["--steps", "2", "--eval-volumes", "0"]) is None
    with open(os.path.join(out, "train_loss.csv")) as fh:
        first = fh.read().splitlines()
    assert first[0] == "step,loss,seconds" and [r.split(",")[0] for r in first[1:]] == ["1", "2"]
    bundle = torch.load(os.path.join(out, "ckpt.pt"), map_location="cpu", weights_only=True)
    assert [int(s) for s in bundle["steps"]] == [0, 2]

    summary = quality_run.main(common + ["--steps", "1", "--edm-steps", "2",
                                         "--resume", os.path.join(out, "ckpt.pt")])
    with open(os.path.join(out, "train_loss.csv")) as fh:
        rows = fh.read().splitlines()
    assert rows[:3] == first and rows[3].split(",")[0] == "3"
    losses = [float(r.split(",")[1]) for r in rows[1:]]
    assert all(np.isfinite(losses))
    with open(os.path.join(out, "quality.json")) as fh:
        written = json.load(fh)
    assert written == json.loads(json.dumps(summary))
    assert JAX_SUMMARY_KEYS <= set(written)
    assert written["steps"] == written["steps_planned"] == 3
    assert written["sampler"] == "edm-heun-2"
    assert written["first_loss_mean_100"] == pytest.approx(np.mean(losses), rel=1e-5)
    assert written["config"]["edm_sigma_data"] == 1.0
    assert written["device"] == {"name": "cpu", "power_limit": None}
    assert len(written["volumes"]) == 1 and set(written["volumes"][0]) == JAX_ROW_KEYS
    assert np.isfinite(written["volumes"][0]["pred_psnr"])

    ev = quality_eval.main(["--ckpt", os.path.join(out, "ckpt.pt"), "--quick", "--elucidated",
                            "--device", "cpu", "--size", "96", "--eval-volumes", "1",
                            "--edm-steps", "2", "--patch-batch", "1", "--out", out,
                            "--suffix", "cpu"])
    with open(os.path.join(out, "quality_eval_cpu.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(ev))
    assert JAX_EVAL_KEYS <= set(ev)
    assert ev["edm_sigma_data"] == 1.0  # from stats.json
    assert ev["steps"] == [0, 3] and ev["sampler"] == "edm-heun-2"
    assert set(ev["volumes"][0]) == JAX_ROW_KEYS | {"stitch"}
    # the same EMA weights, noise seed and sampler give the same prediction
    assert ev["volumes"][0]["pred_psnr"] == pytest.approx(written["volumes"][0]["pred_psnr"],
                                                          rel=1e-5)


def test_heldout_lr_baseline_matches_jax_at_gate_size():
    """The gate's LR baseline: held-out phantom 0 at 192^3, z-scored with
    the stats of the recorded card run (``results/quality_edm_torch``), its
    centre-cropped MS-SSIM / PSNR against the HR phantom by the port's
    ``evaluate`` and by ``test_all.evaluate``, both at fp32 on the CPU."""
    from test_all import evaluate as jax_evaluate

    from diffusioniqt_tpu_torch.evaluate import evaluate

    with open(os.path.join(ROOT, "results", "quality_edm_torch", "stats.json")) as fh:
        stats = json.load(fh)
    size = stats["size"]
    hr, lr = quality_run.generate_pair(size, seed=quality_run.HELDOUT_SEED)
    hr_n, lr_n = ((v - stats["mean"]) / stats["std"] for v in (hr, lr))
    border = quality_run.metric_border(size)
    got = evaluate(lr_n, hr_n, border=border, device="cpu")
    want = jax_evaluate(lr_n, hr_n, border=border)
    for key in ("msssim", "psnr"):
        assert got[key] == pytest.approx(float(want[key]), rel=1e-5), key
