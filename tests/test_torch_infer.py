"""The port's entry points (diffusioniqt_tpu_torch/infer.py, evaluate.py)
on the CPU at a tiny size: the volume stitched in device buffers equals
the JAX package's ``VolumeStitcher`` fed the same per-window outputs, and
the port's host ``VolumeStitcher`` under the EDM sampler, and both
``main()``s run end to end with ``--device cpu``."""

import argparse
import os

import jax

import numpy as np
import pytest
import torch
import yaml

from diffusioniqt_tpu.config import load_config as j_load_config
from diffusioniqt_tpu.data.datasets import SupervisedIQTInference as JInference
from diffusioniqt_tpu.data.stitching import VolumeStitcher as JStitcher
from diffusioniqt_tpu_torch import infer
from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.data.datasets import SupervisedIQTInference
from diffusioniqt_tpu_torch.data.stitching import VolumeStitcher
from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
from diffusioniqt_tpu_torch.ops.volume import subvolumes_to_volume

torch.set_num_threads(1)

TINY = {"dim": 8, "init_dim": 8, "dim_mults": (1, 2), "num_resnet_blocks": (1, 1),
        "resnet_groups": 4, "patch_size_sub": 4, "timesteps": 2,
        "compute_dtype": "float32", "att_enc": (False, False)}


def _tiny(cfg):
    for k, v in TINY.items():
        setattr(cfg.train, k, v)
    cfg.eval.overlap = 8
    return cfg


class _Recorder:
    """Wraps ``Imagen.sample`` and keeps every output it returns."""

    def __init__(self, imagen):
        self.outputs = []
        self._sample = imagen.sample
        imagen.sample = self

    def __call__(self, **kw):
        out = self._sample(**kw)
        self.outputs.append(out)
        return out


@pytest.mark.parametrize("mode,patch_batch", [("trim", 3), ("gaussian", 8)])
def test_infer_volume_matches_jax_stitcher(mode, patch_batch):
    cfg = _tiny(load_config("config/eval_config.yaml"))
    imagen = infer.build_sampler(cfg, device="cpu", seed=0)
    rec = _Recorder(imagen)
    lowres, _ = infer.fake_volumes(cfg, 20, seed=1)
    pred = infer.infer_volume(cfg, imagen, lowres, stitch_mode=mode,
                              patch_batch=patch_batch, verbose=False,
                              noise=gaussian_noise(torch.Generator().manual_seed(0)))
    assert pred.shape == lowres.shape and np.isfinite(pred).all()

    jcfg = _tiny(j_load_config("config/eval_config.yaml"))
    items = [it for it in (JInference(jcfg, None, volume=lowres)[i]
                           for i in range(8)) if it is not None]
    windows = np.concatenate([subvolumes_to_volume(o, 3).numpy() for o in rec.outputs])
    assert len(rec.outputs) == -(-len(items) // patch_batch)
    assert windows.shape == (len(items), 12, 12, 12, 1)
    stitcher = JStitcher(lowres.shape, jcfg.train.patch_size, jcfg.eval.overlap,
                         mode=mode, fill_value=jcfg.data.min_bound)
    for (_, idx), window in zip(items, windows):
        stitcher.add(window[..., 0], idx)
    np.testing.assert_array_equal(pred, stitcher.result())


def _tiny_config_file(tmp_path, source):
    raw = yaml.safe_load(open(source))
    raw["Train"].update({k: list(v) if isinstance(v, tuple) else v
                         for k, v in TINY.items()})
    raw["Train"]["edm_num_sample_steps"] = 3
    raw["Eval"]["overlap"] = 8
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return path


def test_main_runs_on_cpu(tmp_path):
    cfg_path = _tiny_config_file(tmp_path, "config/eval_config.yaml")
    out = tmp_path / "out"
    infer.main(["--config", str(cfg_path), "--fake-data", "--fake-edge", "20",
                "--device", "cpu", "--output-dir", str(out), "--patch-batch", "4"])
    for name in ("volume_inf", "volume_gt", "volume_lr"):
        vol = np.load(out / f"{name}.npy")
        assert vol.shape == (20, 20, 20) and np.isfinite(vol).all()
        assert os.path.exists(out / f"{name}.nii.gz")


def test_checkpoint_formats_load(tmp_path):
    """A bare state dict and a model-only bundle load; a bundle without an
    EMA entry serves its online weights only when asked for them, and
    refuses otherwise (convert_reference_checkpoint's rule)."""
    cfg = _tiny(load_config("config/eval_config.yaml"))
    sd = infer.build_sampler(cfg, device="cpu", seed=3).unets[1].state_dict()
    bundle = tmp_path / "bundle.pt"
    torch.save({"model": {f"unets.1.{k}": v for k, v in sd.items()}}, bundle)
    raw = tmp_path / "raw.pt"
    torch.save(sd, raw)
    for path, use_ema in ((bundle, False), (raw, True)):
        loaded = infer.build_sampler(cfg, device="cpu", seed=0, checkpoint=str(path),
                                     use_ema=use_ema)
        for k, v in loaded.unets[1].state_dict().items():
            assert torch.equal(v, sd[k]), k
    with pytest.raises(KeyError, match="no 'ema' entry"):
        infer.build_sampler(cfg, device="cpu", checkpoint=str(bundle))


def _reference_bundle(tmp_path, cfg):
    """A trainer bundle in the reference's layout (trainer.py:813-878) whose
    online and EMA weights differ."""
    online = infer.build_sampler(cfg, device="cpu", seed=3).unets[1].state_dict()
    ema = infer.build_sampler(cfg, device="cpu", seed=4).unets[1].state_dict()
    bundle = {"model": {"unets.0.dummy": torch.zeros(1),
                        **{f"unets.1.{k}": v for k, v in online.items()}},
              "ema": {"0.ema_model.dummy": torch.zeros(1), "0.step": torch.tensor(0),
                      **{f"1.ema_model.{k}": v for k, v in ema.items()},
                      "1.step": torch.tensor(10)},
              "steps": torch.tensor([0, 10])}
    path = tmp_path / "trainer.pt"
    torch.save(bundle, path)
    return str(path), online, ema


def test_bundle_serves_ema_weights_by_default(tmp_path):
    """infer / evaluate serve a bundle's EMA weights, and the online ones
    with --use-non-ema."""
    cfg_path = _tiny_config_file(tmp_path, "config/eval_edm.yaml")
    path, online, ema = _reference_bundle(tmp_path, _tiny_edm())
    assert not torch.equal(online["init_conv.weight"], ema["init_conv.weight"])
    for flags, want in (([], ema), (["--use-non-ema"], online)):
        ap = argparse.ArgumentParser()
        infer.add_serving_args(ap)
        args = ap.parse_args(["--config", str(cfg_path), "--checkpoint", path,
                              "--device", "cpu", *flags])
        _, imagen, _, _ = infer.serve_from_args(args)
        for k, v in imagen.unets[1].state_dict().items():
            assert torch.equal(v, want[k]), k


def test_fake_subjects_are_test_all_stream():
    """evaluate --fake-data --fake-volumes N draws the N subjects in turn
    from one default_rng(0) stream, as test_all.py:90-97 does."""
    from diffusioniqt_tpu_torch import evaluate

    cfg = load_config("config/eval_edm.yaml")
    args = argparse.Namespace(fake_data=True, fake_edge=9, fake_volumes=3, seed=0)
    subjects = evaluate.load_subjects(cfg, args)
    rng = np.random.default_rng(0)  # the reference loop, verbatim
    std = cfg.data.std
    for i, (name, lr, hr) in enumerate(subjects):
        want_hr = np.abs(rng.standard_normal((9,) * 3)).astype(np.float32) * std
        want_lr = want_hr + rng.standard_normal(want_hr.shape).astype(np.float32) * 0.1 * std
        assert name == f"fake{i}"
        np.testing.assert_array_equal(hr, want_hr)
        np.testing.assert_array_equal(lr, want_lr)
    assert len(subjects) == 3


def _tiny_edm():
    cfg = _tiny(load_config("config/eval_edm.yaml"))
    cfg.train.edm_num_sample_steps = 3
    return cfg


@pytest.mark.parametrize("mode", ["trim", "gaussian"])
def test_edm_infer_volume_device_stitch_equals_host(mode):
    """The EDM sampler served by infer_volume (3 steps, dim 8): a finite
    volume of the input's shape, equal to the host ``VolumeStitcher`` fed
    the same per-window outputs in the same order."""
    cfg = _tiny_edm()
    imagen = infer.build_sampler(cfg, device="cpu", seed=0)
    rec = _Recorder(imagen)
    lowres, _ = infer.fake_volumes(cfg, 20, seed=2)
    pred = infer.infer_volume(cfg, imagen, lowres, stitch_mode=mode, patch_batch=3,
                              verbose=False,
                              noise=gaussian_noise(torch.Generator().manual_seed(4)))
    assert pred.shape == lowres.shape and np.isfinite(pred).all()
    starts = SupervisedIQTInference(cfg, lr_file=None, volume=lowres).valid_indices()
    windows = np.concatenate([subvolumes_to_volume(o, 3).numpy() for o in rec.outputs])
    assert len(rec.outputs) == -(-len(starts) // 3) and len(windows) == len(starts)
    host = VolumeStitcher(lowres.shape, cfg.train.patch_size, cfg.eval.overlap,
                          mode=mode, fill_value=cfg.data.min_bound)
    for idx, window in zip(starts, windows):
        host.add(window[..., 0], idx)
    np.testing.assert_array_equal(pred, host.result())


def test_evaluate_main_runs_on_cpu(tmp_path, capsys):
    from diffusioniqt_tpu_torch import evaluate

    cfg_path = _tiny_config_file(tmp_path, "config/eval_edm.yaml")
    out = tmp_path / "out"
    evaluate.main(["--config", str(cfg_path), "--fake-data", "--fake-volumes", "2",
                   "--fake-edge", "20", "--device", "cpu",
                   "--output-dir", str(out), "--patch-batch", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert "ElucidatedImagen (EDM) loaded: 3 Heun steps" in lines
    assert sum(ln.startswith(("fake0: msssim=", "fake1: msssim=")) for ln in lines) == 2
    for prefix in ("MS-SSIM: ", "PSNR:    ", "Avg sampling time: "):
        assert any(ln.startswith(prefix) for ln in lines), prefix
    for name in ("fake0", "fake1"):
        vol = np.load(out / f"{name}_inf.npy")
        assert vol.shape == (20, 20, 20) and np.isfinite(vol).all()
        assert os.path.exists(out / f"{name}_inf.nii.gz")


@pytest.mark.parametrize("weights", [True, False], ids=["weights", "proxy"])
def test_evaluate_lpips_matches_test_all(tmp_path, capsys, weights):
    """``evaluate --lpips`` on two fake 44^3 subjects (centre crops of 16^3,
    two 16^2 slices each): the per-subject ``lpips=`` field and the mean ±
    std line hold what ``test_all.py --lpips`` computes for the same
    prediction and ground truth (its ``lpips_volume_metric`` on the same
    crops) with the same VGG / lin state dict, 1e-5 relative; without
    weights, the warning, the proxy label and the port's own fixed-seed
    VGG."""
    from diffusioniqt_tpu.metrics import lpips as jlpips
    from diffusioniqt_tpu_torch import evaluate
    from diffusioniqt_tpu_torch.metrics import lpips as tlpips
    from diffusioniqt_tpu_torch.utils.convert import lin_heads_from_jax, vgg16_state_dict_from_jax

    cfg_path = _tiny_config_file(tmp_path, "config/eval_config.yaml")
    out = tmp_path / "out"
    args = ["--config", str(cfg_path), "--fake-data", "--fake-volumes", "2", "--fake-edge",
            "44", "--device", "cpu", "--output-dir", str(out), "--patch-batch", "8", "--lpips"]
    if weights:
        rng = np.random.default_rng(3)
        jmodel = jlpips.LPIPS(lin_weights=[rng.uniform(0, 0.05, ch).astype(np.float32)
                                           for ch, _ in jlpips._VGG16_BLOCKS], image_size=16)
        sd = vgg16_state_dict_from_jax(jax.device_get(jmodel.vgg_params))
        sd.update({f"lin{i}.model.1.weight": w.reshape(1, -1, 1, 1)
                   for i, w in enumerate(lin_heads_from_jax(jmodel.lin_weights))})
        path = str(tmp_path / "lpips.pt")
        torch.save(sd, path)
        args += ["--lpips-weights", path]
        model = jlpips.lpips_from_torch_checkpoint(path)
    res = evaluate.main(args)
    lines = capsys.readouterr().out.splitlines()
    label = "LPIPS" if weights else "LPIPS(random-features)"
    assert any(ln.startswith("WARNING: no --lpips-weights") for ln in lines) != weights
    b = res["border"]
    assert b == 14 and len(res["lpips"]) == 2
    for i, got in enumerate(res["lpips"]):
        line = next(ln for ln in lines if ln.startswith(f"fake{i}: msssim="))
        assert line.endswith(f" lpips={got:.4f}")
        pred = np.load(out / f"fake{i}_inf.npy")
        _, hr = infer.fake_subjects(load_config(str(cfg_path)), 44, 2, seed=0)[i]
        cfg = load_config(str(cfg_path))
        gt = ((hr - cfg.data.mean) / cfg.data.std)[b:-b, b:-b, b:-b]
        p = pred[b:-b, b:-b, b:-b]
        if weights:
            want = jlpips.lpips_volume_metric(gt, p, model)
        else:
            want = tlpips.lpips_volume_metric(gt, p, tlpips.LPIPS())
        assert np.isfinite(want) and got == pytest.approx(want, rel=1e-5)
    mean, std = np.mean(res["lpips"]), np.std(res["lpips"])
    assert f"{label}:   {mean:.4f} +/- {std:.4f}" in lines
