"""The port's tools as entry points, against the JAX tools:
``python -m diffusioniqt_tpu_torch.edm_probe`` (``tools/edm_probe.py``) and
``python -m diffusioniqt_tpu_torch.nifti_roundtrip``
(``tools/nifti_roundtrip.py``), on the CPU at what runs in seconds."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffusioniqt_tpu_torch import edm_probe, nifti_roundtrip, quality_run

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool(name):
    """``tools/<name>.py``, imported in the test only; its import-time
    environment defaults are undone."""
    before = dict(os.environ)
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    for key in set(os.environ) - set(before):
        del os.environ[key]
    return module


# ---------------------------------------------------------------------------
# edm_probe
# ---------------------------------------------------------------------------

SIGMAS = (0.05, 1.0)
SIZE = 32


def test_edm_probe_table_equals_the_jax_tool(tmp_path):
    """``edm_probe --quick --size 32`` over a bundle whose EMA U-Net holds
    JAX weights (``state_dict_from_jax_params`` of filled ``init`` shapes)
    against the JAX tool's computation on those weights and the probe's own
    noise draws: the held-out phantom's z-scored centre crop (27
    sub-volumes of 10^3 at this size), ``preconditioned_network_forward``
    unclamped and clamped at each sigma, the RMSEs, the LR baseline and the
    data std, each within 1e-4 relative (fp32)."""
    from diffusioniqt_tpu.data.synthetic import generate_pair as j_pair
    from diffusioniqt_tpu.diffusion.elucidated import elucidated_imagen_from_config as j_edm
    from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
    from diffusioniqt_tpu.models.unet3d import iqt_unet_from_config as j_unet
    from diffusioniqt_tpu.ops.volume import volume_to_subvolumes as j_split
    from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params
    from tests.test_torch_train import _init_params

    mean, std = 40.0, 30.0
    jcfg = _jax_tool("quality_run").flagship_cfg(quick=True, elucidated=True)
    jcfg.train.edm_sigma_data = 1.0
    jcfg.data.mean, jcfg.data.std = mean, std
    junet = j_unet(jcfg)
    jimagen = j_edm(jcfg, [JNullUnet(), junet])
    params = _init_params(junet, seed=0)

    cfg = quality_run.flagship_cfg(quick=True, elucidated=True, device="cpu")
    cfg.train.edm_sigma_data = 1.0
    trainer = quality_run.build_trainer(cfg, device="cpu")
    trainer.prepare()
    trainer.ema_unets[1].load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    ckpt = str(tmp_path / "ckpt.pt")
    trainer.save(ckpt)
    with open(tmp_path / "stats.json", "w") as fh:
        json.dump({"mean": mean, "std": std, "edm_sigma_data": 1.0}, fh)
    got = edm_probe.main(["--ckpt", ckpt, "--quick", "--size", str(SIZE), "--device", "cpu",
                          "--sigmas", ",".join(map(str, SIGMAS))])
    assert json.load(open(tmp_path / "probe.json")) == got
    assert got["sigma_data"] == 1.0 and got["lowres_noise_level"] == 0.0

    # the JAX tool's body on the same weights and draws
    hr, lr = j_pair(SIZE, seed=10_000)
    sub = SIZE // 3
    c0 = (SIZE - 3 * sub) // 2
    sl = slice(c0, c0 + 3 * sub)
    clean = j_split(jnp.asarray(((hr - mean) / std)[sl, sl, sl].astype(np.float32)[None, ..., None]), 3)
    lowres = j_split(jnp.asarray(((lr - mean) / std)[sl, sl, sl].astype(np.float32)[None, ..., None]), 3)
    assert clean.shape == (27, sub, sub, sub, 1)
    unet, hp = jimagen.unets[1], jimagen.hparams[1]
    fwd = jax.jit(lambda p, x, s, lrz, c: jimagen.preconditioned_network_forward(
        unet, p, x, s, hp, clamp=c, dynamic_threshold=bool(jimagen.dynamic_thresholding[1]),
        lowres_cond_img=lrz), static_argnums=4)
    gen = torch.Generator().manual_seed(0)

    def rmse(a, b):
        return float(jnp.sqrt(jnp.mean((a - b) ** 2)))

    rel = dict(rtol=1e-4, atol=0)
    np.testing.assert_allclose(got["baseline_rmse_lr"], rmse(lowres, clean), **rel)
    np.testing.assert_allclose(got["data_std"], float(jnp.std(clean)), **rel)
    assert [r["sigma"] for r in got["rows"]] == list(SIGMAS)
    for sigma, row in zip(SIGMAS, got["rows"]):
        n = jnp.asarray(torch.randn(tuple(clean.shape), generator=gen).numpy())
        x = clean + jnp.float32(sigma) * n
        s = jnp.float32(sigma)
        np.testing.assert_allclose(row["rmse_in"], rmse(x, clean), **rel)
        np.testing.assert_allclose(row["rmse_D"], rmse(fwd(params, x, s, lowres, False), clean),
                                   **rel)
        np.testing.assert_allclose(row["rmse_D_clamped"],
                                   rmse(fwd(params, x, s, lowres, True), clean), **rel)


def test_edm_probe_arguments_keep_the_jax_tools():
    """The JAX tool's arguments and defaults (``--cpu`` is ``--device cpu``
    here)."""
    ap_port = {a for a in open(edm_probe.__file__).read().split('ap.add_argument("')[1:]}
    port_flags = {a.split('"')[0] for a in ap_port}
    jax_src = open(os.path.join(ROOT, "tools", "edm_probe.py")).read()
    jax_flags = {a.split('"')[0] for a in jax_src.split('ap.add_argument("')[1:]}
    assert jax_flags - port_flags == {"--cpu"}
    assert edm_probe.SIGMAS == "0.01,0.05,0.2,1.0,5.0,20.0"


# ---------------------------------------------------------------------------
# nifti_roundtrip
# ---------------------------------------------------------------------------

def _stub_volumes(monkeypatch, write_module, synth_module, written):
    """Small phantoms in place of the 256^3 ones and a writer that records
    the path and the array, set on the module the tool reads them from."""
    def pair(size, seed=0):
        rng = np.random.default_rng(seed)
        hr = 100.0 + 20.0 * rng.standard_normal((4, 4, 4))
        return hr, hr + 5.0 * rng.standard_normal((4, 4, 4))

    def write(path, data, *args, **kwargs):
        written[path] = np.array(data)

    monkeypatch.setattr(write_module, "write", write)
    monkeypatch.setattr(synth_module, "generate_pair", pair)


def test_nifti_prepare_writes_the_jax_tools_layout_and_configs(tmp_path, monkeypatch):
    """``prepare`` with the volume writer and the phantoms stubbed (here, not
    in the module): the same files under the root and the same two YAML
    configs as the JAX tool's, the root substituted; the z-score stats
    are the training LR volumes'."""
    import diffusioniqt_tpu.data.nifti as j_nifti
    import diffusioniqt_tpu.data.synthetic as j_synth

    jax_tool = _jax_tool("nifti_roundtrip")
    got_files, want_files = {}, {}
    _stub_volumes(monkeypatch, nifti_roundtrip, nifti_roundtrip, got_files)
    _stub_volumes(monkeypatch, j_nifti, j_synth, want_files)
    port_root, jax_root = str(tmp_path / "port"), str(tmp_path / "jax")
    got = nifti_roundtrip.prepare(port_root, 2, 1, 1)
    want = jax_tool.prepare(jax_root, 2, 1, 1)
    assert sorted(got) == sorted(want) == ["config_eval.yaml", "config_train.yaml"]
    assert sorted(os.path.relpath(p, port_root) for p in got_files) == \
        sorted(os.path.relpath(p, jax_root) for p in want_files)
    for p, arr in got_files.items():
        np.testing.assert_array_equal(arr, want_files[p.replace(port_root, jax_root)])
    for name in got:
        with open(got[name]) as fh:
            port_cfg = yaml.safe_load(fh.read().replace(port_root, "<root>"))
        with open(want[name]) as fh:
            jax_cfg = yaml.safe_load(fh.read().replace(jax_root, "<root>"))
        assert port_cfg == jax_cfg, name
    with open(got["config_train.yaml"]) as fh:
        data = yaml.safe_load(fh)["Data"]
    lrs = [a for p, a in got_files.items() if "/train/" in p and p.endswith("lr_norm.nii.gz")]
    np.testing.assert_allclose([data["mean"], data["std"]],
                               [np.concatenate([a.ravel() for a in lrs]).mean(),
                                np.concatenate([a.ravel() for a in lrs]).std()], rtol=1e-6)


def test_nifti_run_drives_the_port_entry_points(tmp_path, monkeypatch):
    """``run`` starts ``python -m diffusioniqt_tpu_torch.train`` and then
    ``... .evaluate --stitch gaussian`` on the best bundle, or the last one
    when no validation saved a best (subprocesses recorded here, not run),
    and reports each one's kernel launches."""
    calls = []

    def run_entry(cmd):
        calls.append(cmd)
        return {"conv3d": len(calls)}

    monkeypatch.setattr(nifti_roundtrip, "run_entry", run_entry)
    root = str(tmp_path)
    log = nifti_roundtrip.run(root, 2, 100, device="cpu")
    train, evaluate = calls
    assert train[1:3] == ["-m", "diffusioniqt_tpu_torch.train"]
    assert train[train.index("--steps") + 1] == "2" and "--device" in train
    assert evaluate[1:3] == ["-m", "diffusioniqt_tpu_torch.evaluate"]
    assert evaluate[evaluate.index("--stitch") + 1] == "gaussian"
    assert log["train_launches"] == {"conv3d": 1} and log["evaluate_launches"] == {"conv3d": 2}
    last = os.path.join(root, "results", "nifti_roundtrip", "model", "last_checkpoint.pt")
    assert evaluate[evaluate.index("--checkpoint") + 1] == last == log["checkpoint"]
    best = os.path.join(root, "results", "nifti_roundtrip", "model", "checkpoint.pt")
    os.makedirs(os.path.dirname(best))
    open(best, "w").close()
    calls.clear()
    assert nifti_roundtrip.run(root, 2, 1, device="cpu")["checkpoint"] == best


def test_launch_log_records_a_subprocess_launches(capsys):
    """``run_entry`` echoes a subprocess's output and returns the launch
    counts of the ``launches_line`` it prints (how the round trip and
    ``chip_smoke.py`` count the train and evaluate subprocesses' kernels);
    None without that line; a failing subprocess raises."""
    import subprocess
    import sys

    from diffusioniqt_tpu_torch.ops import kernels

    code = ("from diffusioniqt_tpu_torch.ops import kernels; print('step 0'); "
            "print(kernels.launches_line())")
    got = nifti_roundtrip.run_entry([sys.executable, "-c", code])
    assert got == dict.fromkeys(kernels.launch_counts(), 0)  # nothing ran
    out = capsys.readouterr().out.splitlines()
    assert out[1:] == ["step 0", kernels.launches_line()]
    assert nifti_roundtrip.run_entry([sys.executable, "-c", "print('no line')"]) is None
    with pytest.raises(subprocess.CalledProcessError):
        nifti_roundtrip.run_entry([sys.executable, "-c", "raise SystemExit(3)"])
