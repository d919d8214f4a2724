"""The port's config-driven factories (``diffusioniqt_tpu_torch/model_configs.py``)
and CLI (``diffusioniqt_tpu_torch/cli.py``) on the CPU: every U-Net kind,
the JSON that the JAX ``cli.py config`` writes loading into a port model
whose converted parameters have the JAX model's tree, a ``unet2d`` stage,
and ``config`` ->
``train`` -> ``sample`` at dim 8 (the JAX ``tests/test_cli_entry.py``
config)."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu import model_configs as jmc
from diffusioniqt_tpu.utils import torch_convert as tc
from diffusioniqt_tpu_torch import cli
from diffusioniqt_tpu_torch import model_configs as tmc
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.models.unet2d import UNet2D
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.models.unet_video import Unet3DVideo

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny(elucidated=False):
    """The JAX CLI test's small model (tests/test_cli_entry.py:29-58)."""
    return {
        "elucidated": elucidated,
        "imagen": {
            "unets": [
                {"kind": "null"},
                {"kind": "unet3d", "dim": 8, "dim_mults": [1, 2], "channels": 1,
                 "kwargs": {"num_resnet_blocks": 1, "init_dim": 8, "resnet_groups": 4,
                            "init_cross_embed": False, "att_type": "linear",
                            "attend_at_middle": False, "attend_at_enc": [False, False],
                            "use_se_attn": True, "batch_sample": False, "boundary": False,
                            "deep_feature": False, "img_size": 8}},
            ],
            "image_sizes": [8, 8], "channels": 1, "timesteps": 8,
            "pred_objectives": "x_start", "cond_drop_prob": 0.0,
            "dynamic_thresholding": False, "norm": "z-score",
        },
    }


def test_unet_config_kinds():
    assert isinstance(tmc.UnetConfig(kind="null").create("cpu"), NullUnet)
    unet = tmc.UnetConfig.from_dict({"kind": "unet3d", "dim": 8, "dim_mults": [1, 2],
                                     "num_resnet_blocks": 1, "init_dim": 8}).create("cpu")
    # the JAX UNet3D's defaults for what the JSON leaves out
    assert isinstance(unet, UNet3D) and unet.channels == 1 and unet.factor == 1
    assert unet.mid_block is not None and unet.dtype == torch.float32
    assert tmc.UnetConfig.from_dict({"dim": 8, "kwargs": {"dtype": "bfloat16"}}).create(
        "cpu").dtype == torch.bfloat16
    # kind unet2d builds the port's UNet2D with the JSON's fields
    unet2d = tmc.UnetConfig.from_dict({"kind": "unet2d", "dim": 8, "dim_mults": [1, 2],
                                       "num_resnet_blocks": 1, "att_type": "softmax",
                                       "layer_attns": [False, True]}).create("cpu")
    assert isinstance(unet2d, UNet2D) and unet2d.down_attn == [False, True]
    assert unet2d.dtype == torch.float32 and not unet2d.lowres_cond
    # kind video builds the port's Unet3DVideo with the JSON's fields, and
    # the cascade's cast (stage 2 lowres-conditioned) reaches it
    video = tmc.UnetConfig.from_dict({"kind": "video", "dim": 8, "dim_mults": [1, 2],
                                      "channels": 1, "text_embed_dim": 16,
                                      "temporal_strides": [1, 2]}).create(
        "cpu", lowres_cond=True, channels=1, channels_out=1)
    assert isinstance(video, Unet3DVideo) and video.lowres_cond
    assert video.total_temporal_divisor == 2 and video.dtype == torch.float32
    with pytest.raises(ValueError, match="unknown"):
        tmc.UnetConfig(kind="nope").create("cpu")


def test_wrappers_and_trainer_from_dicts():
    raw = _tiny()
    imagen = tmc.ImagenConfig.from_dict(raw["imagen"]).create("cpu")
    assert isinstance(imagen, Imagen) and imagen.image_sizes == (8, 8)
    assert imagen.unets[1].lowres_cond and not isinstance(imagen.unets[1], NullUnet)
    edm = tmc.ElucidatedImagenConfig.from_dict(raw["imagen"]).create("cpu")
    assert isinstance(edm, ElucidatedImagen)
    for elucidated in (False, True):
        trainer = tmc.ImagenTrainerConfig.from_dict(_tiny(elucidated)).create("cpu")
        assert isinstance(trainer.imagen, ElucidatedImagen) == elucidated
    # auto_normalize_img and cond_drop_prob reach the wrapper, as in the JAX create
    normed = tmc.ImagenConfig.from_dict({**raw["imagen"], "auto_normalize_img": True,
                                         "cond_drop_prob": 0.2}).create("cpu")
    x = torch.tensor([0.0, 0.25, 1.0])
    assert torch.equal(normed.normalize_img(x), x * 2 - 1)
    assert torch.equal(normed.unnormalize_img(x), (x + 1) * 0.5)
    assert normed.cond_drop_prob == 0.2 and normed.can_classifier_guidance
    assert torch.equal(imagen.normalize_img(x), x) and not imagen.can_classifier_guidance


def test_jax_cli_config_loads_into_the_port(tmp_path):
    """The file the JAX ``cli.py config`` writes builds a port cascade whose
    U-Net's parameters, through the JAX converter, have the tree and leaf
    shapes of the JAX model that file builds."""
    path = tmp_path / "jax_starter.json"
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    subprocess.run([sys.executable, "cli.py", "config", "--path", str(path)], cwd=ROOT,
                   env=env, check=True, capture_output=True, timeout=300)
    raw = json.loads(path.read_text())
    assert raw == cli.starter_config()  # the port's config verb writes the same file
    port = tmc.ImagenTrainerConfig.from_dict(raw).create("cpu").imagen.unets[1]
    converted = tc.convert_iqt_unet_state_dict(port.state_dict())

    jax_unet = jmc.UnetConfig.from_dict(raw["imagen"]["unets"][1]).create()
    jax_unet = jax_unet.cast_model_parameters(lowres_cond=True, channels=1, channels_out=1)
    x = jnp.zeros((1, 32, 32, 32, 1))
    shapes = jax.eval_shape(lambda: jax_unet.init(jax.random.PRNGKey(0), x, x[:, 0, 0, 0, 0],
                                                  x[:, 0, 0, 0, 0], lowres_cond_img=x))
    assert jax.tree_util.tree_structure(converted) == jax.tree_util.tree_structure(shapes)
    for got, want in zip(jax.tree_util.tree_leaves(converted), jax.tree_util.tree_leaves(shapes)):
        assert got.shape == want.shape


def test_cli_config_train_sample_on_the_cpu(tmp_path):
    cfg, ckpt = tmp_path / "model.json", tmp_path / "ckpt.pt"
    proc = subprocess.run([sys.executable, "-m", "diffusioniqt_tpu_torch.cli", "config",
                           "--path", str(tmp_path / "starter.json")], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and json.loads((tmp_path / "starter.json").read_text())
    cfg.write_text(json.dumps(_tiny()))
    cli.main(["train", "--config", str(cfg), "--checkpoint", str(ckpt), "--steps", "2",
              "--batch-size", "2", "--device", "cpu"])
    assert ckpt.exists()
    out = tmp_path / "samples.npy"
    cli.main(["sample", "--config", str(cfg), "--checkpoint", str(ckpt), "--batch-size", "2",
              "--output", str(out), "--device", "cpu"])
    arr = np.load(out)
    assert arr.shape == (2, 8, 8, 8, 1) and np.isfinite(arr).all()
    lowres = tmp_path / "lr.npy"
    np.save(lowres, np.random.default_rng(0).standard_normal((8, 8, 8)).astype(np.float32))
    cli.main(["sample", "--config", str(cfg), "--checkpoint", str(ckpt), "--lowres",
              str(lowres), "--output", str(out), "--device", "cpu"])
    arr = np.load(out)
    assert arr.shape == (1, 8, 8, 8, 1) and np.isfinite(arr).all()
