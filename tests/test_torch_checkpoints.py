"""The port's model bundle (``utils/checkpoints.py::save_imagen_checkpoint``
/ ``load_imagen_checkpoint``) against the JAX package's: a bundle that the
JAX function writes is read with the JAX function, its trees converted
(``utils/convert.py::state_dict_from_jax_params``) and written and read back
through the port, whose U-Net then computes the JAX forward (1e-4 of the
largest output, fp32); the metadata file holds the JAX keys and values; the
wrapper-type assertion, the EMA swap and the refusals."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu.utils import checkpoints as jck
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.utils import checkpoints as tck
from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params
from tests.test_torch_train import B, E_KW, EDGE, G_KW, SHAPE, UNET_KW, _init_params, _jax_unet

torch.set_num_threads(1)


def _port_imagen(edm=True):
    unets = [NullUnet(), UNet3D(**UNET_KW)]
    return ElucidatedImagen(unets, **E_KW) if edm else Imagen(unets, **G_KW)


def _state_dicts(tree):
    """Port state dicts of the JAX wrapper's ``[null, unet]`` trees."""
    null = {"dummy": torch.from_numpy(np.array(tree[0]["params"]["dummy"], np.float32))}
    return [null, state_dict_from_jax_params(jax.device_get(tree[1]))]


@pytest.fixture(scope="module")
def jax_bundle(tmp_path_factory):
    """A JAX bundle (parameters and an EMA of half their values) on
    seeded weights, and what the JAX loader reads back from it."""
    jnet = _jax_unet()
    params0 = _init_params(jnet, seed=0)
    null = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32),
        jax.eval_shape(lambda: JNullUnet().init(jax.random.PRNGKey(0), jnp.zeros(SHAPE))))
    wrapper = JElucidated([JNullUnet(), jnet], cond_drop_prob=0.0, **E_KW)
    wrapper.init_params = lambda key, batch_size=1: [
        jax.tree_util.tree_map(jnp.asarray, p) for p in (null, params0)]
    params = wrapper.init_params(None)
    ema = jax.tree_util.tree_map(lambda p: p * 0.5, params)
    path = str(tmp_path_factory.mktemp("jax") / "bundle")
    jck.save_imagen_checkpoint(path, wrapper, params, ema_params=ema, extra_config={"dim": 8})
    restored, restored_ema = jck.load_imagen_checkpoint(path, wrapper)
    return dict(jnet=jnet, path=path, params=restored, ema=restored_ema)


def _jax_forward(jnet, params, x, t, lr):
    return np.asarray(jax.jit(jnet.apply)(jax.tree_util.tree_map(jnp.asarray, params), x, t, t,
                                          lowres_cond_img=lr))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


def test_jax_bundle_through_the_port_computes_the_jax_forward(jax_bundle, tmp_path):
    """JAX bundle -> JAX loader -> port bundle -> port loader: the U-Net
    computes the JAX forward of the main weights, and with
    ``load_ema_if_available`` that of the EMA weights; the metadata file has
    the JAX bundle's keys and values."""
    imagen = _port_imagen()
    path = str(tmp_path / "bundle")
    tck.save_imagen_checkpoint(path, imagen, _state_dicts(jax_bundle["params"]),
                               ema=_state_dicts(jax_bundle["ema"]), extra_config={"dim": 8})
    with open(os.path.join(path, "imagen_meta.json")) as fh:
        meta = json.load(fh)
    with open(os.path.join(jax_bundle["path"], "imagen_meta.json")) as fh:
        assert meta == json.load(fh)
    assert sorted(os.listdir(path)) == ["imagen_meta.json", "state.pt"]

    rng = np.random.default_rng(4)
    x = rng.standard_normal(SHAPE).astype(np.float32)
    lr = rng.standard_normal(SHAPE).astype(np.float32)
    t = np.full((B,), 0.3, np.float32)
    unet = imagen.unets[1]
    for use_ema, tree in ((False, "params"), (True, "ema")):
        params, ema = tck.load_imagen_checkpoint(path, imagen, load_ema_if_available=use_ema)
        assert ema is not None and len(params) == 2
        unet.load_state_dict(params[1])
        with torch.no_grad():
            got = unet(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(t),
                       lowres_cond_img=torch.from_numpy(lr)).numpy()
        _close(got, _jax_forward(jax_bundle["jnet"], jax_bundle[tree][1], x, t, lr))
    main, _ = tck.load_imagen_checkpoint(path, imagen)
    for k, v in main[1].items():  # the EMA is half of each weight: not the main weights
        if v.abs().max() > 0:
            assert not torch.equal(v, ema[1][k]), k


def test_bundle_refusals_and_no_ema(tmp_path):
    """A bundle of an EDM wrapper does not load into a Gaussian one (the
    JAX assertion), nor into a wrapper whose unets' shapes differ; a bundle
    without EMA returns None for it and keeps its main weights under
    ``load_ema_if_available``."""
    torch.manual_seed(0)
    imagen = _port_imagen()
    states = [{k: v.clone() for k, v in u.state_dict().items()} for u in imagen.unets]
    path = str(tmp_path / "b")
    tck.save_imagen_checkpoint(path, imagen, states)
    params, ema = tck.load_imagen_checkpoint(path, imagen, load_ema_if_available=True)
    assert ema is None
    for k, v in states[1].items():
        assert torch.equal(params[1][k], v), k
    with pytest.raises(AssertionError, match="elucidated"):
        tck.load_imagen_checkpoint(path, _port_imagen(edm=False))
    wider = ElucidatedImagen([NullUnet(), UNet3D(**{**UNET_KW, "dim": 16, "init_dim": 16})],
                             **E_KW)
    with pytest.raises(ValueError, match="does not fit"):
        tck.load_imagen_checkpoint(path, wider)
    with pytest.raises(ValueError, match="unets"):
        tck.load_imagen_checkpoint(path, ElucidatedImagen(
            [UNet3D(**UNET_KW)], **{**E_KW, "image_sizes": (EDGE,)}))
