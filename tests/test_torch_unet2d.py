"""The port's 2D slice family against the JAX package at fp32 on the CPU:
``models/unet2d.py`` (every attention type, self-conditioning, conditioning
images, lowres conditioning) with weights carried by
``utils/convert.py::unet2d_state_dict_from_jax_params``, the pixel-(un)shuffle
channel order, and one ancestral ``Imagen(spatial_dims=2)`` call against
the JAX ``Imagen.sample`` on the same noise (the JAX loop's own draws,
taken from its keys). ``quality_run_2d`` is in
``tests/test_torch_quality_2d.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
from diffusioniqt_tpu.models import unet2d as j2d
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.models import unet2d as t2d
from diffusioniqt_tpu_torch.models.unet3d import NullUnet
from diffusioniqt_tpu_torch.utils.convert import unet2d_state_dict_from_jax_params

torch.set_num_threads(1)

B, EDGE = 2, 16
SMALL = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, channels=1, resnet_groups=4,
             attn_heads=2, attn_dim_head=8)
MIN_BOUND = -0.7


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pair(kw, inputs, seed=0):
    """The JAX UNet2D's params (``init`` on ``inputs``) and the port's
    UNet2D with them loaded."""
    junet = j2d.UNet2D(**kw, use_flash=False)
    x, t = jnp.asarray(inputs["x"]), jnp.asarray(inputs["t"])
    extra = {k: jnp.asarray(v) for k, v in inputs.items() if k not in ("x", "t")}
    params = junet.init(jax.random.PRNGKey(seed), x, t, t, **extra)
    port = t2d.UNet2D(**kw)
    port.load_state_dict(unet2d_state_dict_from_jax_params(jax.device_get(params)))
    return junet, params, port


@pytest.mark.parametrize("att_type,layer_attns,middle,self_cond,cond_ch,lowres", [
    ("linear", (False, True), True, False, 0, True),
    ("softmax", (True, True), True, False, 0, True),
    ("none", (True, True), True, True, 2, False),
    ("softmax", (False, True), False, True, 3, True),
])
def test_unet2d_matches_jax(att_type, layer_attns, middle, self_cond, cond_ch, lowres):
    """The forward at fp32 within 1e-4 of the JAX output's largest entry;
    softmax attention runs ``attention_reference`` on the CPU, the JAX module
    its ``attention_reference`` (``use_flash=False``)."""
    kw = dict(SMALL, att_type=att_type, layer_attns=layer_attns, attend_at_middle=middle,
              self_cond=self_cond, cond_images_channels=cond_ch, lowres_cond=lowres)
    inputs = {"x": _rand((B, EDGE, EDGE, 1), 1), "t": np.asarray([0.3, -1.2], np.float32)}
    if lowres:
        inputs["lowres_cond_img"] = _rand((B, EDGE, EDGE, 1), 2)
    if self_cond:
        inputs["self_cond"] = _rand((B, EDGE, EDGE, 1), 3)
    if cond_ch:
        inputs["cond_images"] = _rand((B, EDGE, EDGE, cond_ch), 4)
    junet, params, port = _pair(kw, inputs)
    jin = {k: jnp.asarray(v) for k, v in inputs.items()}
    want = np.asarray(junet.apply(params, jin.pop("x"), jin["t"], jin.pop("t"), **jin))
    tin = {k: torch.from_numpy(v) for k, v in inputs.items()}
    with torch.no_grad():
        got = port(tin.pop("x"), tin["t"], tin.pop("t"), **tin)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    # every JAX parameter has a port parameter, and none is left over
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(params))
    assert n_jax == sum(p.numel() for p in port.parameters())


def test_pixel_shuffle_orders_match_jax():
    """``F.pixel_unshuffle`` / ``F.pixel_shuffle`` put each channel and
    sub-position where the JAX reshape-and-transpose orders put them
    (unet2d.py:96-121): both modules with an identity 1x1 kernel."""
    c = 3
    x = _rand((2, 6, 8, c), 9)
    down = j2d.Downsample2D(4 * c)
    eye = {"params": {"Conv_0": {"kernel": np.eye(4 * c, dtype=np.float32)[None, None],
                                 "bias": np.zeros(4 * c, np.float32)}}}
    want = np.asarray(down.apply(eye, jnp.asarray(x)))
    port_down = t2d.Downsample2D(c, 4 * c)
    port_down.conv.weight.data = torch.eye(4 * c)[:, :, None, None]
    port_down.conv.bias.data.zero_()
    np.testing.assert_array_equal(port_down(torch.from_numpy(x)).detach().numpy(), want)

    up = j2d.PixelShuffleUpsample2D(c)
    y = _rand((2, 3, 4, 4 * c), 10)
    want = np.asarray(up.apply(eye, jnp.asarray(y)))
    port_up = t2d.PixelShuffleUpsample2D(4 * c, c)
    port_up.conv.weight.data = torch.eye(4 * c)[:, :, None, None]
    port_up.conv.bias.data.zero_()
    got = port_up(torch.from_numpy(y)).detach().numpy()
    assert got.shape == want.shape == (2, 6, 8, c)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # ICNR: the 4 sub-positions of each output channel start equal
    w = t2d.PixelShuffleUpsample2D(5, 3).conv.weight.detach()
    assert torch.equal(w, w[::4].repeat_interleave(4, dim=0))


def _jax_loop_noise(key, shape, n_steps):
    """What the JAX ``Imagen.sample`` draws for its one sampled stage
    (gaussian.py:464, 314-315, 338, 295): the stage's key, the loop's
    initial image, then one ``p_sample`` draw per step, in the order the
    port's ``NoiseFn`` is asked for them."""
    _, sub = jax.random.split(key)
    key, init_key = jax.random.split(sub)
    draws = [jax.random.normal(init_key, shape, jnp.float32)]
    for _ in range(n_steps):
        key, _, k_sample, _ = jax.random.split(key, 4)
        draws.append(jax.random.normal(k_sample, shape, jnp.float32))
    return [np.asarray(d) for d in draws]


def _noise_from(arrays):
    it = iter(arrays)

    def draw(shape):
        a = next(it)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(a)
    return draw


def test_imagen_2d_sample_matches_jax_sample():
    """One 4-step ancestral call of ``Imagen(spatial_dims=2)`` over a
    softmax-attention UNet2D (the serve path's kind, cut to dim 8), as
    ``quality_run_2d`` builds the wrapper, against the JAX ``Imagen.sample``
    with the same weights and the JAX loop's own noise: within 1e-4 of the
    largest output."""
    steps = 4
    kw = dict(SMALL, att_type="softmax", layer_attns=(False, True), attend_at_middle=True)
    wrap = dict(image_sizes=(EDGE, EDGE), channels=1, timesteps=steps,
                pred_objectives="x_start", dynamic_thresholding=False,
                p2_loss_weight_gamma=0.0, auto_normalize_img=False, cond_drop_prob=0.0,
                min_bound=MIN_BOUND, norm="z-score", spatial_dims=2)
    jimagen = JImagen([JNullUnet(), j2d.UNet2D(**kw, use_flash=False)], **wrap)
    params = jimagen.init_params(jax.random.PRNGKey(3), batch_size=B)
    lowres = _rand((B, EDGE, EDGE, 1), 5)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jimagen.sample(params, key, batch_size=B, start_at_unet_number=2,
                                     start_image_or_video=jnp.asarray(lowres)))

    # the wrapper casts the unet to the lowres-conditioned one, as JAX does
    port = Imagen([NullUnet(), t2d.UNet2D(**kw)], **wrap)
    unet = port.unets[1]
    assert unet.lowres_cond and isinstance(unet, t2d.UNet2D)
    unet.load_state_dict(unet2d_state_dict_from_jax_params(jax.device_get(params[1])))
    noise = _jax_loop_noise(key, (B, EDGE, EDGE, 1), steps)
    got = port.sample(batch_size=B, noise=_noise_from(noise), start_at_unet_number=2,
                      start_image_or_video=torch.from_numpy(lowres))
    assert got.shape == want.shape == (B, EDGE, EDGE, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_cast_model_parameters():
    """The JAX cast: the same module where the cascade's conditioning and
    channels match (``channels_out`` None counts as ``channels``), else a
    fresh one with them."""
    unet = t2d.UNet2D(**SMALL)
    assert unet.cast_model_parameters(lowres_cond=False, channels=1, channels_out=1) is unet
    cast = unet.cast_model_parameters(lowres_cond=True, channels=1, channels_out=1)
    assert cast is not unet and cast.lowres_cond and cast.init_conv.in_channels == 2
    with pytest.raises(ValueError, match="lowres"):
        unet(torch.zeros(1, 8, 8, 1), torch.zeros(1), torch.zeros(1),
             lowres_cond_img=torch.zeros(1, 8, 8, 1))
