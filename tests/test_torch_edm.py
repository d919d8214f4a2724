"""The port's EDM sampler (diffusioniqt_tpu_torch/core/edm.py,
diffusion/elucidated.py, ops/volume.py::resize_volume) against the JAX
package at fp32. The JAX Heun loop draws its own noise
(elucidated.py:292-293,326), so the loop test builds it here from the
public JAX functions and feeds both sides the same numpy noise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.core.edm import EDMParams as JParams
from diffusioniqt_tpu.core.schedules import GaussianDiffusionContinuousTimes as JSched
from diffusioniqt_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu.ops.volume import resize_volume as j_resize
from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.core.edm import EDMParams
from diffusioniqt_tpu_torch.core.schedules import GaussianDiffusionContinuousTimes as TSched
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen, imagen_from_config
from diffusioniqt_tpu_torch.infer import build_sampler
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.ops.volume import resize_volume
from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

torch.set_num_threads(1)

MIN_BOUND = (0.0 - 271.64814106698583) / 377.117173547721  # eval_edm z-score
B, EDGE = 27, 4  # one group of 3^3 sub-volumes of 4^3
SHAPE = (B, EDGE, EDGE, EDGE, 1)
UNET_KW = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2), channels=1,
               resnet_groups=4, lowres_cond=True, use_se_attn=True, attend_at_middle=False,
               attend_at_enc=False, init_cross_embed=False, deep_feature=False,
               boundary=True, batch_sample=True, img_size=12)
EDM_KW = dict(image_sizes=(EDGE, EDGE), channels=1, auto_normalize_img=False,
              dynamic_thresholding=False, norm="z-score", min_bound=MIN_BOUND,
              num_sample_steps=4, lowres_noise_aug=False)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _noise_from(arrays):
    it = iter(arrays)

    def draw(shape):
        a = next(it)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(a)
    return draw


@pytest.mark.parametrize("steps", [2, 20, 64])
@pytest.mark.parametrize("sigma_data", [0.5, 1.0])
def test_edm_params_match_jax(steps, sigma_data):
    j, t = (P(num_sample_steps=steps, sigma_data=sigma_data) for P in (JParams, EDMParams))
    js, ts = j.sample_schedule(), t.sample_schedule()
    assert ts.dtype == torch.float32 and ts.shape == (steps + 1,)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(t.gammas(ts).numpy(), np.asarray(j.gammas(js)), rtol=1e-6)
    grid = np.concatenate([[0.0, 1e-13], np.geomspace(1e-3, 100.0, 41)]).astype(np.float32)
    for name in ("c_skip", "c_out", "c_in", "c_noise"):
        np.testing.assert_allclose(getattr(t, name)(torch.from_numpy(grid)).numpy(),
                                   np.asarray(getattr(j, name)(jnp.asarray(grid))),
                                   rtol=1e-6, err_msg=name)
    positive = grid[2:]
    np.testing.assert_allclose(t.loss_weight(torch.from_numpy(positive)).numpy(),
                               np.asarray(j.loss_weight(jnp.asarray(positive))), rtol=1e-6)
    # sigma ~ exp(N(P_mean, P_std)) from the caller's generator
    got = t.noise_distribution(torch.Generator().manual_seed(5), 6)
    normal = torch.randn(6, generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(got, torch.exp(t.P_mean + t.P_std * normal))


@pytest.mark.parametrize("shape,target", [((2, 6, 6, 6, 3), 9), ((2, 6, 6, 6, 3), 4),
                                          ((1, 12, 12, 2), 16), ((1, 12, 12, 2), 5)])
@pytest.mark.parametrize("method", ["nearest", "trilinear"])
def test_resize_volume_matches_jax(shape, target, method):
    """Up and down, 3D and 2D: half-pixel nearest and the antialiased
    linear resize of jax.image.resize."""
    x = _rand(shape, sum(shape) + target)
    got = resize_volume(torch.from_numpy(x), target, method, clamp_range=(-1.5, 1.5))
    want = j_resize(jnp.asarray(x), target, method, clamp_range=(-1.5, 1.5))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_resize_volume_is_identity_at_equal_size():
    x = torch.from_numpy(_rand((2, 5, 5, 5, 1), 3))
    assert resize_volume(x, 5, "trilinear") is x


@pytest.fixture(scope="module")
def pair():
    """A JAX EDM wrapper over a small boundary UNet3D and the port's over
    the same weights."""
    jimagen = JElucidated([JNullUnet(), JUNet3D(**UNET_KW, att_type="linear",
                                                dtype=jnp.float32)],
                          cond_drop_prob=0.0, **EDM_KW)
    params = jimagen.init_params(jax.random.PRNGKey(0), batch_size=B)[1]
    port = UNet3D(**UNET_KW).eval()
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    return jimagen, params, ElucidatedImagen([NullUnet(), port], **EDM_KW)


@pytest.mark.parametrize("clamp,dynamic,cond_scale,scalar_sigma", [
    (False, False, 1.0, False), (True, False, 1.0, True), (True, True, 1.0, False),
    (False, False, 2.0, False), (True, True, 2.0, True)])
def test_preconditioned_forward_matches_jax(pair, clamp, dynamic, cond_scale, scalar_sigma):
    jimagen, params, timagen = pair
    x, lowres = _rand(SHAPE, 1, 3.0), _rand(SHAPE, 2)
    sigma = (np.float32(1.7) if scalar_sigma
             else np.geomspace(0.002, 80.0, B).astype(np.float32))
    kw = dict(clamp=clamp, dynamic_threshold=dynamic, cond_scale=cond_scale)
    want = jimagen.preconditioned_network_forward(
        jimagen.unets[1], params, jnp.asarray(x), jnp.asarray(sigma), jimagen.hparams[1],
        lowres_cond_img=jnp.asarray(lowres), **kw)
    with torch.no_grad():
        got = timagen.preconditioned_network_forward(
            timagen.unets[1], torch.from_numpy(x), torch.from_numpy(np.asarray(sigma)),
            timagen.hparams[1], lowres_cond_img=torch.from_numpy(lowres), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _jax_heun(jimagen, params, lowres, noise, hp, skip, self_cond=False, cond_images=None):
    """The JAX sampler's Heun loop (elucidated.py:279-409) from its public
    functions, with the noise given; with ``self_cond`` the x0 carry of
    elucidated.py:306,347-372,411; ``cond_images`` to every forward."""
    sigmas = hp.sample_schedule()
    gammas = hp.gammas(sigmas)
    s_cur, s_next, g_cur = sigmas[:-1][skip:], sigmas[1:][skip:], gammas[:-1][skip:]
    fwd = dict(clamp=True, dynamic_threshold=False, lowres_cond_img=jnp.asarray(lowres),
               cond_images=None if cond_images is None else jnp.asarray(cond_images))
    unet = jimagen.unets[1]
    img = s_cur[0] * jnp.asarray(noise[0])
    x_start = jnp.zeros_like(img)
    for i in range(s_cur.shape[0]):
        sig, sig_next, gamma = s_cur[i], s_next[i], g_cur[i]
        eps = hp.S_noise * jnp.asarray(noise[i + 1])
        sigma_hat = sig + gamma * sig
        images_hat = img + jnp.sqrt(jnp.maximum(sigma_hat ** 2 - sig ** 2, 0.0)) * eps
        out = jimagen.preconditioned_network_forward(
            unet, params, images_hat, sigma_hat, hp,
            self_cond=x_start if self_cond else None, **fwd)
        d = (images_hat - out) / sigma_hat
        img_next = images_hat + (sig_next - sigma_hat) * d
        if i < s_cur.shape[0] - 1:
            out_next = jimagen.preconditioned_network_forward(
                unet, params, img_next, sig_next, hp, self_cond=out if self_cond else None,
                **fwd)
            d_prime = (img_next - out_next) / sig_next
            img = images_hat + 0.5 * (sig_next - sigma_hat) * (d + d_prime)
            x_start = out_next
        else:
            img, x_start = img_next, out
    return np.asarray(jnp.clip(img, min=MIN_BOUND))


@pytest.mark.parametrize("skip,sigma_max", [(None, None), (1, 40.0)])
def test_heun_loop_matches_jax_loop(pair, skip, sigma_max):
    """4 EDM steps (3 corrected Heun steps with churn, one Euler step) over
    the small boundary UNet3D, z-score min_bound clamp, shared weights and
    noise; again from step 1 with a sigma_max override."""
    jimagen, params, timagen = pair
    lowres = _rand(SHAPE, 6)
    n_steps = 4 - (skip or 0)
    noise = [_rand(SHAPE, 100 + i) for i in range(n_steps + 1)]
    hp = jimagen.hparams[1]
    if sigma_max is not None:
        hp = dataclasses.replace(hp, sigma_max=sigma_max)
    want = _jax_heun(jimagen, params, lowres, noise, hp, skip or 0)

    unet = timagen.unets[1]
    got = timagen.one_unet_sample(unet, SHAPE, noise=_noise_from(noise),
                                  hp=timagen.hparams[1], dynamic_threshold=False,
                                  lowres_cond_img=torch.from_numpy(lowres),
                                  skip_steps=skip, sigma_max=sigma_max)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)
    if skip is None:
        # the cascade entry over the NullUnet stage is the same loop
        again = timagen.sample(batch_size=B, noise=_noise_from(noise), start_at_unet_number=2,
                               start_image_or_video=torch.from_numpy(lowres))
        torch.testing.assert_close(again, got, rtol=0, atol=0)


class _NoSelfCond:
    """A self-conditioned U-Net that the sampler reads as not
    self-conditioned: no ``self_cond`` is passed, so every forward
    concatenates zeros (the port's loop before it carried x0)."""

    self_cond, lowres_cond = False, True

    def __init__(self, unet):
        self.unet = unet

    def __call__(self, *args, **kwargs):
        assert "self_cond" not in kwargs
        return self.unet(*args, **kwargs)


def test_heun_loop_self_cond_matches_jax_loop():
    """A ``self_cond=True`` U-Net through 4 EDM steps (3 corrected Heun
    steps with churn, one Euler step): the first forward of a step gets the
    x0 carry (zeros at first), the correction the first forward's output,
    and the carry becomes the correction's output, or the first forward's
    on the last step, as the JAX loop does; shared weights and noise at
    fp32, within 1e-4 of the largest output. The same loop without the
    carry differs by far more."""
    kw = dict(UNET_KW, self_cond=True)
    jimagen = JElucidated([JNullUnet(), JUNet3D(**kw, att_type="linear", dtype=jnp.float32)],
                          cond_drop_prob=0.0, **EDM_KW)
    params = jimagen.init_params(jax.random.PRNGKey(2), batch_size=B)[1]
    port = UNet3D(**kw).eval()
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    timagen = ElucidatedImagen([NullUnet(), port], **EDM_KW)
    lowres = _rand(SHAPE, 8)
    noise = [_rand(SHAPE, 300 + i) for i in range(5)]
    want = _jax_heun(jimagen, params, lowres, noise, jimagen.hparams[1], 0, self_cond=True)
    sample = dict(hp=timagen.hparams[1], dynamic_threshold=False,
                  lowres_cond_img=torch.from_numpy(lowres))
    got = timagen.one_unet_sample(port, SHAPE, noise=_noise_from(noise), **sample)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    dropped = timagen.one_unet_sample(_NoSelfCond(port), SHAPE, noise=_noise_from(noise),
                                      **sample)
    assert np.abs(dropped.numpy() - want).max() > 100 * tol


def test_cond_images_through_edm_loss_and_heun_loop():
    """A U-Net with ``cond_images_channels`` 2: ``cond_images`` reach it in
    the EDM loss (against the JAX ``forward`` with its own sigma and noise
    draws, elucidated.py:568-650) and in every forward of 4 Heun steps
    (against the JAX loop of :func:`_jax_heun`), shared weights, within
    1e-4 of the largest output; the same loop without them differs."""
    kw = dict(UNET_KW, cond_images_channels=2)
    jimagen = JElucidated([JNullUnet(), JUNet3D(**kw, att_type="linear", dtype=jnp.float32)],
                          cond_drop_prob=0.0, **EDM_KW)
    junet = jimagen.unets[1]
    x, lowres, cond = _rand(SHAPE, 50), _rand(SHAPE, 51), _rand(SHAPE[:-1] + (2,), 52)
    zero_t = jnp.zeros((B,))
    params = junet.init(jax.random.PRNGKey(5), jnp.asarray(x), zero_t, zero_t,
                        lowres_cond_img=jnp.asarray(lowres), cond_images=jnp.asarray(cond))
    port = UNet3D(**kw).eval()
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    timagen = ElucidatedImagen([NullUnet(), port], **EDM_KW)
    hp = jimagen.hparams[1]

    key = jax.random.PRNGKey(9)
    want = jimagen.forward([None, params], key, jnp.asarray(x), jnp.asarray(lowres),
                           unet_number=2, cond_images=jnp.asarray(cond))
    _, _, _, k_sigma, k_noise = jax.random.split(key, 5)
    sigmas = np.asarray(hp.noise_distribution(k_sigma, B))
    noise = np.asarray(jax.random.normal(k_noise, SHAPE))
    with torch.no_grad():
        got = timagen.forward(torch.from_numpy(x), torch.from_numpy(lowres), unet_number=2,
                              cond_images=torch.from_numpy(cond),
                              sigmas=torch.from_numpy(sigmas), noise=torch.from_numpy(noise))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)

    draws = [_rand(SHAPE, 400 + i) for i in range(5)]
    want = _jax_heun(jimagen, params, lowres, draws, hp, 0, cond_images=cond)
    sample = dict(batch_size=B, start_at_unet_number=2,
                  start_image_or_video=torch.from_numpy(lowres))
    got = timagen.sample(noise=_noise_from(draws), cond_images=torch.from_numpy(cond), **sample)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    other = timagen.sample(noise=_noise_from(draws), cond_images=torch.from_numpy(-cond),
                           **sample)
    assert np.abs(other.numpy() - want).max() > 100 * tol


def test_lowres_noise_aug_q_sample_matches_jax():
    x, eps = _rand(SHAPE, 11), _rand(SHAPE, 12)
    t = np.full((B,), 0.2, np.float32)
    got = TSched("linear").q_sample(torch.from_numpy(x), torch.from_numpy(t),
                                    torch.from_numpy(eps))[0]
    want = JSched("linear").q_sample(jnp.asarray(x), jnp.asarray(t), jnp.asarray(eps))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_unported_sample_options_raise(pair):
    """The sample options that once raised: text goes only to a U-Net whose
    forward takes it (JAX elucidated.py:211-219), so the IQT UNet3D's
    sample is unchanged by it; ``video_frames`` samples ``(B, F, size,
    size, C)``, here F = size, the same volumes. The video U-Net's paths
    are in ``tests/test_torch_video_edm.py``."""
    timagen = pair[2]
    lowres = torch.from_numpy(_rand(SHAPE, 7))
    noise = [_rand(SHAPE, 200 + i) for i in range(5)]
    kw = dict(batch_size=B, start_at_unet_number=2, start_image_or_video=lowres)
    plain = timagen.sample(noise=_noise_from(noise), **kw)
    for extra in ({"video_frames": EDGE}, {"text_embeds": torch.zeros(B, 2, 8)}):
        got = timagen.sample(noise=_noise_from(noise), **kw, **extra)
        torch.testing.assert_close(got, plain, rtol=0, atol=0)


def test_config_chooses_the_sampler():
    """Train.elucidated picks the EDM sampler (test.py:45-54); the Gaussian
    constructor refuses such a config instead of sampling the wrong chain."""
    edm = load_config("config/eval_edm.yaml")
    imagen = build_sampler(edm, device="cpu")
    assert isinstance(imagen, ElucidatedImagen)
    assert imagen.hparams[1].num_sample_steps == 64
    assert imagen.min_bound == pytest.approx(MIN_BOUND) and imagen.norm == "z-score"
    assert not imagen.lowres_noise_aug
    assert isinstance(build_sampler(load_config("config/eval_config.yaml"), device="cpu"),
                      Imagen)
    with pytest.raises(ValueError, match="elucidated"):
        imagen_from_config(edm, imagen.unets)
