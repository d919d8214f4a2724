"""The video U-Net in its other options and inside the EDM wrapper against
the JAX package at fp32 on the CPU: ``ignore_time`` image mode with lowres
conditioning (and self-conditioning, conditioning images, the
memory-efficient layout, the cross-embed stem, linear attention and
cosine similarity), the preconditioned forward with guidance
(``cond_scale`` 3: the second evaluation drops the text), an EDM
``sample(video_frames=4, text_embeds=...)`` of the cascade test's tiny
model against the JAX ``sample`` on the draws its keys give, and the EDM
loss of a video batch on the same draws. The JAX ``forward`` resizes every
axis between the batch and the channels to the stage's size
(elucidated.py:623), the frame axis too; the port does the same, and the
loss test shows both giving the U-Net 16 frames for a 4-frame video.
Parameters are filled as in ``tests/test_torch_video.py``; tolerance 1e-4
of the largest JAX output entry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from diffusioniqt_tpu.models import unet_video as jv
from diffusioniqt_tpu.ops.volume import resize_volume as j_resize_volume
from diffusioniqt_tpu.utils import t5 as jt5
from diffusioniqt_tpu_torch import model_configs as tmc
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.models import unet_video as tv
from diffusioniqt_tpu_torch.ops.volume import resize_volume
from diffusioniqt_tpu_torch.utils import t5 as tt5
from diffusioniqt_tpu_torch.utils.convert import video_state_dict_from_jax_params
from test_torch_video import VIDEO_UNET, fill_params

torch.set_num_threads(1)

REL = 1e-4
# ignore_time + lowres_cond, with the options the text model leaves off
OPTIONS_UNET = dict(VIDEO_UNET, lowres_cond=True, temporal_strides=(1, 1), self_cond=True,
                    cond_images_channels=2, memory_efficient=True, init_cross_embed=True,
                    init_cross_embed_kernel_sizes=(3, 5), use_linear_attn=True,
                    use_linear_cross_attn=True, cosine_sim_attn=True, time_causal_attn=False,
                    init_conv_to_final_conv_residual=True)
# tests/test_cascade_video.py::tiny_video_unet
TINY_UNET = dict(VIDEO_UNET, layer_attns=(False, False), temporal_strides=(1, 1))
EDM_KW = dict(image_sizes=(16,), channels=1, auto_normalize_img=True, num_sample_steps=3,
              dynamic_thresholding=False, norm="min-max")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _pair(jmod, kw, seed, *args, **kwargs):
    shapes = jax.eval_shape(lambda k: jmod.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    params = fill_params(shapes, seed)
    port = tv.Unet3DVideo(**kw)
    port.load_state_dict(video_state_dict_from_jax_params(params))
    return params, port.eval()


def _noise_from(arrays):
    it = iter(arrays)

    def draw(shape):
        a = next(it)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(np.array(a))
    return draw


def test_options_unet_matches_jax_with_and_without_time():
    """Lowres conditioning with its noise level, self-conditioning,
    conditioning images at half the size (trilinear resize), the
    memory-efficient layout, a two-kernel cross-embed stem, linear
    (cross-)attention, cosine similarity, non-causal temporal attention
    and the init-conv residual; once with time and once in ``ignore_time``
    image mode."""
    jmod = jv.Unet3DVideo(**OPTIONS_UNET, dtype=jnp.float32)
    b, t = 2, np.asarray([0.4, -0.8], np.float32)
    text = _rand((b, 5, 16), 1)

    def inputs(frames, seed):
        return dict(x=_rand((b, frames, 16, 16, 1), seed),
                    lowres_cond_img=_rand((b, frames, 16, 16, 1), seed + 1),
                    self_cond=_rand((b, frames, 16, 16, 1), seed + 2),
                    cond_images=_rand((b, frames, 8, 8, 2), seed + 3))

    def call(fn, inp, lowres_t, to, **kw):
        inp = {k: to(v) for k, v in inp.items()}
        return fn(inp.pop("x"), to(t), to(t), lowres_noise_times=to(lowres_t),
                  text_embeds=to(text), **inp, **kw)

    lowres_t = np.asarray([0.1, 0.0], np.float32)
    params, port = _pair(jmod, OPTIONS_UNET, 2, **{**inputs(4, 10), "time_steps": t,
                                                   "time": t, "lowres_noise_times": lowres_t,
                                                   "text_embeds": text})
    for ignore_time in (False, True):
        inp = inputs(4, 20)
        want = call(lambda *a, **k: jmod.apply(params, *a, **k), inp, lowres_t, jnp.asarray,
                    ignore_time=ignore_time)
        with torch.no_grad():
            got = call(port, inp, lowres_t, torch.from_numpy, ignore_time=ignore_time)
        _close(got, want)


@pytest.fixture(scope="module")
def tiny_edm():
    """The cascade test's EDM wrapper over its tiny text video U-Net, in
    both packages with the same filled weights. The final conv's fill is
    scaled by 0.05, so that the raw U-Net output has a standard deviation
    of about 0.15, a denoiser's range: the unscaled fill's is about 3,
    and three Heun steps from sigma 80 multiply such an output's fp32
    rounding (1.8e-5 after guidance, against 1.0 after the clamp) about
    15-fold at the step from 80 to 2.5. The JAX sampler runs its Heun scan
    as a Python loop (``jax.disable_jit``), which shares its op cache with
    the preconditioned-forward test."""
    jedm = JElucidated([jv.Unet3DVideo(**TINY_UNET, dtype=jnp.float32)], cond_drop_prob=0.0,
                       **EDM_KW)
    x, t = np.zeros((1, 4, 16, 16, 1), np.float32), np.zeros((1,), np.float32)
    shapes = jax.eval_shape(lambda k: jedm.unets[0].init(
        k, x, t, t, text_embeds=np.zeros((1, 8, 16), np.float32)), jax.random.PRNGKey(0))
    params = fill_params(shapes, 3)
    params["params"]["final_conv"] = {k: v * 0.05
                                      for k, v in params["params"]["final_conv"].items()}
    port = tv.Unet3DVideo(**TINY_UNET)
    port.load_state_dict(video_state_dict_from_jax_params(params))
    return jedm, [params], ElucidatedImagen([port.eval()], **EDM_KW)


def _text(batch):
    emb, mask = jt5.hash_text_encode(["a brain mri", "an axial t2 flair slice"][:batch],
                                     dim=16, max_length=8, return_attn_mask=True)
    return emb, mask


def test_preconditioned_forward_with_guidance_matches_jax(tiny_edm):
    """``cond_scale`` 3: the second evaluation runs with
    ``cond_drop_prob=1``, which the video U-Net turns into the null text;
    the guided output differs from the unguided one."""
    jedm, params, edm = tiny_edm
    x, sigma = _rand((2, 4, 16, 16, 1), 30, 2.0), np.asarray([0.7, 9.0], np.float32)
    emb, mask = _text(2)
    outs = []
    for cond_scale in (1.0, 3.0):
        with jax.disable_jit():
            want = jedm.preconditioned_network_forward(
                jedm.unets[0], params[0], jnp.asarray(x), jnp.asarray(sigma), jedm.hparams[0],
                cond_scale=cond_scale, text_embeds=jnp.asarray(emb),
                text_mask=jnp.asarray(mask))
        with torch.no_grad():
            got = edm.preconditioned_network_forward(
                edm.unets[0], torch.from_numpy(x), torch.from_numpy(sigma), edm.hparams[0],
                cond_scale=cond_scale, text_embeds=torch.from_numpy(emb),
                text_mask=torch.from_numpy(mask))
        _close(got, want)
        outs.append(got)
    assert not torch.allclose(outs[0], outs[1])


def _jax_sample_noise(key, shape, n_steps):
    """What the JAX ``sample`` draws for its one stage (elucidated.py:508,
    292-293, 326): the stage's key, the initial image, then one eps per
    step, in the order the port's ``NoiseFn`` is asked for them."""
    _, _, k_sample = jax.random.split(key, 3)
    key, init_key = jax.random.split(k_sample)
    draws = [jax.random.normal(init_key, shape, jnp.float32)]
    for _ in range(n_steps):
        key, k_eps, _ = jax.random.split(key, 3)
        draws.append(jax.random.normal(k_eps, shape, jnp.float32))
    return [np.asarray(d) for d in draws]


def test_video_sample_matches_jax_sample(tiny_edm):
    """``sample(video_frames=4, text_embeds, text_mask, cond_scale=3)``:
    3 EDM steps with churn, each forward beside its null-text forward,
    against the JAX ``sample`` with the same weights and its own draws."""
    jedm, params, edm = tiny_edm
    emb, mask = _text(2)
    key = jax.random.PRNGKey(2)
    kw = dict(batch_size=2, video_frames=4, cond_scale=3.0)
    with jax.disable_jit():
        want = np.asarray(jedm.sample(params, key, text_embeds=jnp.asarray(emb),
                                      text_mask=jnp.asarray(mask), **kw))
    noise = _jax_sample_noise(key, (2, 4, 16, 16, 1), 3)
    got = edm.sample(noise=_noise_from(noise), text_embeds=torch.from_numpy(emb),
                     text_mask=torch.from_numpy(mask), **kw)
    assert got.shape == want.shape == (2, 4, 16, 16, 1)
    _close(got, want)


def test_video_loss_matches_jax_and_resizes_the_frames(tiny_edm):
    """The EDM loss of a 4-frame video with text on the JAX ``forward``'s
    draws: both packages resize the frame axis to the stage's 16 (the
    reference resizes only H and W), and the losses agree."""
    jedm, params, edm = tiny_edm
    videos = np.random.default_rng(40).uniform(size=(1, 4, 16, 16, 1)).astype(np.float32)
    emb, mask = _text(1)
    key = jax.random.PRNGKey(1)
    want = jedm.forward(params, key, jnp.asarray(videos), unet_number=1,
                        text_embeds=jnp.asarray(emb), text_mask=jnp.asarray(mask))
    _, _, _, k_sigma, k_noise = jax.random.split(key, 5)
    sigmas = np.asarray(jedm.hparams[0].noise_distribution(k_sigma, 1))
    noise = np.asarray(jax.random.normal(k_noise, (1, 16, 16, 16, 1), jnp.float32))
    frames = []
    hook = edm.unets[0].register_forward_pre_hook(lambda m, a: frames.append(a[0].shape[1]))
    try:
        got = edm.forward(torch.from_numpy(videos), unet_number=1,
                          text_embeds=torch.from_numpy(emb), text_mask=torch.from_numpy(mask),
                          sigmas=torch.from_numpy(sigmas), noise=torch.from_numpy(noise))
    finally:
        hook.remove()
    assert frames == [16]
    np.testing.assert_allclose(got.item(), float(want), rtol=REL)
    resized = resize_volume(torch.from_numpy(videos), 16)
    np.testing.assert_array_equal(resized.numpy(),
                                  np.asarray(j_resize_volume(jnp.asarray(videos), 16)))
    assert resized.shape == (1, 16, 16, 16, 1)


def test_model_config_video_kind_and_text_on_the_device():
    """``UnetConfig(kind="video")`` builds the port's ``Unet3DVideo`` from
    the JSON's fields (fp32 on the CPU), and ``hash_text_encode`` puts its
    embeddings on the device it is given."""
    raw = {k: list(v) if isinstance(v, tuple) else v for k, v in TINY_UNET.items()}
    unet = tmc.UnetConfig.from_dict({"kind": "video", **raw}).create("cpu")
    assert isinstance(unet, tv.Unet3DVideo) and unet.dtype == torch.float32
    assert unet.text_embed_dim == 16 and unet.max_text_len == 8
    emb, mask = tt5.hash_text_encode(["a"], dim=16, max_length=8, return_attn_mask=True,
                                     device=torch.device("cpu"))
    with torch.no_grad():
        out = unet(torch.zeros(1, 4, 16, 16, 1), torch.zeros(1), torch.zeros(1),
                   text_embeds=emb, text_mask=mask)
    assert out.shape == (1, 4, 16, 16, 1) and torch.all(out == 0)  # zero-initialised out conv
