"""Port schedules and sampler (diffusioniqt_tpu_torch/core/schedules.py,
diffusion/gaussian.py) against the JAX package at fp32. The JAX loop draws
its noise inside (gaussian.py:282,318), so the sampling test builds the
loop here from the JAX ``Imagen.p_mean_variance`` and feeds both sides the
same numpy noise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusioniqt_tpu.core.schedules import GaussianDiffusionContinuousTimes as JSched
from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu_torch.core.schedules import GaussianDiffusionContinuousTimes as TSched
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen as TImagen
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.utils.convert import state_dict_from_jax_params

torch.set_num_threads(1)

MIN_BOUND = (0.0 - 271.64814106698583) / 377.117173547721  # eval_config z-score


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


@pytest.mark.parametrize("schedule", ["cosine", "linear"])
def test_schedule_functions_match_jax(schedule):
    js, ts = JSched(schedule, 20), TSched(schedule, 20)
    t = np.linspace(0.0, 1.0, 41).astype(np.float32)
    tt, tj = torch.from_numpy(t), jnp.asarray(t)
    np.testing.assert_allclose(ts.log_snr(tt).numpy(), np.asarray(js.log_snr(tj)),
                               rtol=1e-5, atol=1e-5)
    jc, jn = js.get_sampling_timesteps(3)
    tc_, tn = ts.get_sampling_timesteps(3)
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc), atol=1e-7)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), atol=1e-7)
    x0, xt, eps = (_rand((3, 2, 2, 2, 1), s) for s in (1, 2, 3))
    tcur, tnext = np.asarray([0.9, 0.5, 0.05], np.float32), np.asarray([0.85, 0.45, 0.0], np.float32)
    for got, want in zip(
            ts.q_posterior(*map(torch.from_numpy, (x0, xt, tcur, tnext))),
            js.q_posterior(*map(jnp.asarray, (x0, xt, tcur, tnext)))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)
    for name in ("predict_start_from_noise", "predict_start_from_v"):
        got = getattr(ts, name)(*map(torch.from_numpy, (xt, tcur, eps)))
        want = getattr(js, name)(*map(jnp.asarray, (xt, tcur, eps)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("objective,dynamic", [("x_start", False), ("noise", False),
                                               ("v", False), ("x_start", True)])
def test_p_mean_variance_matches_jax(objective, dynamic):
    kw = dict(image_sizes=(4, 4), min_bound=MIN_BOUND, channels=1, timesteps=20,
              pred_objectives=objective, dynamic_thresholding=dynamic)
    j = JImagen([JNullUnet(), JNullUnet()], cond_drop_prob=0.0, **kw)
    t = TImagen([NullUnet(), UNet3D(dim=8, init_dim=8, dim_mults=(1,), img_size=12,
                                    resnet_groups=4, num_resnet_blocks=1)], **kw)
    x, pred = _rand((3, 4, 4, 4, 1), 4), _rand((3, 4, 4, 4, 1), 5, 2.0)
    tc_, tn = np.asarray([0.7, 0.7, 0.7], np.float32), np.asarray([0.65] * 3, np.float32)
    (jm, jv, jl), jx0 = j.p_mean_variance(
        None, None, jnp.asarray(x), jnp.asarray(tc_), noise_scheduler=j.noise_schedulers[1],
        t_next=jnp.asarray(tn), model_output=jnp.asarray(pred), pred_objective=objective,
        dynamic_threshold=dynamic)
    (tm, tv, tl), tx0 = t.p_mean_variance(
        None, torch.from_numpy(x), torch.from_numpy(tc_), noise_scheduler=t.noise_schedulers[1],
        t_next=torch.from_numpy(tn), model_output=torch.from_numpy(pred),
        pred_objective=objective, dynamic_threshold=dynamic)
    for got, want in ((tm, jm), (tv, jv), (tl, jl), (tx0, jx0)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _noise_from(arrays):
    it = iter(arrays)

    def draw(shape):
        a = next(it)
        assert tuple(a.shape) == tuple(shape)
        return torch.from_numpy(a)
    return draw


def _loop_against_jax(non_uniform: bool):
    """4 ancestral steps (or, on the non-uniform grid, 4 drawn times plus
    the ends) of the cascade's stage 2 (x_start objective, z-score clamp)
    over a small boundary UNet3D with shared weights and the same noise,
    against a loop built from the JAX p_mean_variance over the JAX
    wrapper's own time grid."""
    steps, edge, b = 4, 4, 27
    unet_kw = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2),
                   channels=1, resnet_groups=4, lowres_cond=True, use_se_attn=True,
                   attend_at_middle=False, attend_at_enc=False, init_cross_embed=False,
                   deep_feature=False, boundary=True, batch_sample=True, img_size=12)
    img_kw = dict(image_sizes=(edge, edge), min_bound=MIN_BOUND, channels=1,
                  timesteps=steps, pred_objectives="x_start", dynamic_thresholding=False,
                  batch_sample=True)
    if non_uniform:
        img_kw.update(non_uniform_times=True, non_uniform_gamma=3.0)
    jimagen = JImagen([JNullUnet(), JUNet3D(**unet_kw, att_type="linear",
                                            dtype=jnp.float32)], cond_drop_prob=0.0, **img_kw)
    junet, jsched = jimagen.unets[1], jimagen.noise_schedulers[1]
    lowres = _rand((b, edge, edge, edge, 1), 6)
    params = jimagen.init_params(jax.random.PRNGKey(0), batch_size=b)[1]
    if non_uniform:  # what the JAX p_sample_loop takes (gaussian.py:322-327)
        t_cur, t_next = jsched.get_sampling_timesteps_non_uniform(
            b, gamma=jimagen.non_uniform_gamma)
    else:
        t_cur, t_next = jsched.get_sampling_timesteps(b)
    n_steps = int(t_cur.shape[0])
    noise = [_rand((b, edge, edge, edge, 1), 100 + i) for i in range(n_steps + 1)]

    img = jnp.asarray(noise[0])
    for i in range(n_steps):
        (mean, _, log_var), _ = jimagen.p_mean_variance(
            junet, params, img, t_cur[i], noise_scheduler=jsched, t_next=t_next[i],
            lowres_cond_img=jnp.asarray(lowres), pred_objective="x_start",
            dynamic_threshold=False)
        nonzero = (1.0 - (t_next[i] == 0).astype(jnp.float32)).reshape(b, 1, 1, 1, 1)
        img = mean + nonzero * jnp.exp(0.5 * log_var) * jnp.asarray(noise[i + 1])
    want = np.asarray(jnp.clip(img, min=MIN_BOUND))

    port = UNet3D(**unet_kw)
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    timagen = TImagen([NullUnet(), port], **img_kw)
    got = timagen.p_sample_loop(port, (b, edge, edge, edge, 1), noise=_noise_from(noise),
                                noise_scheduler=timagen.noise_schedulers[1],
                                lowres_cond_img=torch.from_numpy(lowres),
                                pred_objective="x_start", dynamic_threshold=False)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-4)
    # the cascade entry over the NullUnet stage is the same loop
    again = timagen.sample(batch_size=b, noise=_noise_from(noise), start_at_unet_number=2,
                           start_image_or_video=torch.from_numpy(lowres))
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    return n_steps


def test_p_sample_loop_matches_jax_loop():
    assert _loop_against_jax(non_uniform=False) == 4


def test_p_sample_loop_non_uniform_matches_jax_loop():
    """``Train.non_uniform_sampling``: the loop walks the exponentially
    weighted grid (one more step here, for the end the draw missed)."""
    assert _loop_against_jax(non_uniform=True) > 4


class _NoSelfCond:
    """A self-conditioned U-Net that a sampler reads as not self-conditioned:
    the loop passes no ``self_cond``, so every step concatenates zeros (what
    the port's samplers did before they carried x0)."""

    self_cond, lowres_cond = False, True

    def __init__(self, unet):
        self.unet = unet

    def __call__(self, *args, **kwargs):
        assert "self_cond" not in kwargs
        return self.unet(*args, **kwargs)


def test_p_sample_loop_self_cond_matches_jax_loop():
    """A ``self_cond=True`` U-Net: each ancestral step gets the previous
    step's predicted x0 (zeros at the first), as the JAX loop carries it
    (gaussian.py:345,359-365,385), on shared weights and noise at fp32,
    within 1e-4 of the largest output. The same loop without the carry
    differs by far more."""
    steps, edge, b = 3, 4, 27
    unet_kw = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2),
                   channels=1, resnet_groups=4, lowres_cond=True, self_cond=True,
                   use_se_attn=True, attend_at_middle=False, attend_at_enc=False,
                   init_cross_embed=False, deep_feature=False, boundary=True,
                   batch_sample=True, img_size=12)
    img_kw = dict(image_sizes=(edge, edge), min_bound=MIN_BOUND, channels=1,
                  timesteps=steps, pred_objectives="x_start", dynamic_thresholding=False,
                  batch_sample=True)
    jimagen = JImagen([JNullUnet(), JUNet3D(**unet_kw, att_type="linear",
                                            dtype=jnp.float32)], cond_drop_prob=0.0, **img_kw)
    junet, jsched = jimagen.unets[1], jimagen.noise_schedulers[1]
    lowres = _rand((b, edge, edge, edge, 1), 7)
    params = jimagen.init_params(jax.random.PRNGKey(1), batch_size=b)[1]
    t_cur, t_next = jsched.get_sampling_timesteps(b)
    noise = [_rand((b, edge, edge, edge, 1), 200 + i) for i in range(steps + 1)]

    img, x_start = jnp.asarray(noise[0]), jnp.zeros((b, edge, edge, edge, 1))
    for i in range(steps):
        (mean, _, log_var), x_start = jimagen.p_mean_variance(
            junet, params, img, t_cur[i], noise_scheduler=jsched, t_next=t_next[i],
            lowres_cond_img=jnp.asarray(lowres), self_cond=x_start,
            pred_objective="x_start", dynamic_threshold=False)
        nonzero = (1.0 - (t_next[i] == 0).astype(jnp.float32)).reshape(b, 1, 1, 1, 1)
        img = mean + nonzero * jnp.exp(0.5 * log_var) * jnp.asarray(noise[i + 1])
    want = np.asarray(jnp.clip(img, min=MIN_BOUND))

    port = UNet3D(**unet_kw)
    port.load_state_dict(state_dict_from_jax_params(jax.device_get(params)))
    timagen = TImagen([NullUnet(), port], **img_kw)
    kw = dict(noise_scheduler=timagen.noise_schedulers[1],
              lowres_cond_img=torch.from_numpy(lowres), pred_objective="x_start",
              dynamic_threshold=False)
    got = timagen.p_sample_loop(port, (b, edge, edge, edge, 1), noise=_noise_from(noise), **kw)
    tol = 1e-4 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    dropped = timagen.p_sample_loop(_NoSelfCond(port), (b, edge, edge, edge, 1),
                                    noise=_noise_from(noise), **kw)
    assert np.abs(dropped.numpy() - want).max() > 100 * tol


@pytest.mark.parametrize("timesteps,gamma", [(20, 10.0), (64, 1.0), (3, 30.0)])
def test_non_uniform_timesteps_match_jax(timesteps, gamma):
    """The host numpy draw of ``default_rng(seed)``: the same times, in the
    same order, both ends included, as fp32 fencepost pairs."""
    js, ts = JSched("cosine", timesteps), TSched("cosine", timesteps)
    for seed in (0, 5):
        jc, jn = js.get_sampling_timesteps_non_uniform(3, seed=seed, gamma=gamma)
        tc_, tn = ts.get_sampling_timesteps_non_uniform(3, seed=seed, gamma=gamma)
        assert tc_.dtype == torch.float32 and tc_.shape == jc.shape
        np.testing.assert_array_equal(tc_.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
        assert float(tc_[0, 0]) == 1.0 and float(tn[-1, 0]) == 0.0
        assert bool((tc_[:, 0] > tn[:, 0]).all())


def test_sample_needs_start_image_for_stage_two():
    t = TImagen([NullUnet(), UNet3D(dim=8, init_dim=8, dim_mults=(1,), img_size=12,
                                    resnet_groups=4, num_resnet_blocks=1)],
                image_sizes=(4, 4), channels=1, timesteps=2)
    with pytest.raises(ValueError, match="starting image"):
        t.sample(batch_size=27, noise=lambda s: torch.zeros(s), start_at_unet_number=2)


# ---------------------------------------------------------------------------
# the wrapper's remaining options (JAX gaussian.py:70-97, 201-209, 287-621)
# ---------------------------------------------------------------------------
# A pair of small functions standing in for a U-Net, one in each package,
# that reads every input a U-Net call gets: the noisy image, the log-SNR,
# the lowres conditioning and the conditioning images (both dropped in
# proportion to cond_drop_prob, so classifier-free guidance has something
# to mix) and the self-conditioning x0. The JAX wrapper calls ``apply`` on
# it and the port's wrapper calls it, so each test below runs the JAX
# function itself (its ``lax.scan`` loop included) with the noise it draws
# from its keys, and the port's with the same arrays.
TOY = dict(a=0.8, b=0.1, c=0.6, d=0.3, e=0.25)


class _JToy:
    lowres_cond = True

    def __init__(self, self_cond=False):
        self.self_cond = self_cond

    def cast_model_parameters(self, **_):
        return self

    def __call__(self, *args, **kwargs):
        return self.apply(None, *args, **kwargs)

    def apply(self, params, x, t, noise_cond, *, lowres_cond_img=None, cond_images=None,
              self_cond=None, cond_drop_prob=0.0, deterministic=True, rngs=None):
        keep = 1.0 - cond_drop_prob
        out = TOY["a"] * jnp.tanh(x) + TOY["b"] * noise_cond.reshape((-1,) + (1,) * (x.ndim - 1))
        if lowres_cond_img is not None:
            out = out + TOY["c"] * keep * lowres_cond_img
        if cond_images is not None:
            out = out + TOY["d"] * keep * cond_images.mean(axis=-1, keepdims=True)
        if self_cond is not None:
            out = out + TOY["e"] * self_cond
        return out


class _TToy:
    lowres_cond = True

    def __init__(self, self_cond=False):
        self.self_cond = self_cond

    def __call__(self, x, t, noise_cond, *, lowres_cond_img=None, cond_images=None,
                 self_cond=None, cond_drop_prob=0.0):
        keep = 1.0 - cond_drop_prob
        out = TOY["a"] * torch.tanh(x) + TOY["b"] * noise_cond.reshape((-1,) + (1,) * (x.dim() - 1))
        if lowres_cond_img is not None:
            out = out + TOY["c"] * keep * lowres_cond_img
        if cond_images is not None:
            out = out + TOY["d"] * keep * cond_images.mean(dim=-1, keepdim=True)
        if self_cond is not None:
            out = out + TOY["e"] * self_cond
        return out


OPT_SHAPE = (3, 6, 6, 6, 1)
OPT_KW = dict(image_sizes=(6, 6), channels=1, timesteps=8, pred_objectives="noise",
              dynamic_thresholding=False, min_bound=-3.0, norm="z-score")


def _toy_pair(self_cond=False, **kw):
    kw = {**OPT_KW, **kw}
    return (JImagen([JNullUnet(), _JToy(self_cond)], **kw),
            TImagen([NullUnet(), _TToy(self_cond)], **kw))


def _jax_sample_draws(key, shape, n_pairs, resample_times=1, inpainting=False):
    """The draws of the JAX ``Imagen.sample`` for its one sampled stage
    (gaussian.py:464, 314-315, 338-375, 295), in the port's ``NoiseFn``
    order: the initial image; per step and resample round the inpaint
    noise (inpainting only), the step's noise, the renoise (inpainting,
    every round but the last)."""
    _, sub = jax.random.split(key)
    key, init_key = jax.random.split(sub)
    draws = [jax.random.normal(init_key, shape, jnp.float32)]
    for _ in range(n_pairs):
        for r in reversed(range(resample_times)):
            key, k_inpaint, k_sample, k_renoise = jax.random.split(key, 4)
            if inpainting:
                draws.append(jax.random.normal(k_inpaint, shape))
            draws.append(jax.random.normal(k_sample, shape, jnp.float32))
            if inpainting and r != 0:
                draws.append(jax.random.normal(k_renoise, shape))
    return [np.asarray(d) for d in draws]


def _close(got, want, rel=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=rel * np.abs(want).max())


@pytest.mark.parametrize("option", ["cond_images", "cond_scale", "init_skip", "inpaint",
                                    "trajectory", "auto_normalize", "use_self_cond"])
def test_sample_options_match_jax_sample(option):
    """Each sampling option through the JAX ``Imagen.sample`` and the port's,
    on the toy U-Net, the same weights and the JAX loop's own noise:
    ``cond_images``; ``cond_scale`` 3 (guidance mixed with a null call);
    ``init_images`` plus ``skip_steps`` 3 (every third (t, t_next) pair and
    the last: 4 of 8); inpainting with 3 resample rounds and the renoise;
    ``return_trajectory`` (the steps' images and x0 stacked); the
    ``auto_normalize_img`` unnormalisation; a self-conditioned U-Net."""
    lowres = _rand(OPT_SHAPE, 20)
    kw, wrap, n_pairs, rounds = {}, {}, 8, 1
    if option == "cond_images":
        kw["cond_images"] = _rand(OPT_SHAPE[:-1] + (2,), 21)
    elif option == "cond_scale":
        kw["cond_scale"] = 3.0
        wrap["cond_drop_prob"] = 0.2
    elif option == "init_skip":
        kw.update(init_images=_rand(OPT_SHAPE, 22, 0.5), skip_steps=3)
        n_pairs = 4
    elif option == "inpaint":
        mask = (np.random.default_rng(23).random(OPT_SHAPE) > 0.5).astype(np.float32)
        kw.update(inpaint_images=_rand(OPT_SHAPE, 24), inpaint_masks=mask,
                  inpaint_resample_times=3)
        rounds = 3
    elif option == "trajectory":
        kw["return_trajectory"] = True
    elif option == "auto_normalize":
        wrap["auto_normalize_img"] = True
    jimagen, timagen = _toy_pair(self_cond=option == "use_self_cond", **wrap)
    key = jax.random.PRNGKey(11)
    common = dict(batch_size=OPT_SHAPE[0], start_at_unet_number=2)
    want = jimagen.sample([None, None], key, start_image_or_video=jnp.asarray(lowres),
                          **common, **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                       for k, v in kw.items()})
    draws = _jax_sample_draws(key, OPT_SHAPE, n_pairs, rounds, option == "inpaint")
    noise = _noise_from(draws)
    got = timagen.sample(noise=noise, start_image_or_video=torch.from_numpy(lowres),
                         **common, **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                      for k, v in kw.items()})
    if option == "trajectory":
        assert got[1].shape == got[2].shape == (8,) + OPT_SHAPE
        for g, w in zip(got, want):
            _close(g.numpy(), w)
    else:
        _close(got.numpy(), want)
    with pytest.raises(StopIteration):  # every draw of the JAX loop taken, no more
        noise(OPT_SHAPE)


def test_cond_scale_needs_guidance():
    """A ``cond_scale`` other than 1 needs a wrapper trained with
    ``cond_drop_prob > 0`` (JAX gaussian.py:232)."""
    _, timagen = _toy_pair(cond_drop_prob=0.0)
    with pytest.raises(ValueError, match="cond_drop_prob"):
        timagen.sample(batch_size=3, noise=torch.randn, start_at_unet_number=2,
                       start_image_or_video=torch.zeros(OPT_SHAPE), cond_scale=2.0)


@pytest.mark.parametrize("objective,gamma,k,normalize", [
    ("noise", 0.5, 2.0, False), ("x_start", 1.0, 1.0, True), ("v", 0.0, 1.0, True)])
def test_p_losses_options_match_jax(objective, gamma, k, normalize):
    """The loss with ``cond_images``, ``cond_drop_prob`` 0.3 (the toy reads
    it), p2 weighting with ``p2_loss_weight_k``, and ``auto_normalize_img``
    (images and lowres to [-1, 1]) against the JAX ``p_losses``; and
    ``forward`` with the JAX ``forward``'s own draws (gaussian.py:603-606,
    518-519)."""
    jimagen, timagen = _toy_pair(cond_drop_prob=0.3, p2_loss_weight_k=k,
                                 auto_normalize_img=normalize, pred_objectives=objective,
                                 p2_loss_weight_gamma=gamma)
    x0, lowres, noise = (_rand(OPT_SHAPE, s) for s in (30, 31, 32))
    cond = _rand(OPT_SHAPE[:-1] + (3,), 33)
    times = np.asarray([0.1, 0.5, 0.9], np.float32)
    sched = (jimagen.noise_schedulers[1], timagen.noise_schedulers[1])
    want = jimagen.p_losses(_JToy(), None, jax.random.PRNGKey(0), jnp.asarray(x0),
                            jnp.asarray(times), noise_scheduler=sched[0],
                            lowres_cond_img=jnp.asarray(lowres), cond_images=jnp.asarray(cond),
                            noise=jnp.asarray(noise), pred_objective=objective,
                            p2_loss_weight_gamma=gamma)
    got = timagen.p_losses(_TToy(), torch.from_numpy(x0), torch.from_numpy(times),
                           noise_scheduler=sched[1], lowres_cond_img=torch.from_numpy(lowres),
                           cond_images=torch.from_numpy(cond), noise=torch.from_numpy(noise),
                           pred_objective=objective, p2_loss_weight_gamma=gamma)
    for g, w in zip(got, want):
        _close(g.numpy(), w)

    key = jax.random.PRNGKey(4)
    jloss = jimagen.forward([None, None], key, jnp.asarray(x0), jnp.asarray(lowres),
                            unet_number=2, cond_images=jnp.asarray(cond))[0]
    key, t_key = jax.random.split(key)
    j_times = sched[0].sample_random_times(t_key, OPT_SHAPE[0])
    j_noise = jax.random.normal(jax.random.split(key)[1], OPT_SHAPE)
    tloss = timagen.forward(torch.from_numpy(x0), torch.from_numpy(lowres), unet_number=2,
                            cond_images=torch.from_numpy(cond),
                            times=torch.from_numpy(np.asarray(j_times)),
                            noise=torch.from_numpy(np.asarray(j_noise)))[0]
    _close(tloss.numpy(), jloss)


def test_only_train_unet_number_refuses_another_unet():
    jimagen, timagen = _toy_pair(only_train_unet_number=1)
    x = torch.zeros(OPT_SHAPE)
    with pytest.raises(ValueError, match="trains unet 1 only"):
        timagen.forward(x, x, unet_number=2, generator=torch.Generator())
    with pytest.raises(AssertionError):
        jimagen.forward([None, None], jax.random.PRNGKey(0), jnp.zeros(OPT_SHAPE),
                        jnp.zeros(OPT_SHAPE), unet_number=2)
    _, ok = _toy_pair(only_train_unet_number=2)
    assert torch.isfinite(ok.forward(x, x, unet_number=2, generator=torch.Generator())[0])


def test_q_sample_from_to_matches_jax():
    js, ts = JSched("cosine", 20), TSched("cosine", 20)
    x, eps = _rand((3, 2, 2, 2, 1), 40), _rand((3, 2, 2, 2, 1), 41)
    t_from, t_to = np.asarray([0.2, 0.5, 0.0], np.float32), np.asarray([0.3, 0.9, 0.05], np.float32)
    want = js.q_sample_from_to(jnp.asarray(x), jnp.asarray(t_from), jnp.asarray(t_to),
                               jnp.asarray(eps))
    got = ts.q_sample_from_to(*map(torch.from_numpy, (x, t_from, t_to, eps)))
    _close(got.numpy(), want)
    want = js.q_sample_from_to(jnp.asarray(x), 0.25, 0.75, jnp.asarray(eps))
    got = ts.q_sample_from_to(torch.from_numpy(x), 0.25, 0.75, torch.from_numpy(eps))
    _close(got.numpy(), want)
