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
