"""The port's training slice (diffusioniqt_tpu_torch/train, the losses of
diffusion/gaussian.py and diffusion/elucidated.py, utils/checkpoints.py,
the optax-to-torch Adam state map) against the JAX package at fp32, on the
small boundary U-Net of tests/test_torch_edm.py.

The JAX trainer draws its times, sigmas and noise from its key stream
(trainer.py:163-165,327-331; gaussian.py:598-606,511-512;
elucidated.py:597,637-640). The tests derive those draws from the key the
JAX trainer holds before each step and pass them to the port's
``train_step(draws=...)``, so both trainers take the same steps.

Shared initial weights come from the flax parameter shapes with a fan-in
scaled normal init, made with numpy: the JAX trainers' ``init_params`` is
replaced by them, which spares the compile of ``UNet3D.init``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffusioniqt_tpu.diffusion.elucidated import ElucidatedImagen as JElucidated
from diffusioniqt_tpu.diffusion.gaussian import _LOSSES as JLOSSES
from diffusioniqt_tpu.diffusion.gaussian import Imagen as JImagen
from diffusioniqt_tpu.models.unet3d import NullUnet as JNullUnet
from diffusioniqt_tpu.models.unet3d import UNet3D as JUNet3D
from diffusioniqt_tpu.train import ema as jema
from diffusioniqt_tpu.train.trainer import ImagenTrainer as JTrainer
from diffusioniqt_tpu.utils.torch_convert import convert_reference_checkpoint
from diffusioniqt_tpu_torch.config import load_config
from diffusioniqt_tpu_torch.diffusion.elucidated import ElucidatedImagen
from diffusioniqt_tpu_torch.diffusion.gaussian import Imagen
from diffusioniqt_tpu_torch.models.unet3d import NullUnet, UNet3D
from diffusioniqt_tpu_torch.train import ema as tema
from diffusioniqt_tpu_torch.train.trainer import (
    ImagenTrainer,
    clip_by_global_norm_,
    lr_schedule,
)
from diffusioniqt_tpu_torch.utils.checkpoints import restore_parts
from diffusioniqt_tpu_torch.utils.convert import (
    adam_state_from_optax,
    state_dict_from_jax_params,
)

torch.set_num_threads(1)

MIN_BOUND = (0.0 - 271.64814106698583) / 377.117173547721  # eval_edm z-score
B, EDGE = 27, 4  # one group of 3^3 sub-volumes of 4^3
SHAPE = (B, EDGE, EDGE, EDGE, 1)
UNET_KW = dict(dim=8, init_dim=8, num_resnet_blocks=(1, 1), dim_mults=(1, 2), channels=1,
               resnet_groups=4, lowres_cond=True, use_se_attn=True, attend_at_middle=False,
               attend_at_enc=False, init_cross_embed=False, deep_feature=False,
               boundary=True, batch_sample=True, img_size=12)
G_KW = dict(image_sizes=(EDGE, EDGE), channels=1, timesteps=1000, dynamic_thresholding=False,
            min_bound=MIN_BOUND, norm="z-score", batch_sample=True)
E_KW = dict(image_sizes=(EDGE, EDGE), channels=1, auto_normalize_img=False,
            dynamic_thresholding=False, norm="z-score", min_bound=MIN_BOUND,
            lowres_noise_aug=False, num_sample_steps=4, sigma_data=1.0)
LR = 1e-3
TRAIN_KW = dict(gradient_accumulation_steps=2, ema_update_every=1, ema_update_after_step=0,
                lr=LR)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _init_params(module, seed):
    """flax variables of ``module`` at the IQT shapes: kernels N(0, 1/fan_in),
    biases and norm shifts N(0, 0.01), norm scales 1 + N(0, 0.01), the rest
    N(0, 1)."""
    x = jnp.zeros(SHAPE)
    t = jnp.zeros((B,))
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), x, t, t,
                                                lowres_cond_img=x))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = str(path[-1].key)
        if name == "kernel":
            return (rng.standard_normal(s.shape) * np.prod(s.shape[:-1]) ** -0.5).astype(np.float32)
        if name in ("bias", "norm_bias"):
            return (0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        if name == "norm_scale":
            return (1.0 + 0.1 * rng.standard_normal(s.shape)).astype(np.float32)
        return rng.standard_normal(s.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _jax_unet():
    return JUNet3D(**UNET_KW, att_type="linear", dtype=jnp.float32)


def _port_unet(params) -> UNet3D:
    unet = UNet3D(**UNET_KW)
    unet.load_state_dict(state_dict_from_jax_params(params))
    return unet


def _gaussian_draws(key, sched):
    """What Imagen.forward / p_losses draw from one microbatch key."""
    key, t_key = jax.random.split(key)
    times = jnp.broadcast_to(sched.sample_random_times(t_key, 1), (B,))
    _, noise_key = jax.random.split(key)
    return {"times": _t(times), "noise": _t(jax.random.normal(noise_key, SHAPE))}


def _edm_draws(key, hp, sched, aug=False, per_sample=False):
    """What ElucidatedImagen.forward draws from one microbatch key."""
    _, k_aug_t, k_aug_n, k_sigma, k_noise = jax.random.split(key, 5)
    out = {"sigmas": _t(hp.noise_distribution(k_sigma, B)),
           "noise": _t(jax.random.normal(k_noise, SHAPE, jnp.float32))}
    if aug:
        times = (sched.sample_random_times(k_aug_t, B) if per_sample
                 else jnp.broadcast_to(sched.sample_random_times(k_aug_t, 1), (B,)))
        out["aug_times"] = _t(times)
        out["aug_noise"] = _t(jax.random.normal(k_aug_n, SHAPE))
    return out


def _jax_train(jt, batches, draws_of):
    """Two JAX trainer steps; per step the microbatch draws its keys give."""
    jt.prepare()
    out = {"draws": [], "losses": []}
    for hr, lr in batches:
        _, sub = jax.random.split(jt._key)  # what train_step's _next_key returns
        out["draws"].append([draws_of(k) for k in jax.random.split(sub, 2)])
        out["losses"].append(jt.train_step(unet_number=2, batch=(hr, lr)))
    out["params"] = jax.device_get(jt.params[1])
    out["opt"] = jax.device_get(jt.opt_states[1])
    out["ema"] = jax.device_get(jt.ema_states[1].params)
    return out


@pytest.fixture(scope="module")
def runs():
    """Shared weights, two batches of 54 sub-volumes, and two steps of the
    JAX trainer with accum 2 for the Gaussian x_start wrapper and for EDM."""
    null = jax.device_get(jax.eval_shape(lambda: JNullUnet().init(
        jax.random.PRNGKey(0), jnp.zeros(SHAPE))))
    null = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), null)
    params0 = _init_params(_jax_unet(), seed=0)
    batches = [(_rand((2 * B,) + SHAPE[1:], s), _rand((2 * B,) + SHAPE[1:], s + 1))
               for s in (1, 3)]

    def init_params(key, batch_size=1):
        return [jax.tree_util.tree_map(jnp.asarray, p) for p in (null, params0)]

    jg = JImagen([JNullUnet(), _jax_unet()], pred_objectives="x_start",
                 p2_loss_weight_gamma=0.0, **G_KW)
    jg.init_params = init_params
    gaussian = _jax_train(JTrainer(None, jg, **TRAIN_KW), batches,
                          lambda k: _gaussian_draws(k, jg.noise_schedulers[1]))
    je = JElucidated([JNullUnet(), _jax_unet()], cond_drop_prob=0.0, **E_KW)
    je.init_params = init_params
    edm = _jax_train(JTrainer(None, je, **TRAIN_KW), batches,
                     lambda k: _edm_draws(k, je.hparams[1], je.lowres_noise_schedule))
    return dict(params0=params0, batches=batches, gaussian=gaussian, edm=edm)


def _port_trainer(runs, edm: bool, **kw) -> ImagenTrainer:
    unets = [NullUnet(), _port_unet(runs["params0"])]
    imagen = (ElucidatedImagen(unets, **E_KW) if edm
              else Imagen(unets, pred_objectives="x_start", p2_loss_weight_gamma=0.0, **G_KW))
    return ImagenTrainer(None, imagen, **{**TRAIN_KW, **kw})


# ---------------------------------------------------------------------------
# EMA
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 100, 101, 5000])
@pytest.mark.parametrize("after", [100, 0])
def test_ema_matches_jax(step, after):
    kw = dict(beta=0.9999, update_after_step=after)
    want = float(jema.ema_decay_schedule(jnp.asarray(step), **kw))
    assert tema.ema_decay_schedule(step, **kw) == want
    ema_w, new_w = _rand((5, 7), step), _rand((5, 7), step + 1)
    state = jema.EMAState(params={"w": jnp.asarray(ema_w)}, step=jnp.zeros((), jnp.int32))
    got_state = jema.ema_update(state, {"w": jnp.asarray(new_w)}, step, **kw)
    ema_mod, online = torch.nn.Linear(7, 5, bias=False), torch.nn.Linear(7, 5, bias=False)
    with torch.no_grad():
        ema_mod.weight.copy_(torch.from_numpy(ema_w))
        online.weight.copy_(torch.from_numpy(new_w))
    decay = tema.ema_update(ema_mod, online, step, **kw)
    assert decay == want
    np.testing.assert_allclose(ema_mod.weight.detach().numpy(),
                               np.asarray(got_state.params["w"]), rtol=1e-6, atol=1e-7)
    if want == 0.0:  # before the ramp the EMA is the online copy, exactly
        assert torch.equal(ema_mod.weight, online.weight)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------

def _port_grads(unet, loss):
    unet.zero_grad(set_to_none=True)
    loss.backward()
    return {k: p.grad for k, p in unet.named_parameters()}


def _assert_grads(got, jax_grads, rtol=1e-4):
    """Every parameter's gradient within ``rtol`` of the largest entry of
    its tensor (fp32 sums in other orders through two U-Net passes)."""
    want = state_dict_from_jax_params(jax_grads)
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = want[k].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=rtol * float(np.abs(w).max()) + 1e-9, err_msg=k)


# every objective, loss type and the p2 weighting, each in one case
OBJECTIVES = [("noise", 0.5, "l2"), ("x_start", 0.0, "l1"), ("v", 0.0, "huber")]


@pytest.fixture(scope="module")
def japply():
    """``UNet3D.apply`` of the small U-Net, jitted once for every JAX loss
    below (they call it at the same shapes); the kwargs that this U-Net
    ignores (``cond_drop_prob``, ``deterministic``, ``self_cond``,
    ``cond_images``, all at their inert values here) are dropped, so each
    wrapper's call hits the same compiled forward and backward. The loss
    code around it runs op by op."""
    core = jax.jit(lambda p, x, t, c, low: _jax_unet().apply(p, x, t, c, lowres_cond_img=low))

    def apply(p, x, t, c, lowres_cond_img=None, **_):
        return core(p, x, t, c, lowres_cond_img)
    return apply


def _with_apply(wrapper, apply):
    object.__setattr__(wrapper.unets[1], "apply", apply)
    return wrapper


@pytest.fixture(scope="module")
def jax_p_losses(runs, japply):
    """The JAX p_losses of the three objectives (p2 weighting on the noise
    one): loss, prediction and jax.grad."""
    jg = _with_apply(JImagen([JNullUnet(), _jax_unet()], **G_KW), japply)
    params = runs["params0"]
    x, low = jnp.asarray(_rand(SHAPE, 10)), jnp.asarray(_rand(SHAPE, 11))
    noise = jnp.asarray(_rand(SHAPE, 12))
    times = jnp.linspace(0.02, 0.98, B, dtype=jnp.float32)

    def loss(p, obj, gamma, loss_type):
        jg.loss_fn = JLOSSES[loss_type]
        loss, pred, _, _ = jg.p_losses(jg.unets[1], p, jax.random.PRNGKey(0), x, times,
                                       noise_scheduler=jg.noise_schedulers[1],
                                       lowres_cond_img=low, noise=noise,
                                       pred_objective=obj, p2_loss_weight_gamma=gamma)
        return loss, pred

    out = [jax.value_and_grad(loss, has_aux=True)(params, *case) for case in OBJECTIVES]
    return dict(x=x, low=low, noise=noise, times=times, out=jax.device_get(out))


@pytest.mark.parametrize("index", range(len(OBJECTIVES)))
def test_p_losses_match_jax(runs, jax_p_losses, index):
    """The three objectives with the same times and noise: the loss, the
    prediction (min_bound-clamped for x_start) and every gradient."""
    obj, gamma, loss_type = OBJECTIVES[index]
    d = jax_p_losses
    (want_loss, want_pred), want_grads = d["out"][index]
    unet = _port_unet(runs["params0"])
    imagen = Imagen([NullUnet(), unet], pred_objectives=obj, p2_loss_weight_gamma=gamma,
                    loss_type=loss_type, **G_KW)
    loss, pred, _, _ = imagen.p_losses(unet, _t(d["x"]), _t(d["times"]),
                                       noise_scheduler=imagen.noise_schedulers[1],
                                       lowres_cond_img=_t(d["low"]), noise=_t(d["noise"]),
                                       pred_objective=obj, p2_loss_weight_gamma=gamma)
    np.testing.assert_allclose(pred.detach().numpy(), want_pred, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)
    if obj == "x_start":
        assert float(pred.detach().min()) >= MIN_BOUND
    _assert_grads(_port_grads(unet, loss), want_grads)


def test_forward_draws_one_time_per_batch_sample_group():
    """Under batch_sample one diffusion time is shared by the microbatch;
    without it each sub-volume gets its own; the lowres image is required."""
    unet = UNet3D(**UNET_KW)
    seen = []

    class Spy(torch.nn.Module):
        lowres_cond = True

        def forward(self, x, t, cond, **kw):
            seen.append(t)
            return unet(x, t, cond, **kw)

    x, low = torch.from_numpy(_rand(SHAPE, 1)), torch.from_numpy(_rand(SHAPE, 2))
    for batch_sample in (True, False):
        imagen = Imagen([NullUnet(), Spy()], **{**G_KW, "batch_sample": batch_sample})
        imagen.forward(x, low, unet_number=2, generator=torch.Generator().manual_seed(0))
        assert (len(set(seen[-1].tolist())) == 1) == batch_sample
    with pytest.raises(ValueError, match="lowres"):
        imagen.forward(x, None, unet_number=2, generator=torch.Generator())


EDM_VARIANTS = ["clean", "aug", "aug_per_sample", "resize"]


def _edm_wrappers(variant):
    kw = dict(E_KW)
    if variant.startswith("aug"):
        kw["lowres_noise_aug"] = True
        kw["per_sample_random_aug_noise_level"] = variant == "aug_per_sample"
    if variant == "resize":
        kw["image_sizes"] = (2, EDGE)
    return kw


@pytest.fixture(scope="module")
def jax_edm(runs, japply):
    """The JAX EDM loss (return_outputs) and jax.grad for the clean-lowres,
    noise-augmented and down-up-resized conditioning."""
    params = runs["params0"]
    x, low = jnp.asarray(_rand(SHAPE, 20)), jnp.asarray(_rand(SHAPE, 21))
    key = jax.random.PRNGKey(7)
    wrappers = {v: _with_apply(JElucidated([JNullUnet(), _jax_unet()], cond_drop_prob=0.0,
                                           **_edm_wrappers(v)), japply)
                for v in EDM_VARIANTS}

    def loss(p, v):
        low_v = None if v == "resize" else low
        out = wrappers[v].forward([None, p], key, x, low_v, unet_number=2,
                                  return_outputs=True)
        return out[0], out

    out = {v: jax.grad(loss, has_aux=True)(params, v)[::-1] for v in EDM_VARIANTS}
    return dict(x=x, low=low, key=key, wrappers=wrappers, out=jax.device_get(out))


@pytest.mark.parametrize("variant", EDM_VARIANTS)
def test_edm_forward_matches_jax(runs, jax_edm, variant):
    """Lognormal sigmas per sub-volume and the loss weight, with the lowres
    conditioning clean, noise-augmented, or made by resizing; the loss, the
    denoised output, the noised input, the conditioning and every gradient."""
    d = jax_edm
    (want_loss, want_den, want_noised, want_low), want_grads = d["out"][variant]
    jw = d["wrappers"][variant]
    draws = _edm_draws(d["key"], jw.hparams[1], jw.lowres_noise_schedule,
                       aug=variant.startswith("aug"), per_sample=variant == "aug_per_sample")
    unet = _port_unet(runs["params0"])
    imagen = ElucidatedImagen([NullUnet(), unet], **_edm_wrappers(variant))
    low = None if variant == "resize" else _t(d["low"])
    loss, den, noised, low_noisy = imagen.forward(_t(d["x"]), low, unet_number=2,
                                                  return_outputs=True, **draws)
    np.testing.assert_allclose(noised.numpy(), want_noised, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(low_noisy.numpy(), want_low, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(den.detach().numpy(), want_den, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    _assert_grads(_port_grads(unet, loss), want_grads)
    # the scalar-loss form and a generator draw run too
    again = imagen.forward(_t(d["x"]), low, unet_number=2,
                           generator=torch.Generator().manual_seed(0))
    assert again.dim() == 0 and torch.isfinite(again)


# ---------------------------------------------------------------------------
# optimizer pieces against optax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("warmup,cosine", [(None, None), (4, None), (None, 10), (3, 10)])
def test_lr_schedule_matches_optax(warmup, cosine):
    lr = 1e-4
    if cosine is not None:
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup else lr, peak_value=lr, warmup_steps=warmup or 0,
            decay_steps=cosine, end_value=lr * 0.001)
    elif warmup is not None:
        want = optax.linear_schedule(0.0, lr, warmup)
    else:
        want = lambda n: lr  # noqa: E731
    got = lr_schedule(lr, warmup, cosine)
    for n in range(14):
        np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {n}")


@pytest.mark.parametrize("warmup,cosine", [(None, None), (2, None), (2, 5)])
def test_get_lr_and_num_steps_taken_follow_the_optax_schedule(warmup, cosine):
    """``get_lr`` is the rate the next update applies: the optax schedule
    that the JAX trainer builds (trainer.py:105-126) at the count of updates
    taken, which ``num_steps_taken`` returns; each step applies it. (The
    JAX ``get_lr`` reads 0.0 whatever the step: ``optax.adam(learning_rate=
    schedule)``'s state holds no ``learning_rate`` leaf for
    ``tree_get`` to find.)"""
    lr = 1e-3
    if cosine is not None:
        want = optax.warmup_cosine_decay_schedule(
            init_value=0.0 if warmup else lr, peak_value=lr, warmup_steps=warmup or 0,
            decay_steps=cosine, end_value=lr * 0.001)
    elif warmup is not None:
        want = optax.linear_schedule(0.0, lr, warmup)
    else:
        want = lambda n: lr  # noqa: E731
    torch.manual_seed(0)
    imagen = ElucidatedImagen([NullUnet(), UNet3D(**UNET_KW)], **E_KW)
    tr = ImagenTrainer(None, imagen, gradient_accumulation_steps=1, lr=lr,
                       warmup_steps=warmup, cosine_decay_max_steps=cosine)
    for n in range(4):
        assert tr.num_steps_taken(2) == n
        np.testing.assert_allclose(tr.get_lr(2), float(want(n)), rtol=1e-6, atol=1e-12)
        tr.train_step(unet_number=2, batch=(_rand(SHAPE, 2 * n + 1), _rand(SHAPE, 2 * n + 2)))
        np.testing.assert_allclose(tr.optimizers[1].param_groups[0]["lr"], float(want(n)),
                                   rtol=1e-6, atol=1e-12)
    assert tr.num_steps_taken(2) == 4
    with pytest.raises(ValueError):
        tr.get_lr(3)


@pytest.mark.parametrize("max_norm", [0.5, 1e3])
def test_clip_by_global_norm_matches_optax(max_norm):
    grads = {"a": _rand((3, 4), 1), "b": _rand((5,), 2)}
    want, _ = optax.clip_by_global_norm(max_norm).update(
        {k: jnp.asarray(v) for k, v in grads.items()}, optax.EmptyState())
    got = [torch.from_numpy(grads[k].copy()) for k in ("a", "b")]
    norm = clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(
        {k: jnp.asarray(v) for k, v in grads.items()})), rtol=1e-6)
    for g, k in zip(got, ("a", "b")):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-6)


def test_train_step_and_ema_bump_parameter_versions():
    """The packed-weight caches key on version counters, which the fused
    Adam on CUDA does not bump: train_step bumps every parameter's version
    after the optimizer step, here one that updates through ``.data`` (no
    bump of its own), and the EMA update bumps the EMA's."""
    imagen = ElucidatedImagen([NullUnet(), UNet3D(**UNET_KW)], **E_KW)
    tr = ImagenTrainer(None, imagen, gradient_accumulation_steps=1)
    tr.prepare()

    def step_without_bump():
        for p in tr.imagen.unets[1].parameters():
            p.data.add_(1.0)

    tr.optimizers[1].step = step_without_bump
    params = list(tr.imagen.unets[1].parameters())
    before = [p._version for p in params]
    tr.train_step(unet_number=2, batch=(_rand(SHAPE, 1), _rand(SHAPE, 2)))
    assert all(p._version > v for p, v in zip(params, before))
    ema, online = torch.nn.Linear(2, 2), torch.nn.Linear(2, 2)
    before = [q._version for q in ema.parameters()]
    tema.ema_update(ema, online, step=5, update_after_step=0)
    assert all(q._version >= v + 2 for q, v in zip(ema.parameters(), before))


def test_microbatch_rule():
    """JAX trainer.py:410-416: accum from max_batch_size, back to 1 on a
    ragged split; train.py feeds 27 sub-volumes (accum 1), the quality run
    4 x 27 (accum 4)."""
    rule = ImagenTrainer.microbatches
    assert rule(27, 4, 27) == 1
    assert rule(108, 4, 27) == 4
    assert rule(108, 1, 27) == 4
    assert rule(54, 4) == 1 and rule(54, 2) == 2


def test_train_step_splits_patches_and_microbatches():
    """A batch of four 12^3 patches under batch_sample: 108 sub-volumes of
    4^3 in four microbatches of 27, each loss on its own slice."""
    cfg = load_config("config/eval_edm.yaml")
    cfg.train.patch_size_sub, cfg.train.pretrain = EDGE, False
    unet = UNet3D(**UNET_KW)
    imagen = ElucidatedImagen([NullUnet(), unet], **E_KW)
    calls = []
    forward = imagen.forward

    def spy(images, lowres, **kw):
        calls.append((tuple(images.shape), float(images.sum())))
        return forward(images, lowres, **kw)

    imagen.forward = spy
    tr = ImagenTrainer(cfg, imagen, gradient_accumulation_steps=4)
    hr = _rand((4, 12, 12, 12, 1), 5)
    loss = tr.train_step(unet_number=2, batch=(hr, _rand((4, 12, 12, 12, 1), 6)),
                         max_batch_size=27, sync=False)
    assert isinstance(loss, torch.Tensor) and torch.isfinite(loss)
    assert [c[0] for c in calls] == [SHAPE] * 4
    from diffusioniqt_tpu_torch.ops.volume import volume_to_subvolumes
    sub = volume_to_subvolumes(torch.from_numpy(hr), 3)
    for i, (_, total) in enumerate(calls):
        assert total == pytest.approx(float(sub[27 * i:27 * (i + 1)].sum()), rel=1e-6)
    assert tr.steps == [0, 1]


@pytest.mark.parametrize("flag", ["lpips", "medlpips"])
def test_perceptual_config_trains(flag, tmp_path, monkeypatch):
    """``config/config.yaml`` (x_start, SAME convs) at dim 8 with
    ``Train.lpips`` / ``Train.medlpips``, built as the training entry point
    builds it: the step's loss is the plain loss plus ``0.1 * term(pred,
    x_start)`` (the VGG sees 32^2 slices here, 224^2 in training); the
    frozen network stays out of the optimizer, the EMA and the bundle,
    whose keys are those of a trainer without the term and which the JAX
    converter reads. An EDM config with the flag is refused: its loss has
    no perceptual term."""
    from diffusioniqt_tpu_torch.diffusion import gaussian
    from diffusioniqt_tpu_torch.metrics.lpips import SliceLPIPS
    from diffusioniqt_tpu_torch.metrics.medicalnet import MedicalNetPerceptual
    from diffusioniqt_tpu_torch.train.__main__ import build_trainer

    make = gaussian.make_lpips_fn
    monkeypatch.setattr(gaussian, "make_lpips_fn", lambda **kw: make(target_size=32, **kw))

    def trainer(with_term):
        cfg = load_config("config/config.yaml")
        for k, v in dict(dim=8, init_dim=8, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                         resnet_groups=4, patch_size_sub=8, compute_dtype="float32",
                         att_enc=(False, False)).items():
            setattr(cfg.train, k, v)
        setattr(cfg.train, flag, with_term)
        return build_trainer(cfg, "cpu")

    tr, plain = trainer(True), trainer(False)
    term = tr.imagen.lpips_fn
    assert isinstance(term, SliceLPIPS if flag == "lpips" else MedicalNetPerceptual)
    assert plain.imagen.lpips_fn is None
    hr, lr = _rand((2, 8, 8, 8, 1), 50), _rand((2, 8, 8, 8, 1), 51)
    draws = {"times": torch.tensor([0.2, 0.7]), "noise": _t(_rand((2, 8, 8, 8, 1), 52))}
    _, pred, _, _ = plain.imagen.forward(_t(hr), _t(lr), unet_number=2, **draws)
    want = plain.train_step(unet_number=2, batch=(hr, lr), draws=[draws])
    got = tr.train_step(unet_number=2, batch=(hr, lr), draws=[draws])
    expected = want + 0.1 * float(term(pred.detach(), _t(hr)))
    assert got > want and got == pytest.approx(expected, rel=1e-5)
    opt_params = {id(p) for g in tr.optimizers[1].param_groups for p in g["params"]}
    assert opt_params == {id(p) for p in tr.imagen.unets[1].parameters()}
    assert not any(p.requires_grad or p.grad is not None for p in term.parameters())
    path_a, path_b = str(tmp_path / "a.pt"), str(tmp_path / "b.pt")
    tr.save(path_a)
    plain.save(path_b)
    a, b = (torch.load(p, map_location="cpu", weights_only=True) for p in (path_a, path_b))
    assert a.keys() == b.keys()
    assert a["model"].keys() == b["model"].keys() and a["ema"].keys() == b["ema"].keys()
    assert a["optim1"]["state"].keys() == b["optim1"]["state"].keys()
    jvars = convert_reference_checkpoint(a, unet_number=2, use_ema=False)
    back = state_dict_from_jax_params(jax.device_get(jvars))
    assert all(torch.equal(back[k], v) for k, v in tr.imagen.unets[1].state_dict().items())

    cfg = load_config("config/eval_edm.yaml")
    setattr(cfg.train, flag, True)
    with pytest.raises(ValueError, match="no perceptual term"):
        ImagenTrainer(cfg, ElucidatedImagen([NullUnet(), UNet3D(**UNET_KW)], **E_KW))


# ---------------------------------------------------------------------------
# two trainer steps against the JAX trainer
# ---------------------------------------------------------------------------

def _assert_close_tree(got: dict, want: dict, rtol: float, rel_atol: float, what: str):
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(got[k].detach().numpy(), w, rtol=rtol,
                                   atol=rel_atol * float(np.abs(w).max()) + 1e-12,
                                   err_msg=f"{what} {k}")


@pytest.mark.parametrize("edm", [False, True], ids=["gaussian_x_start", "edm"])
def test_two_trainer_steps_match_jax(runs, edm):
    """Two optimizer steps of accum 2 from the same weights, batches and
    draws. Step 2 applies the EMA decay 1 - 2^(-2/3).

    Tolerances: the losses within 1e-5 and Adam's moments within 1e-4 of
    their tensor's largest entry (linear in the gradients, which agree to
    about 1e-5). The parameters: Adam's first update is about
    ``lr * g / (|g| + eps)``, so where a gradient is fp32 noise its sign,
    and a whole ``lr`` step, can differ between the two packages; every
    parameter is held within ``2 * lr`` per step of the JAX one, and those
    whose gradient is not small (|g| above 1e-3 of the tensor's largest)
    within 1e-3 of an ``lr`` step (judged by the port's gradient of each
    step). The EMA: on those same entries within 1e-3 of an ``lr`` step of
    the JAX EMA, and everywhere ``decay * p1 + (1 - decay) * p2`` of the
    port's own step-1 and step-2 parameters to fp32 rounding."""
    want = runs["edm" if edm else "gaussian"]
    tr = _port_trainer(runs, edm)
    losses, grads, stepped = [], [], []
    for b, d in zip(runs["batches"], want["draws"]):
        losses.append(tr.train_step(unet_number=2, batch=b, draws=d))
        grads.append({k: p.grad.clone() for k, p in tr.imagen.unets[1].named_parameters()})
        stepped.append({k: p.detach().clone() for k, p in tr.imagen.unets[1].named_parameters()})
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    assert tr.steps == [0, 2] and tr.ema_steps[1] == 2

    unet = tr.imagen.unets[1]
    adam = adam_state_from_optax(want["opt"])
    opt_state = tr.optimizers[1].state
    named = dict(unet.named_parameters())
    assert sorted(named) == sorted(adam)
    for k, p in named.items():
        assert int(opt_state[p]["step"]) == int(adam[k]["step"]) == 2
    for moment in ("exp_avg", "exp_avg_sq"):
        _assert_close_tree({k: opt_state[p][moment] for k, p in named.items()},
                           {k: v[moment] for k, v in adam.items()}, 1e-4, 1e-4, moment)

    params = state_dict_from_jax_params(want["params"])
    ema = state_dict_from_jax_params(want["ema"])
    ema_port = dict(tr.ema_unets[1].named_parameters())
    # step 1 copies the online weights (decay 0), step 2 lerps towards them
    decay = tema.ema_decay_schedule(2, update_after_step=0)
    assert decay == pytest.approx(1 - 2 ** (-2 / 3), rel=1e-6)
    n_firm = 0
    for k, p in named.items():
        w = params[k].numpy()
        diff = np.abs(p.detach().numpy() - w)
        assert diff.max() <= 2 * LR * 2, k
        firm = np.ones(w.shape, bool)
        for step_grads in grads:
            g = step_grads[k].abs().numpy()
            firm &= g > 1e-3 * g.max()
        n_firm += int(firm.sum())
        assert (diff[firm] <= 1e-3 * LR + 1e-6 * np.abs(w[firm])).all(), k

        e = ema[k].numpy()
        got = ema_port[k].detach()
        ema_diff = np.abs(got.numpy() - e)
        assert (ema_diff[firm] <= 1e-3 * LR + 1e-6 * np.abs(e[firm])).all(), f"ema {k}"
        torch.testing.assert_close(got, decay * stepped[0][k] + (1 - decay) * stepped[1][k],
                                   rtol=1e-6, atol=1e-7, msg=f"ema {k}")
    # the firm entries are most of the model, so the EMA check above has teeth
    assert n_firm >= 0.5 * sum(p.numel() for p in named.values())


# ---------------------------------------------------------------------------
# remat, dropout
# ---------------------------------------------------------------------------

def test_remat_grads_equal_plain_grads():
    """Full remat and the 'conv' policy give the gradients of no remat, bit
    for bit: the same backward operations, recomputed or not."""
    torch.manual_seed(0)
    plain = UNet3D(**UNET_KW)
    remat = UNet3D(**UNET_KW, remat=True)
    conv = UNet3D(**UNET_KW, remat=True, remat_policy="conv")
    remat.load_state_dict(plain.state_dict())
    conv.load_state_dict(plain.state_dict())
    x, low = torch.from_numpy(_rand(SHAPE, 1)), torch.from_numpy(_rand(SHAPE, 2))
    t = torch.full((B,), 0.3)
    grads = []
    for model in (plain, remat, conv):
        model(x, t, t, lowres_cond_img=low).square().mean().backward()
        grads.append({k: p.grad for k, p in model.named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0, atol=0, msg=k)
        torch.testing.assert_close(grads[2][k], grads[0][k], rtol=0, atol=0, msg=k)


def test_remat_conv_grads_match_jax():
    """The port's ``remat_policy='conv'`` against the JAX one (save
    ``conv_in`` / ``conv_out``, recompute the GroupNorm / Mish chain) on the
    same weights and inputs: every parameter gradient within 1e-5 of its
    largest entry (fp32 sums in other orders; the JAX test holds its own
    policies to each other at 1e-5)."""
    jmodel = JUNet3D(**UNET_KW, att_type="linear", dtype=jnp.float32, remat=True,
                     remat_policy="conv")
    params = _init_params(_jax_unet(), 0)
    x, low = _rand(SHAPE, 1), _rand(SHAPE, 2)
    t = np.full((B,), 0.3, np.float32)

    def loss(p):
        out = jmodel.apply(p, jnp.asarray(x), jnp.asarray(t), jnp.asarray(t),
                           lowres_cond_img=jnp.asarray(low))
        return jnp.mean(jnp.square(out))

    want = state_dict_from_jax_params(jax.jit(jax.grad(loss))(params))
    port = UNet3D(**UNET_KW, remat=True, remat_policy="conv")
    port.load_state_dict(state_dict_from_jax_params(params))
    port(_t(x), _t(t), _t(t), lowres_cond_img=_t(low)).square().mean().backward()
    for k, p in port.named_parameters():
        ref = want[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max(), err_msg=k)


def _vit_unet(**kw):
    torch.manual_seed(0)
    return UNet3D(dim=8, init_dim=8, dim_mults=(1, 2), num_resnet_blocks=(1, 1),
                  resnet_groups=4, img_size=24, att_type="vit", attn_dim_head=8,
                  attend_at_enc=(True, False), attend_at_enc_heads=2, init_patch_size=4,
                  **kw)


def test_dropout_acts_in_train_mode_only():
    """Rates 0 in train mode give the eval forward (which
    tests/test_torch_attention.py holds against JAX with deterministic=True);
    eval mode ignores the rates; nonzero rates change a train forward."""
    x = torch.from_numpy(_rand((27, 8, 8, 8, 1), 1))
    low = torch.from_numpy(_rand((27, 8, 8, 8, 1), 2))
    t = torch.full((27,), 0.3)
    zero = _vit_unet(att_drop=0.0, att_forward_drop=0.0)
    rates = _vit_unet(att_drop=0.1, att_forward_drop=0.3)
    rates.load_state_dict(zero.state_dict())
    with torch.no_grad():
        ref = zero.eval()(x, t, t, lowres_cond_img=low)
        torch.testing.assert_close(zero.train()(x, t, t, lowres_cond_img=low), ref,
                                   rtol=0, atol=0)
        torch.testing.assert_close(rates.eval()(x, t, t, lowres_cond_img=low), ref,
                                   rtol=0, atol=0)
        assert not torch.equal(rates.train()(x, t, t, lowres_cond_img=low), ref)
    drops = sorted({m.p for m in rates.modules() if isinstance(m, torch.nn.Dropout)})
    assert drops == [0.1, 0.3]
    linear = UNet3D(**{**UNET_KW, "img_size": 24, "attend_at_enc": (True, False)},
                    att_type="linear", attn_dim_head=8, attend_at_enc_heads=2)
    assert {m.p for m in linear.modules() if isinstance(m, torch.nn.Dropout)} == {0.05}


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _batch(seed):
    return _rand((2 * B,) + SHAPE[1:], seed), _rand((2 * B,) + SHAPE[1:], seed + 1)


def test_save_load_resumes_the_same_run(runs, tmp_path):
    """save -> load -> the next step equals an uninterrupted run, the
    generator's draw stream included; the rolling folder keeps the newest
    max_checkpoints_keep bundles and a trainer on it resumes from the last."""
    whole = _port_trainer(runs, edm=True)
    for s in (1, 3):
        whole.train_step(unet_number=2, batch=_batch(s))
    path = str(tmp_path / "bundle.pt")
    whole.save(path)
    want = whole.train_step(unet_number=2, batch=_batch(5))

    resumed = _port_trainer(runs, edm=True, seed=123)
    resumed.load(path)
    assert resumed.steps == [0, 2]
    got = resumed.train_step(unet_number=2, batch=_batch(5))
    assert got == want
    for a, b in zip(whole.imagen.unets[1].parameters(), resumed.imagen.unets[1].parameters()):
        assert torch.equal(a, b)
    for a, b in zip(whole.ema_unets[1].parameters(), resumed.ema_unets[1].parameters()):
        assert torch.equal(a, b)

    folder = tmp_path / "rolling"
    rolling = _port_trainer(runs, edm=True, checkpoint_path=str(folder), checkpoint_every=1,
                            max_checkpoints_keep=2)
    for s in (1, 3, 5):
        rolling.train_step(unet_number=2, batch=_batch(s))
    assert sorted(os.listdir(folder)) == ["checkpoint.2.pt", "checkpoint.3.pt"]
    again = _port_trainer(runs, edm=True, checkpoint_path=str(folder), checkpoint_every=1)
    assert again.steps == [0, 3]


def test_pretrain_load_keeps_what_the_bundle_lacks(runs, tmp_path):
    """load(strict=False): parts missing from the bundle, or of another
    shape, keep their current values (restore_parts)."""
    src = _port_trainer(runs, edm=True)
    src.train_step(unet_number=2, batch=_batch(1))
    bundle = src.state_bundle()
    bundle["model"].pop("unets.1.final_conv.bias")
    bundle["model"]["unets.1.init_conv.weight"] = torch.zeros(3)
    path = str(tmp_path / "partial.pt")
    torch.save(bundle, path)
    dst = _port_trainer(runs, edm=True)
    before = {k: v.clone() for k, v in dst.imagen.unets[1].state_dict().items()}
    with pytest.raises(RuntimeError):
        _port_trainer(runs, edm=True).load(path)
    dst.load(path, strict=False)
    after = dst.imagen.unets[1].state_dict()
    for k in ("final_conv.bias", "init_conv.weight"):
        assert torch.equal(after[k], before[k]), k
    assert torch.equal(after["final_conv.weight"],
                       src.imagen.unets[1].state_dict()["final_conv.weight"])
    assert dst.steps == [0, 1]
    merged = restore_parts({"a": 1, "b": [torch.zeros(2), torch.zeros(2)]},
                           {"a": 2, "b": [torch.ones(3), torch.ones(2)], "c": 0})
    assert sorted(merged) == ["a", "b"] and merged["a"] == 2
    assert torch.equal(merged["b"][0], torch.zeros(2)) and torch.equal(merged["b"][1], torch.ones(2))


def test_port_bundle_loads_into_jax(runs, japply, tmp_path):
    """A port bundle read by the JAX converter: the EMA entry gives the port
    EMA model's forward, the model entry the online weights."""
    tr = _port_trainer(runs, edm=True, ema_update_every=2, ema_update_after_step=0)
    for s in (1, 3):
        tr.train_step(unet_number=2, batch=_batch(s))
    bundle = torch.load(_save(tr, tmp_path), map_location="cpu", weights_only=True)
    ema_vars = convert_reference_checkpoint(bundle, unet_number=2, use_ema=True)
    online_vars = convert_reference_checkpoint(bundle, unet_number=2, use_ema=False)
    for vars_, module in ((ema_vars, tr.ema_unets[1]), (online_vars, tr.imagen.unets[1])):
        back = state_dict_from_jax_params(jax.device_get(vars_))
        for k, v in module.state_dict().items():
            assert torch.equal(back[k], v), k
    assert not torch.equal(tr.ema_unets[1].init_conv.weight, tr.imagen.unets[1].init_conv.weight)
    x, low = _rand(SHAPE, 30), _rand(SHAPE, 31)
    t = np.full((B,), -0.4, np.float32)
    want = japply(ema_vars, jnp.asarray(x), jnp.asarray(t), jnp.asarray(t),
                  lowres_cond_img=jnp.asarray(low))
    with torch.no_grad():
        got = tr.ema_unets[1](torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(t),
                              lowres_cond_img=torch.from_numpy(low))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def _save(tr, tmp_path) -> str:
    path = str(tmp_path / "tr.pt")
    tr.save(path)
    return path


def test_sample_uses_ema_weights_in_whole_groups(runs):
    """``sample`` takes the EMA unets unless ``use_non_ema``; chunks of
    max_batch_size are rounded down to whole 27-groups."""
    tr = _port_trainer(runs, edm=True, ema_update_every=100)
    tr.train_step(unet_number=2, batch=_batch(1))
    low = torch.from_numpy(_rand((2 * B,) + SHAPE[1:], 9))
    calls = []
    sample = ElucidatedImagen.sample

    def spy(self, **kw):
        calls.append((kw["batch_size"], self.unets[1]))
        return sample(self, **kw)

    ElucidatedImagen.sample = spy
    try:
        out = tr.sample(batch_size=2 * B, max_batch_size=40, start_image_or_video=low,
                        start_at_unet_number=2)
        tr.sample(batch_size=B, start_image_or_video=low[:B], start_at_unet_number=2,
                  use_non_ema=True)
    finally:
        ElucidatedImagen.sample = sample
    assert out.shape == low.shape and torch.isfinite(out).all()
    assert [c[0] for c in calls] == [B, B, B]
    assert calls[0][1] is tr.ema_unets[1] and calls[2][1] is tr.imagen.unets[1]


def test_valid_step_sample_scores_ema_samples(runs):
    """Sampling validation (reference valid_step2): the EMA sampler on each
    validation batch's lowres input, scored by SSIM and PSNR."""
    tr = _port_trainer(runs, edm=True)
    tr.add_valid_dataloader([(_rand(SHAPE, 40), _rand(SHAPE, 41))])
    losses, preds, (hrs, lrs), ssim, psnr = tr.valid_step_sample(unet_number=2)
    assert preds.shape == hrs.shape == lrs.shape == SHAPE
    assert losses.shape == (1,) and np.isfinite([*losses, ssim, psnr]).all()
    loss, preds, noisy, (hrs, low), ssim, psnr = tr.valid_step(unet_number=2)
    assert preds.shape == noisy.shape == hrs.shape == low.shape == SHAPE
    again = tr.valid_step(unet_number=2)  # reseeded: the same draws every call
    assert again[0] == loss and np.isfinite([ssim, psnr]).all()


@pytest.mark.parametrize("trajectory", [False, True])
def test_trainer_sample_chunks_every_tensor_argument(trajectory):
    """``ImagenTrainer.sample`` in chunks of ``max_batch_size``: every
    batch-major tensor argument (the start images, ``cond_images``, each
    unet's ``init_images``) is sliced per chunk, as the JAX trainer's
    ``_map_array_kwargs`` slices them (trainer.py:709-723), the outputs and
    trajectories are concatenated on their batch axis, and
    ``return_all_unet_outputs`` is the JAX alias of ``return_all_outputs``
    (trainer.py:853-854): equal, bit for bit, to the wrapper's own calls on
    the chunks with the same noise stream."""
    from diffusioniqt_tpu_torch.diffusion.gaussian import gaussian_noise
    from diffusioniqt_tpu_torch.models.unet2d import UNet2D

    torch.manual_seed(0)
    unet = UNet2D(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, lowres_cond=True,
                  resnet_groups=4, cond_images_channels=2)
    imagen = Imagen([NullUnet(), unet], image_sizes=(8, 8), channels=1, timesteps=3,
                    pred_objectives="x_start", dynamic_thresholding=False, cond_drop_prob=0.0,
                    spatial_dims=2)
    trainer = ImagenTrainer(None, imagen, use_ema=False)
    rows = [torch.from_numpy(_rand((5, 8, 8, c), s)) for c, s in ((1, 60), (2, 61), (1, 62))]
    lowres, cond, init = rows
    kw = dict(start_at_unet_number=2, return_trajectory=trajectory)
    got = trainer.sample(batch_size=5, max_batch_size=2, start_image_or_video=lowres,
                         cond_images=cond, init_images=(None, init),
                         noise=gaussian_noise(torch.Generator().manual_seed(3)),
                         return_all_unet_outputs=True, **kw)
    noise = gaussian_noise(torch.Generator().manual_seed(3))
    parts = [imagen.sample(batch_size=hi - lo, noise=noise, start_image_or_video=lowres[lo:hi],
                           cond_images=cond[lo:hi], init_images=(None, init[lo:hi]),
                           return_all_outputs=True, **kw)
             for lo, hi in ((0, 2), (2, 4), (4, 5))]
    if trajectory:
        assert len(got) == 3 and got[1].shape == (3, 5, 8, 8, 1)
        torch.testing.assert_close(got[0][0], torch.cat([p[0][0] for p in parts]), rtol=0, atol=0)
        for i in (1, 2):
            torch.testing.assert_close(got[i], torch.cat([p[i] for p in parts], dim=1),
                                       rtol=0, atol=0)
    else:
        assert isinstance(got, list) and len(got) == 1 and got[0].shape == (5, 8, 8, 1)
        torch.testing.assert_close(got[0], torch.cat([p[0] for p in parts]), rtol=0, atol=0)
