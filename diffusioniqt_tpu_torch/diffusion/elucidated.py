"""Cascaded EDM (Karras) diffusion (counterpart of
``diffusioniqt_tpu/diffusion/elucidated.py``; reference
``elucidated_imagen.py``) in plain PyTorch:

  * per-unet EDM hyperparameters (``core/edm.py::EDMParams``)
  * the preconditioned network forward, Table-1 ``c_skip`` / ``c_out`` /
    ``c_in`` / ``c_noise``, with ``cond_scale`` guidance on the raw output
  * the stochastic Heun sampler with churn and the second-order
    correction, as a Python loop over the steps; the last step
    (``sigma_next == 0``) is plain Euler
  * cascade ``sample`` with ``start_at_unet_number``
  * the training loss ``forward`` (reference :712-882): lognormal sigmas,
    one per sub-volume, the EDM loss weight, and the lowres conditioning
    clean (``lowres_noise_aug`` off, the IQT path), noise-augmented, or
    made by down-up-resizing the target when none is given
  * ``cond_images`` passed to the U-Net in the loss and in every sampler
    forward, which concatenates them before its input
  * text conditioning (``text_embeds`` / ``text_mask``) and the lowres
    noise level, passed to a U-Net whose forward takes them (the video
    U-Net; JAX elucidated.py:211-219), and video sampling
    (``video_frames``: ``(B, F, size, size, C)``, each stage's input
    resized on H and W only)

Randomness is injected as in ``diffusion/gaussian.py``: the sampler takes
``noise(shape) -> tensor`` (``NoiseFn``) and draws, per cascade stage, in
this order:

  1. the lowres noise augmentation, only when ``lowres_noise_aug`` is on
     (the IQT configs keep it off);
  2. the initial image, ``sigma_cur[0] * noise``;
  3. per step, per resample round: one ``eps``, drawn even where the
     churn ``gamma`` is 0; then, under inpainting and for every round but
     the last, one repaint draw.

The JAX sampler draws the same in that order from its own keys
(elucidated.py:292-293, :324-329, :374-376), so a test feeds a loop built
from its public functions and this one the same numpy noise. ``forward``
takes its draws (augmentation times and noise, sigmas, noise) as arguments,
else draws them from the trainer's generator in that order.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Optional, Sequence, Tuple, Union

import torch

from diffusioniqt_tpu_torch.core.edm import EDMParams
from diffusioniqt_tpu_torch.core.schedules import (
    GaussianDiffusionContinuousTimes,
    right_pad_dims_to,
)
from diffusioniqt_tpu_torch.diffusion.gaussian import (
    Imagen,
    NoiseFn,
    clamp_to_range,
    identity,
    normalize_neg_one_to_one,
    standard_normal,
    threshold_x_start,
    unnormalize_zero_to_one,
)
from diffusioniqt_tpu_torch.ops.volume import resize, resize_volume
from diffusioniqt_tpu_torch.utils.misc import cast_tuple, default


class ElucidatedImagen:
    """Cascaded EDM sampler over one or more U-Nets (``nn.Module``s whose
    forward is ``unet(x, t, c_noise, lowres_cond_img=..., cond_drop_prob=...)``)."""

    def __init__(
        self,
        unets,
        *,
        image_sizes: Sequence[int],
        channels: int = 3,
        lowres_sample_noise_level: float = 0.2,
        per_sample_random_aug_noise_level: bool = False,
        lowres_noise_aug: bool = True,
        auto_normalize_img: bool = True,
        dynamic_thresholding: Union[bool, Sequence[bool]] = True,
        dynamic_thresholding_percentile: float = 0.95,
        lowres_noise_schedule: str = "linear",
        norm: str = "min-max",
        min_bound: float = -1.0,
        spatial_dims: int = 3,
        num_sample_steps: Union[int, Sequence[int]] = 32,
        sigma_min: Union[float, Sequence[float]] = 0.002,
        sigma_max: Union[float, Sequence[float]] = 80.0,
        sigma_data: Union[float, Sequence[float]] = 0.5,
        rho: Union[float, Sequence[float]] = 7.0,
        P_mean: Union[float, Sequence[float]] = -1.2,
        P_std: Union[float, Sequence[float]] = 1.2,
        S_churn: Union[float, Sequence[float]] = 80.0,
        S_tmin: Union[float, Sequence[float]] = 0.05,
        S_tmax: Union[float, Sequence[float]] = 50.0,
        S_noise: Union[float, Sequence[float]] = 1.003,
    ):
        unets = list(unets) if isinstance(unets, (list, tuple)) else [unets]
        num_unets = len(unets)
        self.channels = channels
        self.norm = norm
        self.min_bound = float(min_bound)
        self.spatial_dims = spatial_dims
        self.image_sizes = cast_tuple(tuple(image_sizes))
        if num_unets != len(self.image_sizes):
            raise ValueError("one image size per unet")
        # first unet unconditioned, the rest lowres-conditioned, cast as the
        # JAX wrapper casts them (elucidated.py:84-92)
        self.unets = [unet.cast_model_parameters(lowres_cond=ind > 0, channels=channels,
                                                 channels_out=channels)
                      for ind, unet in enumerate(unets)]

        self.lowres_noise_schedule = GaussianDiffusionContinuousTimes(
            noise_schedule=lowres_noise_schedule)
        self.lowres_sample_noise_level = lowres_sample_noise_level
        self.per_sample_random_aug_noise_level = per_sample_random_aug_noise_level
        self.lowres_noise_aug = lowres_noise_aug
        self.normalize_img = normalize_neg_one_to_one if auto_normalize_img else identity
        self.unnormalize_img = unnormalize_zero_to_one if auto_normalize_img else identity
        self.input_image_range = (0.0 if auto_normalize_img else -1.0, 1.0)
        self.dynamic_thresholding = cast_tuple(dynamic_thresholding, num_unets)
        self.dynamic_thresholding_percentile = dynamic_thresholding_percentile

        hp_fields = (num_sample_steps, sigma_min, sigma_max, sigma_data, rho,
                     P_mean, P_std, S_churn, S_tmin, S_tmax, S_noise)
        hp_fields = [cast_tuple(f, num_unets) for f in hp_fields]
        self.hparams = [
            EDMParams(num_sample_steps=ns, sigma_min=smin, sigma_max=smax,
                      sigma_data=sd, rho=r, P_mean=pm, P_std=ps, S_churn=sc,
                      S_tmin=st0, S_tmax=st1, S_noise=sn)
            for ns, smin, smax, sd, r, pm, ps, sc, st0, st1, sn in zip(*hp_fields)
        ]

    @property
    def num_unets(self) -> int:
        return len(self.unets)

    # ------------------------------------------------------------------
    @staticmethod
    def _conditioning(unet, lowres_cond_img, cond_images, self_cond, lowres_noise_times,
                      text_embeds, text_mask) -> dict:
        """The U-Net call's conditioning: the lowres noise level to a U-Net
        whose forward takes one, the text (with its mask) to one that takes
        text, and only when there is text (JAX elucidated.py:211-219)."""
        kw = Imagen._unet_kwargs(lowres_cond_img, cond_images, self_cond)
        takes = inspect.signature(getattr(unet, "forward", unet)).parameters
        if "lowres_noise_times" in takes:
            kw["lowres_noise_times"] = lowres_noise_times
        if "text_embeds" in takes and text_embeds is not None:
            kw.update(text_embeds=text_embeds, text_mask=text_mask)
        return kw

    def preconditioned_network_forward(self, unet, noised_images, sigma, hp: EDMParams, *,
                                       clamp: bool = False, dynamic_threshold: bool = True,
                                       cond_scale: float = 1.0, lowres_cond_img=None,
                                       lowres_noise_times=None, cond_images=None,
                                       text_embeds=None, text_mask=None, self_cond=None):
        """EDM eq. (7) (reference :329-358). ``cond_scale != 1`` mixes a
        second, null-conditioned evaluation (``cond_drop_prob=1``: a text
        U-Net's null text) into the raw network output before the c_skip /
        c_out recombination (JAX elucidated.py:227-237); the IQT U-Net
        ignores ``cond_drop_prob``, so both evaluations agree.
        ``self_cond`` is the x0 estimate a self-conditioned U-Net is given
        (None: the U-Net's zeros); ``cond_images`` go to the U-Net, which
        concatenates them before its input (JAX elucidated.py:204-209)."""
        batch = noised_images.shape[0]
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=noised_images.device)
        if sigma.dim() == 0:
            sigma = sigma.expand(batch)
        padded_sigma = right_pad_dims_to(noised_images, sigma)
        c_noise = hp.c_noise(sigma)
        net_in = hp.c_in(padded_sigma) * noised_images
        kw = self._conditioning(unet, lowres_cond_img, cond_images, self_cond,
                                lowres_noise_times, text_embeds, text_mask)
        net_out = unet(net_in, c_noise, c_noise, **kw)
        if cond_scale != 1.0:
            null_out = unet(net_in, c_noise, c_noise, cond_drop_prob=1.0, **kw)
            net_out = null_out + (net_out - null_out) * cond_scale
        out = hp.c_skip(padded_sigma) * noised_images + hp.c_out(padded_sigma) * net_out
        if not clamp:
            return out
        return self.threshold_x_start(out, dynamic_threshold)

    def threshold_x_start(self, x_start: torch.Tensor, dynamic_threshold: bool = True
                          ) -> torch.Tensor:
        """The clamp of a denoised estimate (reference :291-310, with the
        z-score ``min_bound``): ``diffusion/gaussian.py::threshold_x_start``
        at this wrapper's norm, bound and percentile."""
        return threshold_x_start(
            x_start, dynamic_threshold=dynamic_threshold, norm=self.norm,
            min_bound=self.min_bound, percentile=self.dynamic_thresholding_percentile)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def one_unet_sample(self, unet, shape: Tuple[int, ...], *, noise: NoiseFn,
                        hp: EDMParams, clamp: bool = True, dynamic_threshold: bool = True,
                        cond_scale: float = 1.0, lowres_cond_img=None,
                        lowres_noise_times=None, cond_images=None, text_embeds=None,
                        text_mask=None, inpaint_images=None, inpaint_masks=None,
                        inpaint_resample_times: int = 5, init_images=None,
                        skip_steps: Optional[int] = None, sigma_min: Optional[float] = None,
                        sigma_max: Optional[float] = None):
        """Stochastic Heun sampling (reference :381-532; JAX
        elucidated.py:245-447). The sigma overrides keep the JAX ``or``
        semantics: 0 or None keeps the hyperparameter. A self-conditioned
        U-Net (``unet.self_cond``) carries an x0 estimate as the JAX loop
        does (elucidated.py:306,347-372,411): zeros at first; each step's
        first forward gets the carry, its Heun correction that forward's
        output; the carry becomes the correction's output, or the first
        forward's on the last (uncorrected) step."""
        if sigma_min is not None or sigma_max is not None:
            hp = dataclasses.replace(hp, sigma_min=sigma_min or hp.sigma_min,
                                     sigma_max=sigma_max or hp.sigma_max)
        sigmas = hp.sample_schedule()
        gammas = hp.gammas(sigmas)
        sigma_cur, sigma_next, gamma_cur = sigmas[:-1], sigmas[1:], gammas[:-1]
        initial_step = default(skip_steps, 0)
        sigma_cur = sigma_cur[initial_step:]
        sigma_next = sigma_next[initial_step:]
        gamma_cur = gamma_cur[initial_step:]

        first = noise(tuple(shape))
        sigma_cur, sigma_next, gamma_cur = (t.to(first.device)
                                            for t in (sigma_cur, sigma_next, gamma_cur))
        images = sigma_cur[0] * first
        if init_images is not None:
            images = images + init_images

        has_inpainting = inpaint_images is not None and inpaint_masks is not None
        resample_times = inpaint_resample_times if has_inpainting else 1
        if has_inpainting:
            inpaint_images = resize_volume(self.normalize_img(inpaint_images), shape[1])
            inpaint_masks = resize_volume(inpaint_masks.float(), shape[1])

        fwd = dict(hp=hp, clamp=clamp, dynamic_threshold=dynamic_threshold,
                   cond_scale=cond_scale, lowres_cond_img=lowres_cond_img,
                   lowres_noise_times=lowres_noise_times, cond_images=cond_images,
                   text_embeds=text_embeds, text_mask=text_mask)
        n_steps = sigma_cur.shape[0]
        self_cond = getattr(unet, "self_cond", False)
        x_start = torch.zeros_like(images)
        for i in range(n_steps):
            sig, sig_next, gamma = sigma_cur[i], sigma_next[i], gamma_cur[i]
            for r in reversed(range(resample_times)):
                eps = hp.S_noise * noise(tuple(shape))
                sigma_hat = sig + gamma * sig
                added_noise = torch.sqrt(torch.clamp(sigma_hat ** 2 - sig ** 2, min=0.0)) * eps
                images_hat = images + added_noise
                if has_inpainting:
                    images_hat = (images_hat * (1 - inpaint_masks)
                                  + (inpaint_images + added_noise) * inpaint_masks)
                model_output = self.preconditioned_network_forward(
                    unet, images_hat, sigma_hat, self_cond=x_start if self_cond else None,
                    **fwd)
                denoised_over_sigma = (images_hat - model_output) / sigma_hat
                images_next = images_hat + (sig_next - sigma_hat) * denoised_over_sigma
                if i < n_steps - 1:
                    # second-order correction on every step but the last,
                    # whose sigma_next is the schedule's trailing 0
                    model_output_next = self.preconditioned_network_forward(
                        unet, images_next, sig_next,
                        self_cond=model_output if self_cond else None, **fwd)
                    denoised_prime = (images_next - model_output_next) / sig_next
                    images = images_hat + 0.5 * (sig_next - sigma_hat) * (
                        denoised_over_sigma + denoised_prime)
                    x_start = model_output_next
                else:
                    images, x_start = images_next, model_output
                if has_inpainting and r != 0:
                    images = images + (sig - sig_next) * noise(tuple(shape))

        images = clamp_to_range(images, self.norm, self.min_bound)
        if has_inpainting:
            images = images * (1 - inpaint_masks) + inpaint_images * inpaint_masks
        return self.unnormalize_img(images)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def sample(self, *, batch_size: int = 1, noise: NoiseFn, cond_images=None,
               inpaint_images=None, inpaint_masks=None, inpaint_resample_times: int = 5,
               init_images=None,
               skip_steps=None, sigma_min=None, sigma_max=None,
               cond_scale: Union[float, Sequence[float]] = 1.0,
               lowres_sample_noise_level: Optional[float] = None,
               start_at_unet_number: int = 1, start_image_or_video=None,
               stop_at_unet_number: Optional[int] = None,
               return_all_outputs: bool = False, video_frames: Optional[int] = None,
               text_embeds=None, text_mask=None):
        """Cascade EDM sampling (reference :536-702; JAX elucidated.py:450-555).
        ``start_image_or_video`` is the lowres input of the first sampled
        stage when ``start_at_unet_number > 1``. ``video_frames`` samples
        ``(B, video_frames, size, size, C)`` videos, resizing a stage's
        lowres and init inputs on H and W only, by ``jax.image.resize``'s
        "nearest" (JAX elucidated.py:477-481); ``text_embeds`` /
        ``text_mask`` go to every stage that takes text."""

        def _resize(img, size):
            if video_frames is not None:
                return resize(img, (img.shape[0], img.shape[1], size, size, img.shape[-1]))
            return resize_volume(img, size)

        num_unets = self.num_unets
        cond_scale = cast_tuple(cond_scale, num_unets)
        init_images = [None if im is None else self.normalize_img(im)
                       for im in cast_tuple(init_images, num_unets)]
        skip_steps = cast_tuple(skip_steps, num_unets)
        sigma_min = cast_tuple(sigma_min, num_unets)
        sigma_max = cast_tuple(sigma_max, num_unets)
        level = default(lowres_sample_noise_level, self.lowres_sample_noise_level)

        img = None
        if start_at_unet_number > 1:
            if not 1 < start_at_unet_number <= num_unets:
                raise ValueError(f"start_at_unet_number {start_at_unet_number} "
                                 f"out of range for {num_unets} unets")
            if start_image_or_video is None:
                raise ValueError("starting image must be supplied if only doing upscaling")
            img = _resize(start_image_or_video, self.image_sizes[start_at_unet_number - 2])

        outputs = []
        for unet_number in range(start_at_unet_number, num_unets + 1):
            index = unet_number - 1
            unet = self.unets[index]
            size = self.image_sizes[index]
            lowres_cond_img = lowres_noise_times = None
            if getattr(unet, "lowres_cond", False):
                lowres_cond_img = self.normalize_img(_resize(img, size))
                times = self.lowres_noise_schedule.get_times(
                    batch_size, level if self.lowres_noise_aug else 0.0,
                    device=lowres_cond_img.device)
                lowres_noise_times = self.lowres_noise_schedule.get_condition(times)
                if self.lowres_noise_aug:
                    lowres_cond_img, *_ = self.lowres_noise_schedule.q_sample(
                        lowres_cond_img, times, noise(tuple(lowres_cond_img.shape)))
            unet_init = init_images[index]
            if unet_init is not None:
                unet_init = _resize(unet_init, size)
            if video_frames is not None:
                shape = (batch_size, video_frames, size, size, self.channels)
            else:
                shape = (batch_size,) + (size,) * self.spatial_dims + (self.channels,)
            img = self.one_unet_sample(
                unet, shape, noise=noise, hp=self.hparams[index], clamp=True,
                dynamic_threshold=self.dynamic_thresholding[index],
                cond_scale=cond_scale[index], lowres_cond_img=lowres_cond_img,
                lowres_noise_times=lowres_noise_times, cond_images=cond_images,
                text_embeds=text_embeds, text_mask=text_mask, inpaint_images=inpaint_images,
                inpaint_masks=inpaint_masks,
                inpaint_resample_times=inpaint_resample_times, init_images=unet_init,
                skip_steps=skip_steps[index], sigma_min=sigma_min[index],
                sigma_max=sigma_max[index])
            outputs.append(img)
            if stop_at_unet_number == unet_number:
                break
        return outputs if return_all_outputs else outputs[-1]

    # ------------------------------------------------------------------
    def forward(self, images, lowres_img=None, *, unet_number: Optional[int] = None,
                cond_images=None, text_embeds=None, text_mask=None,
                generator: Optional[torch.Generator] = None, sigmas=None, noise=None,
                aug_times=None, aug_noise=None, return_outputs: bool = False):
        """EDM training loss (reference :712-882; JAX elucidated.py:558-658):
        the scalar loss, or ``(loss, denoised, noised_images, lowres_noisy)``
        with ``return_outputs``.

        Without ``lowres_img`` a lowres-conditioned unet gets ``images``
        down-resized to the previous stage and back up (reference
        :779-782). The conditioning stays clean when ``lowres_noise_aug`` is
        off (the IQT path, at noise time 0), else it is noised at one time
        per call or, with ``per_sample_random_aug_noise_level``, per sample.
        Draws not given come from ``generator`` in the order of
        :meth:`training_draws`. ``images`` are resized to the stage's size
        on every axis between the batch and the channels, as the JAX
        ``forward`` does with ``resize_volume`` (elucidated.py:623): a
        ``(B, F, H, W, C)`` video's frame axis too."""
        if self.num_unets > 1 and unet_number is None:
            raise ValueError("unet_number is required with more than one unet")
        index = (unet_number or 1) - 1
        unet, hp = self.unets[index], self.hparams[index]
        target_size = self.image_sizes[index]
        batch = images.shape[0]

        lowres_cond_img = lowres_img
        if lowres_cond_img is None and index > 0:
            lowres_cond_img = resize_volume(images, self.image_sizes[index - 1],
                                            clamp_range=self.input_image_range)
            lowres_cond_img = resize_volume(lowres_cond_img, target_size,
                                            clamp_range=self.input_image_range)
        images = self.normalize_img(resize_volume(images, target_size))
        draws = self.training_draws(
            generator, images.shape, None if lowres_cond_img is None else lowres_cond_img.shape,
            unet_number=unet_number, sigmas=sigmas, noise=noise, aug_times=aug_times,
            aug_noise=aug_noise)
        lowres_noisy = lowres_times = None
        if lowres_cond_img is not None:
            lowres_noisy = self.normalize_img(lowres_cond_img)
            lowres_times = torch.zeros((batch,), dtype=torch.float32, device=images.device)
            if self.lowres_noise_aug:
                lowres_times = draws["aug_times"]
                lowres_noisy = self.lowres_noise_schedule.q_sample(
                    lowres_noisy, lowres_times, draws["aug_noise"])[0]
        sigmas, noise = draws["sigmas"], draws["noise"]
        noised_images = images + right_pad_dims_to(images, sigmas) * noise
        denoised = self.preconditioned_network_forward(
            unet, noised_images, sigmas, hp, lowres_cond_img=lowres_noisy,
            lowres_noise_times=self.lowres_noise_schedule.get_condition(lowres_times),
            cond_images=cond_images, text_embeds=text_embeds, text_mask=text_mask)
        losses = ((denoised - images) ** 2).reshape(batch, -1).mean(dim=-1)
        loss = (losses * hp.loss_weight(sigmas)).mean()
        if return_outputs:
            return loss, denoised, noised_images, lowres_noisy
        return loss


    def training_draws(self, generator: Optional[torch.Generator], shape: Tuple[int, ...],
                       lowres_shape: Optional[Tuple[int, ...]] = None, *,
                       unet_number: Optional[int] = None, sigmas=None, noise=None,
                       aug_times=None, aug_noise=None) -> dict:
        """The draws :meth:`forward` makes for (resized) images of ``shape``
        and lowres conditioning of ``lowres_shape`` (None: unconditioned),
        in its order: with ``lowres_noise_aug`` the augmentation times (one
        per call, or per sample with ``per_sample_random_aug_noise_level``)
        and noise, then ``sigmas`` ``(B,)`` (one per sub-volume), then
        ``noise``. Those given are kept, the rest come from ``generator``.
        The data-parallel trainer draws a global microbatch's and keeps its
        rows."""
        index = (unet_number or 1) - 1
        batch = shape[0]

        def need():
            if generator is None:
                raise ValueError("pass a torch.Generator, or every draw of the loss")

        draws = {}
        if lowres_shape is not None and self.lowres_noise_aug:
            if aug_times is None:
                need()
                sched = self.lowres_noise_schedule
                aug_times = (sched.sample_random_times(generator, batch)
                             if self.per_sample_random_aug_noise_level
                             else sched.sample_random_times(generator, 1).expand(batch))
            if aug_noise is None:
                aug_noise = standard_normal(lowres_shape, generator)
            draws.update(aug_times=aug_times, aug_noise=aug_noise)
        if sigmas is None:
            need()
            sigmas = self.hparams[index].noise_distribution(generator, batch)
        if noise is None:
            noise = standard_normal(shape, generator)
        draws.update(sigmas=sigmas, noise=noise)
        return draws


def elucidated_imagen_from_config(cfg, unets) -> ElucidatedImagen:
    """The EDM sampler from the shared YAML config (``Train.elucidated``;
    JAX elucidated.py:661-685), as the JAX entry scripts build it.

    ``Train.edm_steps_per_launch`` is loaded and not read: the JAX sampler
    splits the Heun loop into launches of that many steps only to stay
    under the TPU runtime's limit on one launch's duration, and the split
    is numerically identical to one loop (elucidated.py:416-447). Eager
    PyTorch launches kernel by kernel, so the port runs one loop."""
    return ElucidatedImagen(
        unets,
        image_sizes=(cfg.train.patch_size_sub, cfg.train.patch_size_sub),
        channels=cfg.train.channels,
        auto_normalize_img=False,
        dynamic_thresholding=cfg.train.dynamic_threshold,
        norm=cfg.data.norm,
        min_bound=cfg.data.min_bound,
        num_sample_steps=cfg.train.edm_num_sample_steps,
        sigma_min=cfg.train.edm_sigma_min,
        sigma_max=cfg.train.edm_sigma_max,
        sigma_data=cfg.train.edm_sigma_data,
        rho=cfg.train.edm_rho,
        S_churn=cfg.train.edm_s_churn,
        lowres_noise_aug=cfg.train.edm_lowres_noise_aug,
    )
