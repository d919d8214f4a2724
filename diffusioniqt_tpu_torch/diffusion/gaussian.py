"""Cascaded continuous-time Gaussian diffusion (counterpart of
``diffusioniqt_tpu/diffusion/gaussian.py``; reference ``Imagen``,
imagen_pytorch3D.py:1741-2443).

  * ``p_mean_variance`` with the noise / x_start / v objectives, dynamic
    thresholding and the z-score ``min_bound`` clamp (:1976-2030)
  * classifier-free guidance (``cond_scale``, :1540-1552)
  * ancestral ``p_sample`` / ``p_sample_loop`` (:2032-2160) as a Python
    loop over the steps, on the uniform time grid or, with
    ``non_uniform_times``, the exponentially weighted one (JAX
    gaussian.py:322-327), with ``cond_images``, ``init_images``,
    ``skip_steps``, inpainting with resampling, self-conditioning and the
    trajectory
  * cascade ``sample`` with ``start_at_unet_number`` (:2162-2274): the IQT
    entry points sample unet 2 over a ``NullUnet`` first stage, starting
    from the lowres patches; volumes (``spatial_dims=3``) or slices (2)
  * the training loss ``p_losses`` (:2276-2387) with the three objectives,
    the x_start ``min_bound`` clamp, p2 weighting, the loss table and the
    optional perceptual term ``0.1 * lpips_fn(pred, target)`` (:2372-2385),
    and ``forward`` (:2389-2443), which draws the diffusion times (one
    shared by the whole microbatch under ``batch_sample``)
  * ``auto_normalize_img``: images to [-1, 1] in the loss, samples back to
    [0, 1] (the JAX points)

Randomness is injected: every sampler takes ``noise(shape) -> tensor``, so
a test can feed the JAX loop and this one the same numpy noise (the JAX
loop draws its own, gaussian.py:282,318). :func:`gaussian_noise` makes one
from a seeded ``torch.Generator``. ``forward`` takes ``times`` and
``noise``, else draws them from the trainer's generator, times first.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from diffusioniqt_tpu_torch.core.schedules import (
    GaussianDiffusionContinuousTimes,
    right_pad_dims_to,
)
from diffusioniqt_tpu_torch.metrics.lpips import make_lpips_fn
from diffusioniqt_tpu_torch.metrics.medicalnet import (
    MedicalNetPerceptual,
    medicalnet_perceptual_from_checkpoint,
)
from diffusioniqt_tpu_torch.utils import profiling
from diffusioniqt_tpu_torch.utils.misc import cast_tuple, pad_tuple_to_length

NoiseFn = Callable[[Tuple[int, ...]], torch.Tensor]


def gaussian_noise(generator: torch.Generator) -> NoiseFn:
    """Standard-normal fp32 noise on the generator's device."""
    def draw(shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device, dtype=torch.float32)
    return draw


def standard_normal(shape, generator: Optional[torch.Generator]) -> torch.Tensor:
    """fp32 N(0, 1) of ``shape`` from ``generator``, on its device: the
    training draws of both wrappers."""
    if generator is None:
        raise ValueError("pass a torch.Generator, or every draw of the loss")
    return torch.randn(tuple(shape), generator=generator, device=generator.device,
                       dtype=torch.float32)


_LOSSES = {
    "l1": lambda pred, target: (pred - target).abs(),
    "l2": lambda pred, target: (pred - target) ** 2,
    "huber": lambda pred, target: torch.where((pred - target).abs() < 1.0,
                                              0.5 * (pred - target) ** 2,
                                              (pred - target).abs() - 0.5),
}


def clamp_to_range(img: torch.Tensor, norm: str, min_bound: float) -> torch.Tensor:
    """The samplers' output clamp: ``[-1, 1]`` under min-max, ``min_bound``
    from below under z-score."""
    if norm == "min-max":
        return torch.clamp(img, -1.0, 1.0)
    return torch.clamp(img, min=min_bound)


def threshold_x_start(x_start: torch.Tensor, *, dynamic_threshold: bool, norm: str,
                      min_bound: float, percentile: float) -> torch.Tensor:
    """Dynamic thresholding with min_bound clamp semantics (reference
    imagen_pytorch3D.py:2006-2026, elucidated_imagen.py:291-310), shared by
    both samplers."""
    if not dynamic_threshold:
        return clamp_to_range(x_start, norm, min_bound)
    b = x_start.shape[0]
    s = torch.quantile(x_start.reshape(b, -1).abs(), percentile, dim=-1)
    s = torch.clamp(s, min=(1.0 if norm == "min-max" else min_bound))
    s = right_pad_dims_to(x_start, s)
    return torch.minimum(torch.maximum(x_start, -s), s) / s


def normalize_neg_one_to_one(img):
    return img * 2 - 1


def unnormalize_zero_to_one(img):
    return (img + 1) * 0.5


def identity(img):
    return img


class Imagen:
    """Cascaded DDPM over one or more U-Nets (``nn.Module``s whose forward
    is ``unet(x, t, log_snr, lowres_cond_img=..., cond_images=...,
    self_cond=..., cond_drop_prob=...)``), with the JAX constructor's
    arguments and defaults (JAX gaussian.py:70-97).

    Every unet is cast as the JAX wrapper casts it (gaussian.py:140-148)
    through its ``cast_model_parameters``: the first unconditioned, the
    rest lowres-conditioned, ``channels`` and ``channels_out`` the
    wrapper's; a unet that already matches is kept, else a fresh one is
    built (``UNet3D``, ``UNet2D``, ``Unet3DVideo``; ``NullUnet`` is kept).
    ``lowres_noise_schedule``, ``lowres_sample_noise_level`` and
    ``per_sample_random_aug_noise_level`` are kept as the JAX wrapper keeps
    them: the 3D reference never noises the lowres conditioning, so no
    method reads them. ``spatial_dims`` is 3 for volumes, 2 for slices."""

    def __init__(
        self,
        unets,
        *,
        image_sizes: Sequence[int],
        min_bound: float = 0.0,
        channels: int = 3,
        timesteps: Union[int, Sequence[int]] = 1000,
        cond_drop_prob: float = 0.1,
        loss_type: str = "l2",
        noise_schedules: Union[str, Sequence[str]] = "cosine",
        pred_objectives: Union[str, Sequence[str]] = "noise",
        lowres_noise_schedule: str = "linear",
        lowres_sample_noise_level: float = 0.2,
        per_sample_random_aug_noise_level: bool = False,
        auto_normalize_img: bool = False,
        p2_loss_weight_gamma: Union[float, Sequence[float]] = 0.5,
        p2_loss_weight_k: float = 1.0,
        dynamic_thresholding: Union[bool, Sequence[bool]] = True,
        dynamic_thresholding_percentile: float = 0.95,
        only_train_unet_number: Optional[int] = None,
        norm: str = "z-score",
        batch_sample: bool = False,
        lpips_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        spatial_dims: int = 3,
        non_uniform_times: bool = False,
        non_uniform_gamma: float = 10.0,
    ):
        unets = list(unets) if isinstance(unets, (list, tuple)) else [unets]
        num_unets = len(unets)
        self.channels = channels
        self.norm = norm
        self.min_bound = float(min_bound)
        self.batch_sample = batch_sample
        self.only_train_unet_number = only_train_unet_number
        # the perceptual loss term (metrics/lpips.py::make_lpips_fn or
        # metrics/medicalnet.py::MedicalNetPerceptual): a frozen network
        # outside the unets, so outside their optimizer, EMA and bundles
        self.lpips_fn = lpips_fn
        self.spatial_dims = spatial_dims
        self.non_uniform_times = non_uniform_times
        self.non_uniform_gamma = non_uniform_gamma
        if loss_type not in _LOSSES:
            raise NotImplementedError(f"unknown loss type {loss_type}")
        self.loss_fn = _LOSSES[loss_type]

        noise_schedules = cast_tuple(noise_schedules)
        noise_schedules = pad_tuple_to_length(noise_schedules, 2, "cosine")
        noise_schedules = pad_tuple_to_length(noise_schedules, num_unets, "linear")
        timesteps = cast_tuple(timesteps, num_unets)
        self.noise_schedulers = [
            GaussianDiffusionContinuousTimes(noise_schedule=s, timesteps=t)
            for t, s in zip(timesteps, noise_schedules)
        ]
        self.lowres_noise_schedule = GaussianDiffusionContinuousTimes(
            noise_schedule=lowres_noise_schedule)
        self.pred_objectives = cast_tuple(pred_objectives, num_unets)
        self.image_sizes = cast_tuple(tuple(image_sizes))
        if num_unets != len(self.image_sizes):
            raise ValueError("one image size per unet")

        # cascade conditioning: first unet unconditioned, the rest
        # lowres-conditioned (reference :1848-1858)
        self.unets = []
        for ind, unet in enumerate(unets):
            self.unets.append(unet.cast_model_parameters(
                lowres_cond=ind > 0, channels=channels, channels_out=channels))

        self.lowres_sample_noise_level = lowres_sample_noise_level
        self.per_sample_random_aug_noise_level = per_sample_random_aug_noise_level
        self.cond_drop_prob = cond_drop_prob
        self.can_classifier_guidance = cond_drop_prob > 0.0
        self.normalize_img = normalize_neg_one_to_one if auto_normalize_img else identity
        self.unnormalize_img = unnormalize_zero_to_one if auto_normalize_img else identity
        self.dynamic_thresholding = cast_tuple(dynamic_thresholding, num_unets)
        self.dynamic_thresholding_percentile = dynamic_thresholding_percentile
        self.p2_loss_weight_k = p2_loss_weight_k
        self.p2_loss_weight_gamma = cast_tuple(p2_loss_weight_gamma, num_unets)
        if any(g > 2 for g in self.p2_loss_weight_gamma):
            raise ValueError("p2_loss_weight_gamma must be at most 2")

    # ------------------------------------------------------------------
    @property
    def num_unets(self) -> int:
        return len(self.unets)

    def get_unet(self, unet_number: int):
        """The cast unet of stage ``unet_number`` (1-based)."""
        if not 0 < unet_number <= self.num_unets:
            raise ValueError(f"unet_number {unet_number} outside 1..{self.num_unets}")
        return self.unets[unet_number - 1]

    @staticmethod
    def _unet_kwargs(lowres_cond_img, cond_images, self_cond) -> dict:
        """The conditioning a U-Net call is given; ``cond_images`` and
        ``self_cond`` only where there are some (None: the U-Net's own)."""
        kw = {"lowres_cond_img": lowres_cond_img}
        if cond_images is not None:
            kw["cond_images"] = cond_images
        if self_cond is not None:
            kw["self_cond"] = self_cond
        return kw

    def forward_with_cond_scale(self, unet, x, t, noise_cond, cond_scale: float = 1.0,
                                **kwargs):
        """Classifier-free guidance (reference ``forward_with_cond_scale``,
        :1540-1552; JAX gaussian.py:201-209): with ``cond_scale != 1`` a
        second, null-conditioned call (``cond_drop_prob=1``) is mixed in."""
        logits = unet(x, t, noise_cond, **kwargs)
        if cond_scale == 1.0:
            return logits
        null_logits = unet(x, t, noise_cond, cond_drop_prob=1.0, **kwargs)
        return null_logits + (logits - null_logits) * cond_scale

    def denoise(self, unet, x, t, *, noise_scheduler, lowres_cond_img=None, cond_images=None,
                self_cond=None, cond_scale: float = 1.0):
        """The U-Net's output at ``(x, t)`` (guided where ``cond_scale`` is
        not 1, which needs a wrapper trained with ``cond_drop_prob > 0``).
        ``self_cond`` is the previous step's x0 for a self-conditioned
        U-Net (None: the U-Net's zeros)."""
        if cond_scale != 1.0 and not self.can_classifier_guidance:
            raise ValueError("cond_scale != 1 needs classifier-free guidance: build the "
                             "wrapper with cond_drop_prob > 0")
        return self.forward_with_cond_scale(
            unet, x, t, noise_scheduler.get_condition(t), cond_scale=cond_scale,
            **self._unet_kwargs(lowres_cond_img, cond_images, self_cond))

    def p_mean_variance(self, unet, x, t, *, noise_scheduler, t_next=None,
                        lowres_cond_img=None, cond_images=None, self_cond=None,
                        cond_scale: float = 1.0, model_output=None,
                        pred_objective: str = "noise", dynamic_threshold: bool = True):
        """Posterior mean / variance and the predicted x0 (reference
        :1976-2030) from ``model_output``, else from :meth:`denoise`."""
        pred = model_output
        if pred is None:
            pred = self.denoise(unet, x, t, noise_scheduler=noise_scheduler,
                                lowres_cond_img=lowres_cond_img, cond_images=cond_images,
                                self_cond=self_cond, cond_scale=cond_scale)
        if pred_objective == "noise":
            x_start = noise_scheduler.predict_start_from_noise(x, t, pred)
        elif pred_objective == "x_start":
            x_start = pred
        elif pred_objective == "v":
            x_start = noise_scheduler.predict_start_from_v(x, t, pred)
        else:
            raise ValueError(f"unknown objective {pred_objective}")
        x_start = threshold_x_start(
            x_start, dynamic_threshold=dynamic_threshold, norm=self.norm,
            min_bound=self.min_bound, percentile=self.dynamic_thresholding_percentile)
        mean_and_variance = noise_scheduler.q_posterior(
            x_start=x_start, x_t=x, t=t, t_next=t_next)
        return mean_and_variance, x_start

    def p_sample(self, unet, x, t, *, noise: NoiseFn, noise_scheduler, t_next=None,
                 lowres_cond_img=None, cond_images=None, self_cond=None,
                 cond_scale: float = 1.0, **kwargs):
        """One ancestral step (reference :2032-2056). The noise is drawn on
        every step, the last included, as the JAX loop does. Everything
        after the denoiser is the span ``sampler.update``."""
        b = x.shape[0]
        pred = self.denoise(unet, x, t, noise_scheduler=noise_scheduler,
                            lowres_cond_img=lowres_cond_img, cond_images=cond_images,
                            self_cond=self_cond, cond_scale=cond_scale)
        with profiling.span("sampler.update", device=True):
            (model_mean, _, model_log_variance), x_start = self.p_mean_variance(
                unet, x, t, noise_scheduler=noise_scheduler, t_next=t_next,
                model_output=pred, **kwargs)
            eps = noise(tuple(x.shape))
            nonzero_mask = (1.0 - (t_next == 0).float()).reshape(b, *((1,) * (x.dim() - 1)))
            pred = model_mean + nonzero_mask * torch.exp(0.5 * model_log_variance) * eps
        return pred, x_start

    @torch.no_grad()
    def p_sample_loop(self, unet, shape: Tuple[int, ...], *, noise: NoiseFn,
                      noise_scheduler: GaussianDiffusionContinuousTimes,
                      lowres_cond_img=None, cond_images=None, inpaint_images=None,
                      inpaint_masks=None, inpaint_resample_times: int = 5,
                      init_images=None, skip_steps: Optional[int] = None,
                      cond_scale: float = 1.0, pred_objective: str = "noise",
                      dynamic_threshold: bool = True, return_trajectory: bool = False,
                      use_self_cond: bool = False):
        """Ancestral sampling (reference :2058-2160; JAX gaussian.py:287-417):
        ``img``, or with ``return_trajectory`` ``(img, noisy_traj, x0_traj)``,
        each step's image and predicted x0 stacked on a leading step axis.

        The loop starts from noise plus ``init_images``. ``skip_steps`` k > 1
        keeps every k-th (t, t_next) pair and the last one (a stride, JAX
        gaussian.py:322-333), on the uniform or the non-uniform grid. With
        ``inpaint_images`` and ``inpaint_masks`` each step runs
        ``inpaint_resample_times`` rounds: the known region is replaced by
        the inpaint images noised to the step's time, and every round but
        the last renoises the result back to that time
        (``q_sample_from_to``), except on the last step. A self-conditioned
        U-Net (``unet.self_cond`` or ``use_self_cond``) gets the previous
        round's x0, zeros at first. Draws, in order: the initial image; per
        step and round, the inpaint noise (inpainting only), the step's
        noise, the renoise (inpainting, rounds but the last)."""
        batch = shape[0]
        img = noise(tuple(shape))
        if init_images is not None:
            img = img + init_images
        if self.non_uniform_times:
            t_cur, t_next = noise_scheduler.get_sampling_timesteps_non_uniform(
                batch, img.device, gamma=self.non_uniform_gamma)
        else:
            t_cur, t_next = noise_scheduler.get_sampling_timesteps(batch, img.device)
        if skip_steps is not None and skip_steps > 1:
            n_pairs = t_cur.shape[0]
            idx = list(range(0, n_pairs, skip_steps))
            if idx[-1] != n_pairs - 1:
                idx.append(n_pairs - 1)
            t_cur, t_next = t_cur[idx], t_next[idx]

        has_inpainting = inpaint_images is not None and inpaint_masks is not None
        resample_times = inpaint_resample_times if has_inpainting else 1
        self_cond = use_self_cond or getattr(unet, "self_cond", False)
        x_start = torch.zeros_like(img)
        noisy_traj, x0_traj = [], []
        for i in range(t_cur.shape[0]):
            times, times_next = t_cur[i], t_next[i]
            for r in reversed(range(resample_times)):
                if has_inpainting:
                    noised, *_ = noise_scheduler.q_sample(inpaint_images, times,
                                                          noise(tuple(img.shape)))
                    img = img * (1 - inpaint_masks) + noised * inpaint_masks
                img, x_start = self.p_sample(
                    unet, img, times, noise=noise, noise_scheduler=noise_scheduler,
                    t_next=times_next, lowres_cond_img=lowres_cond_img,
                    cond_images=cond_images, cond_scale=cond_scale,
                    self_cond=x_start if self_cond else None,
                    pred_objective=pred_objective, dynamic_threshold=dynamic_threshold)
                if has_inpainting and r != 0:
                    renoised = noise_scheduler.q_sample_from_to(
                        img, times_next, times, noise(tuple(img.shape)))
                    is_last = right_pad_dims_to(img, (times_next == 0).to(img.dtype))
                    img = img * is_last + renoised * (1 - is_last)
            if return_trajectory:
                noisy_traj.append(img)
                x0_traj.append(x_start)

        img = self.unnormalize_img(clamp_to_range(img, self.norm, self.min_bound))
        if return_trajectory:
            return img, torch.stack(noisy_traj), torch.stack(x0_traj)
        return img

    @torch.no_grad()
    def sample(self, *, batch_size: int = 1, noise: NoiseFn, cond_images=None,
               inpaint_images=None, inpaint_masks=None, inpaint_resample_times: int = 5,
               init_images=None, skip_steps=None,
               cond_scale: Union[float, Sequence[float]] = 1.0,
               start_at_unet_number: int = 1, start_image_or_video=None,
               stop_at_unet_number: Optional[int] = None,
               return_all_outputs: bool = False, return_trajectory: bool = False,
               lowres_sample_noise_level: Optional[float] = None):
        """Cascade sampling (reference ``Imagen.sample``, :2162-2274; JAX
        gaussian.py:420-489). ``start_image_or_video`` is the lowres input of
        the first sampled stage when ``start_at_unet_number > 1``;
        ``init_images``, ``skip_steps`` and ``cond_scale`` are per unet (one
        value for all, or one each). With ``return_trajectory``: ``(out,
        noisy_traj, x0_traj)`` of the last sampled stage.
        ``lowres_sample_noise_level`` is accepted as the JAX wrapper accepts
        it, and unused: the conditioning is never noised."""
        del lowres_sample_noise_level
        num_unets = self.num_unets
        cond_scale = cast_tuple(cond_scale, num_unets)
        init_images = cast_tuple(init_images, num_unets)
        skip_steps = cast_tuple(skip_steps, num_unets)
        img = None
        if start_at_unet_number > 1:
            if not 1 < start_at_unet_number <= num_unets:
                raise ValueError(f"start_at_unet_number {start_at_unet_number} "
                                 f"out of range for {num_unets} unets")
            if start_image_or_video is None:
                raise ValueError("starting image must be supplied if only "
                                 "doing upscaling")
            img = start_image_or_video

        outputs, traj = [], None
        for unet_number in range(start_at_unet_number, num_unets + 1):
            index = unet_number - 1
            unet = self.unets[index]
            lowres = img if getattr(unet, "lowres_cond", False) else None
            size = self.image_sizes[index]
            shape = (batch_size,) + (size,) * self.spatial_dims + (self.channels,)
            result = self.p_sample_loop(
                unet, shape, noise=noise, noise_scheduler=self.noise_schedulers[index],
                lowres_cond_img=lowres, cond_images=cond_images,
                inpaint_images=inpaint_images, inpaint_masks=inpaint_masks,
                inpaint_resample_times=inpaint_resample_times,
                init_images=init_images[index], skip_steps=skip_steps[index],
                cond_scale=cond_scale[index], pred_objective=self.pred_objectives[index],
                dynamic_threshold=self.dynamic_thresholding[index],
                return_trajectory=return_trajectory)
            if return_trajectory:
                img, *traj = result
            else:
                img = result
            outputs.append(img)
            if stop_at_unet_number == unet_number:
                break
        out = outputs if return_all_outputs else outputs[-1]
        return (out, *traj) if return_trajectory else out

    # ------------------------------------------------------------------
    def p_losses(self, unet, x_start, times, *, noise_scheduler, lowres_cond_img=None,
                 cond_images=None, noise=None, generator: Optional[torch.Generator] = None,
                 pred_objective: str = "noise", p2_loss_weight_gamma: float = 0.0):
        """Training loss (reference :2276-2387; JAX gaussian.py:492-564).
        Returns ``(loss, pred, x_noisy, lowres_cond_img)``. The images and
        the lowres conditioning go through ``auto_normalize_img``'s [-1, 1]
        map; the conditioning is not noised (reference :2303-2304); the
        U-Net gets ``cond_drop_prob``; an x_start prediction is clamped at
        ``min_bound`` before the loss (:2361-2362). The p2 weight is
        ``(p2_loss_weight_k + exp(log_snr)) ** -gamma``. With ``lpips_fn``
        the loss gains ``0.1 * lpips_fn(pred, target)`` on the clamped
        prediction (JAX gaussian.py:561-562); the term computes the
        target's features without a graph."""
        if noise is None:
            noise = standard_normal(x_start.shape, generator)
        x_start = self.normalize_img(x_start)
        if lowres_cond_img is not None:
            lowres_cond_img = self.normalize_img(lowres_cond_img)
        x_noisy, log_snr, _, _ = noise_scheduler.q_sample(x_start, times, noise)
        pred = unet(x_noisy, times, noise_scheduler.get_condition(times),
                    cond_drop_prob=self.cond_drop_prob,
                    **self._unet_kwargs(lowres_cond_img, cond_images, None))
        if pred_objective == "noise":
            target = noise
        elif pred_objective == "x_start":
            target = x_start
            pred = torch.clamp(pred, min=self.min_bound)
        elif pred_objective == "v":
            target = noise_scheduler.predict_v_from_start_and_noise(x_start, times, noise)
        else:
            raise ValueError(f"unknown objective {pred_objective}")
        losses = self.loss_fn(pred, target)
        losses = losses.reshape(losses.shape[0], -1).mean(dim=-1)
        if p2_loss_weight_gamma > 0:
            losses = losses * (self.p2_loss_weight_k + torch.exp(log_snr)) ** -p2_loss_weight_gamma
        loss = losses.mean()
        if self.lpips_fn is not None:
            loss = loss + 0.1 * self.lpips_fn(pred, target)
        return loss, pred, x_noisy, lowres_cond_img

    def forward(self, images, lowres_img=None, *, unet_number: Optional[int] = None,
                cond_images=None, generator: Optional[torch.Generator] = None, times=None,
                noise=None):
        """Draw the diffusion times and take :meth:`p_losses` (reference
        :2389-2443; JAX gaussian.py:566-621). ``times`` ``(B,)`` and
        ``noise`` (the shape of ``images``) are drawn from ``generator``
        when not given, in that order; under ``batch_sample`` one time is
        shared by the whole microbatch (:2428-2431). With
        ``only_train_unet_number`` set, another unet raises."""
        if self.num_unets > 1 and unet_number is None:
            raise ValueError("unet_number is required with more than one unet")
        unet_number = unet_number or 1
        if self.only_train_unet_number not in (None, unet_number):
            raise ValueError(f"this wrapper trains unet {self.only_train_unet_number} only, "
                             f"not unet {unet_number}")
        index = unet_number - 1
        scheduler = self.noise_schedulers[index]
        if images.shape[1] < self.image_sizes[index]:
            raise ValueError(f"images of edge {images.shape[1]} are smaller than the "
                             f"unet's {self.image_sizes[index]}")
        if lowres_img is None:
            raise ValueError("lowres image must be provided")
        draws = self.training_draws(generator, images.shape, unet_number=unet_number,
                                    times=times, noise=noise)
        return self.p_losses(
            self.unets[index], images, draws["times"], noise_scheduler=scheduler,
            lowres_cond_img=lowres_img, cond_images=cond_images, noise=draws["noise"],
            pred_objective=self.pred_objectives[index],
            p2_loss_weight_gamma=self.p2_loss_weight_gamma[index])

    def training_draws(self, generator: Optional[torch.Generator], shape: Tuple[int, ...],
                       lowres_shape: Optional[Tuple[int, ...]] = None, *,
                       unet_number: Optional[int] = None, times=None, noise=None) -> dict:
        """The draws :meth:`forward` makes for images of ``shape``, in its
        order: ``times`` ``(B,)`` (one expanded over the batch under
        ``batch_sample``), then ``noise``; the lowres conditioning is not
        noised, so ``lowres_shape`` draws nothing. Those given are kept, the
        rest come from ``generator``. The data-parallel trainer draws a global
        microbatch's and keeps its rows."""
        b = shape[0]
        if times is None:
            if generator is None:
                raise ValueError("pass a torch.Generator, or every draw of the loss")
            scheduler = self.noise_schedulers[(unet_number or 1) - 1]
            times = scheduler.sample_random_times(generator, 1 if self.batch_sample else b)
            times = times.expand(b) if self.batch_sample else times
        if noise is None:
            noise = standard_normal(shape, generator)
        return {"times": times, "noise": noise}


def perceptual_loss_from_config(cfg, device="cpu"):
    """The perceptual loss term that ``Train.medlpips`` / ``Train.lpips``
    ask for (JAX gaussian.py:629-647), on ``device``, or None: MedicalNet
    wins over VGG-LPIPS, and each reads its weights file when the config
    names one (``Train.medlpips_weights`` / ``Train.lpips_weights``), else
    builds its fixed-seed proxy."""
    if getattr(cfg.train, "medlpips", False):
        weights = getattr(cfg.train, "medlpips_weights", "") or None
        term = (medicalnet_perceptual_from_checkpoint(weights) if weights
                else MedicalNetPerceptual())
        return term.to(device)
    if getattr(cfg.train, "lpips", False):
        return make_lpips_fn(weights_path=getattr(cfg.train, "lpips_weights", "") or None,
                             device=device)
    return None


def imagen_from_config(cfg, unets) -> Imagen:
    """The Imagen wrapper as the reference entry scripts build it
    (reference train.py:118-133 / test.py:110-125; JAX gaussian.py:624-659):
    no p2 weighting, no conditioning dropout, no [0, 1] rescaling, the
    perceptual loss term of :func:`perceptual_loss_from_config` on the last
    unet's device, and the non-uniform sampling times of
    ``Train.non_uniform_sampling``. Refuses a ``Train.elucidated`` config,
    whose wrapper is ``diffusion/elucidated.py::elucidated_imagen_from_config``."""
    if cfg.train.elucidated:
        raise ValueError("the config sets Train.elucidated: build the EDM sampler "
                         "with elucidated_imagen_from_config")
    device = next(unets[-1].parameters()).device
    return Imagen(
        unets,
        image_sizes=(cfg.train.patch_size_sub, cfg.train.patch_size_sub),
        min_bound=cfg.data.min_bound,
        channels=cfg.train.channels,
        pred_objectives=cfg.train.pred_obj,
        timesteps=cfg.train.timesteps,
        dynamic_thresholding=cfg.train.dynamic_threshold,
        norm=cfg.data.norm,
        batch_sample=cfg.train.batch_sample,
        p2_loss_weight_gamma=0.0,
        auto_normalize_img=False,
        cond_drop_prob=0.0,
        lpips_fn=perceptual_loss_from_config(cfg, device),
        non_uniform_times=getattr(cfg.train, "non_uniform_sampling", False),
        non_uniform_gamma=getattr(cfg.train, "non_uniform_gamma", 10.0),
    )
