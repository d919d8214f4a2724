"""Cascaded continuous-time Gaussian diffusion (counterpart of
``diffusioniqt_tpu/diffusion/gaussian.py``; reference ``Imagen``,
imagen_pytorch3D.py:1741-2443).

  * ``p_mean_variance`` with the noise / x_start / v objectives, dynamic
    thresholding and the z-score ``min_bound`` clamp (:1976-2030)
  * ancestral ``p_sample`` / ``p_sample_loop`` (:2032-2160) as a Python
    loop over the steps, on the uniform time grid or, with
    ``non_uniform_times``, the exponentially weighted one (JAX
    gaussian.py:322-327)
  * cascade ``sample`` with ``start_at_unet_number`` (:2162-2274): the IQT
    entry points sample unet 2 over a ``NullUnet`` first stage, starting
    from the lowres patches
  * the training loss ``p_losses`` (:2276-2387) with the three objectives,
    the x_start ``min_bound`` clamp, p2 weighting, the loss table and the
    optional perceptual term ``0.1 * lpips_fn(pred, target)`` (:2372-2385),
    and ``forward`` (:2389-2443), which draws the diffusion times (one
    shared by the whole microbatch under ``batch_sample``)

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


class Imagen:
    """Cascaded DDPM sampler over one or more U-Nets (``nn.Module``s whose
    forward is ``unet(x, t, log_snr, lowres_cond_img=...)``)."""

    def __init__(
        self,
        unets,
        *,
        image_sizes: Sequence[int],
        min_bound: float = 0.0,
        channels: int = 3,
        timesteps: Union[int, Sequence[int]] = 1000,
        noise_schedules: Union[str, Sequence[str]] = "cosine",
        pred_objectives: Union[str, Sequence[str]] = "noise",
        dynamic_thresholding: Union[bool, Sequence[bool]] = True,
        dynamic_thresholding_percentile: float = 0.95,
        norm: str = "z-score",
        batch_sample: bool = False,
        loss_type: str = "l2",
        p2_loss_weight_gamma: Union[float, Sequence[float]] = 0.5,
        lpips_fn: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None,
        non_uniform_times: bool = False,
        non_uniform_gamma: float = 10.0,
    ):
        unets = list(unets) if isinstance(unets, (list, tuple)) else [unets]
        num_unets = len(unets)
        self.channels = channels
        # the perceptual loss term (metrics/lpips.py::make_lpips_fn or
        # metrics/medicalnet.py::MedicalNetPerceptual): a frozen network
        # outside the unets, so outside their optimizer, EMA and bundles
        self.lpips_fn = lpips_fn
        self.non_uniform_times = non_uniform_times
        self.non_uniform_gamma = non_uniform_gamma
        self.norm = norm
        self.min_bound = float(min_bound)
        self.batch_sample = batch_sample
        if loss_type not in _LOSSES:
            raise NotImplementedError(f"unknown loss type {loss_type}")
        self.loss_fn = _LOSSES[loss_type]
        self.p2_loss_weight_gamma = cast_tuple(p2_loss_weight_gamma, num_unets)
        if any(g > 2 for g in self.p2_loss_weight_gamma):
            raise ValueError("p2_loss_weight_gamma must be at most 2")

        noise_schedules = cast_tuple(noise_schedules)
        noise_schedules = pad_tuple_to_length(noise_schedules, 2, "cosine")
        noise_schedules = pad_tuple_to_length(noise_schedules, num_unets, "linear")
        timesteps = cast_tuple(timesteps, num_unets)
        self.noise_schedulers = [
            GaussianDiffusionContinuousTimes(noise_schedule=s, timesteps=t)
            for t, s in zip(timesteps, noise_schedules)
        ]
        self.pred_objectives = cast_tuple(pred_objectives, num_unets)
        self.image_sizes = cast_tuple(tuple(image_sizes))
        if num_unets != len(self.image_sizes):
            raise ValueError("one image size per unet")

        # cascade conditioning: first unet unconditioned, the rest
        # lowres-conditioned (reference :1848-1858). The JAX wrapper
        # re-instantiates the modules; here they must already match.
        for ind, unet in enumerate(unets):
            if ind > 0 and not getattr(unet, "lowres_cond", False):
                raise ValueError(f"unet {ind + 1} must be lowres-conditioned")
        self.unets = unets
        self.dynamic_thresholding = cast_tuple(dynamic_thresholding, num_unets)
        self.dynamic_thresholding_percentile = dynamic_thresholding_percentile

    # ------------------------------------------------------------------
    def p_mean_variance(self, unet, x, t, *, noise_scheduler, t_next=None,
                        lowres_cond_img=None, self_cond=None, model_output=None,
                        pred_objective: str = "noise",
                        dynamic_threshold: bool = True):
        """Posterior mean / variance and the predicted x0 (reference
        :1976-2030). ``self_cond`` is the previous step's x0 for a
        self-conditioned U-Net (None: the U-Net's zeros)."""
        pred = model_output
        if pred is None:
            extra = {} if self_cond is None else {"self_cond": self_cond}
            pred = unet(x, t, noise_scheduler.get_condition(t),
                        lowres_cond_img=lowres_cond_img, **extra)
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

    def p_sample(self, unet, x, t, *, noise: NoiseFn, noise_scheduler,
                 t_next=None, **kwargs):
        """One ancestral step (reference :2032-2056). The noise is drawn on
        every step, the last included, as the JAX loop does."""
        b = x.shape[0]
        (model_mean, _, model_log_variance), x_start = self.p_mean_variance(
            unet, x, t, noise_scheduler=noise_scheduler, t_next=t_next, **kwargs)
        eps = noise(tuple(x.shape))
        nonzero_mask = (1.0 - (t_next == 0).float()).reshape(b, *((1,) * (x.dim() - 1)))
        pred = model_mean + nonzero_mask * torch.exp(0.5 * model_log_variance) * eps
        return pred, x_start

    @torch.no_grad()
    def p_sample_loop(self, unet, shape: Tuple[int, ...], *, noise: NoiseFn,
                      noise_scheduler: GaussianDiffusionContinuousTimes,
                      lowres_cond_img=None, pred_objective: str = "noise",
                      dynamic_threshold: bool = True):
        """Full ancestral sampling from pure noise (reference :2058-2160).
        A self-conditioned U-Net (``unet.self_cond``) gets each step's
        predicted x0 at the next step, zeros at the first (JAX
        gaussian.py:345,359-365,385)."""
        batch = shape[0]
        img = noise(tuple(shape))
        if self.non_uniform_times:
            t_cur, t_next = noise_scheduler.get_sampling_timesteps_non_uniform(
                batch, img.device, gamma=self.non_uniform_gamma)
        else:
            t_cur, t_next = noise_scheduler.get_sampling_timesteps(batch, img.device)
        self_cond = getattr(unet, "self_cond", False)
        x_start = torch.zeros_like(img)
        for i in range(t_cur.shape[0]):
            img, x_start = self.p_sample(
                unet, img, t_cur[i], noise=noise,
                noise_scheduler=noise_scheduler, t_next=t_next[i],
                lowres_cond_img=lowres_cond_img,
                self_cond=x_start if self_cond else None,
                pred_objective=pred_objective, dynamic_threshold=dynamic_threshold,
            )
        return clamp_to_range(img, self.norm, self.min_bound)

    def sample(self, *, batch_size: int, noise: NoiseFn,
               start_at_unet_number: int = 1, start_image_or_video=None,
               stop_at_unet_number: Optional[int] = None,
               return_all_outputs: bool = False):
        """Cascade sampling (reference ``Imagen.sample``, :2162-2274).
        ``start_image_or_video`` is the lowres input of the first sampled
        stage when ``start_at_unet_number > 1``."""
        num_unets = len(self.unets)
        img = None
        if start_at_unet_number > 1:
            if not 1 < start_at_unet_number <= num_unets:
                raise ValueError(f"start_at_unet_number {start_at_unet_number} "
                                 f"out of range for {num_unets} unets")
            if start_image_or_video is None:
                raise ValueError("starting image must be supplied if only "
                                 "doing upscaling")
            img = start_image_or_video

        outputs = []
        for unet_number in range(start_at_unet_number, num_unets + 1):
            index = unet_number - 1
            unet = self.unets[index]
            lowres = img if getattr(unet, "lowres_cond", False) else None
            size = self.image_sizes[index]
            shape = (batch_size,) + (size,) * 3 + (self.channels,)
            img = self.p_sample_loop(
                unet, shape, noise=noise,
                noise_scheduler=self.noise_schedulers[index],
                lowres_cond_img=lowres,
                pred_objective=self.pred_objectives[index],
                dynamic_threshold=self.dynamic_thresholding[index],
            )
            outputs.append(img)
            if stop_at_unet_number == unet_number:
                break
        return outputs if return_all_outputs else outputs[-1]

    # ------------------------------------------------------------------
    @property
    def num_unets(self) -> int:
        return len(self.unets)

    def p_losses(self, unet, x_start, times, *, noise_scheduler, lowres_cond_img=None,
                 noise=None, generator: Optional[torch.Generator] = None,
                 pred_objective: str = "noise", p2_loss_weight_gamma: float = 0.0):
        """Training loss (reference :2276-2387; JAX gaussian.py:492-564).
        Returns ``(loss, pred, x_noisy, lowres_cond_img)``. The lowres
        conditioning is not noised (reference :2303-2304), and an x_start
        prediction is clamped at ``min_bound`` before the loss
        (:2361-2362). The p2 weight is ``(1 + exp(log_snr)) ** -gamma`` (the
        JAX default ``p2_loss_weight_k`` 1, which no caller changes). With
        ``lpips_fn`` the loss gains ``0.1 * lpips_fn(pred, target)`` on the
        clamped prediction (JAX gaussian.py:561-562); the term computes the
        target's features without a graph."""
        if noise is None:
            noise = standard_normal(x_start.shape, generator)
        x_noisy, log_snr, alpha, sigma = noise_scheduler.q_sample(x_start, times, noise)
        pred = unet(x_noisy, times, noise_scheduler.get_condition(times),
                    lowres_cond_img=lowres_cond_img)
        if pred_objective == "noise":
            target = noise
        elif pred_objective == "x_start":
            target = x_start
            pred = torch.clamp(pred, min=self.min_bound)
        elif pred_objective == "v":
            target = alpha * noise - sigma * x_start
        else:
            raise ValueError(f"unknown objective {pred_objective}")
        losses = self.loss_fn(pred, target)
        losses = losses.reshape(losses.shape[0], -1).mean(dim=-1)
        if p2_loss_weight_gamma > 0:
            losses = losses * (1.0 + torch.exp(log_snr)) ** -p2_loss_weight_gamma
        loss = losses.mean()
        if self.lpips_fn is not None:
            loss = loss + 0.1 * self.lpips_fn(pred, target)
        return loss, pred, x_noisy, lowres_cond_img

    def forward(self, images, lowres_img=None, *, unet_number: Optional[int] = None,
                generator: Optional[torch.Generator] = None, times=None, noise=None):
        """Draw the diffusion times and take :meth:`p_losses` (reference
        :2389-2443; JAX gaussian.py:566-621). ``times`` ``(B,)`` and
        ``noise`` (the shape of ``images``) are drawn from ``generator``
        when not given, in that order; under ``batch_sample`` one time is
        shared by the whole microbatch (:2428-2431)."""
        if self.num_unets > 1 and unet_number is None:
            raise ValueError("unet_number is required with more than one unet")
        index = (unet_number or 1) - 1
        scheduler = self.noise_schedulers[index]
        b = images.shape[0]
        if images.shape[1] < self.image_sizes[index]:
            raise ValueError(f"images of edge {images.shape[1]} are smaller than the "
                             f"unet's {self.image_sizes[index]}")
        if lowres_img is None:
            raise ValueError("lowres image must be provided")
        draws = self.training_draws(generator, images.shape, unet_number=unet_number,
                                    times=times, noise=noise)
        return self.p_losses(
            self.unets[index], images, draws["times"], noise_scheduler=scheduler,
            lowres_cond_img=lowres_img, noise=draws["noise"],
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
    no p2 weighting (and no conditioning dropout, which the IQT U-Net
    ignores), the perceptual loss term of :func:`perceptual_loss_from_config`
    on the last unet's device, and the non-uniform sampling times of
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
        lpips_fn=perceptual_loss_from_config(cfg, device),
        non_uniform_times=getattr(cfg.train, "non_uniform_sampling", False),
        non_uniform_gamma=getattr(cfg.train, "non_uniform_gamma", 10.0),
    )
