"""Continuous-time Gaussian diffusion schedules (counterpart of
``diffusioniqt_tpu/core/schedules.py``), pure functions of ``t in [0, 1]``
on tensors (reference ``GaussianDiffusionContinuousTimes``,
imagen_pytorch3D.py:222-357, after @crowsonkb's v-diffusion).

  log_snr(t)         — noise schedule, cosine or linear
  alpha, sigma       — sqrt(sigmoid(+/- log_snr))
  sample_random_times — uniform training times from a ``torch.Generator``
  get_sampling_timesteps[_non_uniform] — the sampler's (t, t_next) pairs,
                       uniform or exponentially weighted towards t = 0
  q_sample           — diffuse x0 to time t (the training loss, the EDM
                       lowres noise aug)
  q_sample_from_to   — renoise from time t to an earlier, noisier one (the
                       ancestral sampler's inpainting resample)
  q_posterior        — DDPM ancestral posterior, continuous-time form
  predict_start_*    — invert the noise / v parameterisations
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch


def safe_log(t: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """log with the input clamped from below (reference ``log``, :141-142)."""
    return torch.log(torch.clamp(t, min=eps))


def beta_linear_log_snr(t: torch.Tensor) -> torch.Tensor:
    """Linear-beta schedule in log-SNR form (reference :225-227)."""
    return -torch.log(torch.expm1(1e-4 + 10 * (t ** 2)))


def alpha_cosine_log_snr(t: torch.Tensor, s: float = 0.008) -> torch.Tensor:
    """Cosine schedule in log-SNR form (reference :229-231)."""
    return -safe_log(
        (torch.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2) - 1, eps=1e-5
    )


def log_snr_to_alpha_sigma(log_snr: torch.Tensor):
    """alpha = sqrt(sigmoid(log_snr)), sigma = sqrt(sigmoid(-log_snr))."""
    return torch.sqrt(torch.sigmoid(log_snr)), torch.sqrt(torch.sigmoid(-log_snr))


def right_pad_dims_to(x: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Append singleton dims to ``t`` until it broadcasts against ``x``."""
    padding_dims = x.dim() - t.dim()
    if padding_dims <= 0:
        return t
    return t.reshape(t.shape + (1,) * padding_dims)


_SCHEDULES = {
    "linear": beta_linear_log_snr,
    "cosine": alpha_cosine_log_snr,
}


@dataclass(frozen=True)
class GaussianDiffusionContinuousTimes:
    """Stateless continuous-time scheduler (reference :236-357)."""

    noise_schedule: str = "cosine"
    timesteps: int = 1000

    def __post_init__(self):
        if self.noise_schedule not in _SCHEDULES:
            raise ValueError(f"invalid noise schedule {self.noise_schedule}")

    def log_snr(self, t: torch.Tensor) -> torch.Tensor:
        return _SCHEDULES[self.noise_schedule](t)

    def get_condition(self, times):
        """The U-Net's time conditioning is the raw log-SNR (reference
        :258-259)."""
        return None if times is None else self.log_snr(times)

    def sample_random_times(self, generator: torch.Generator, batch_size: int) -> torch.Tensor:
        """Training times ``t ~ U[0, 1)``, ``(batch_size,)`` fp32, drawn from
        ``generator`` on its device (reference :255-256)."""
        return torch.rand((batch_size,), generator=generator, device=generator.device,
                          dtype=torch.float32)

    def get_sampling_timesteps(self, batch: int, device="cpu"
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fencepost pairs (t, t_next), each ``(T, batch)`` fp32, from 1 down
        to 0 (reference :261-266)."""
        times = torch.linspace(1.0, 0.0, self.timesteps + 1,
                               dtype=torch.float32, device=device)
        t_cur = times[:-1, None].expand(self.timesteps, batch)
        t_next = times[1:, None].expand(self.timesteps, batch)
        return t_cur, t_next

    def get_sampling_timesteps_non_uniform(self, batch: int, device="cpu", seed: int = 0,
                                           gamma: float = 10.0, large_timesteps: int = 10000
                                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exponentially weighted non-uniform sampling times (reference
        :268-288; JAX schedules.py:105-125): ``timesteps`` distinct times of
        a ``large_timesteps`` grid, drawn on the host by
        ``numpy.random.default_rng(seed)`` with probability proportional to
        ``exp(-gamma * t)``, 1.0 and 0.0 always included, in descending
        order; the same fencepost pairs, ``(T', batch)`` each."""
        rng = np.random.default_rng(seed)
        times = np.linspace(1.0, 0.0, large_timesteps)
        probs = np.exp(-gamma * times).astype(np.float64)
        probs /= probs.sum()
        ts = rng.choice(times, self.timesteps, p=probs, replace=False)
        if 1.0 not in ts:
            ts = np.concatenate([ts, [1.0]])
        if 0.0 not in ts:
            ts = np.concatenate([ts, [0.0]])
        ts = torch.tensor(np.sort(ts)[::-1].copy(), dtype=torch.float32, device=device)
        n = ts.shape[0] - 1
        return ts[:-1, None].expand(n, batch), ts[1:, None].expand(n, batch)

    def q_sample(self, x_start, t, noise):
        """Diffuse x0 to time ``t``: ``(x_t, log_snr, alpha, sigma)``
        (reference :311-322)."""
        log_snr = self.log_snr(t).to(x_start.dtype)
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_start, log_snr))
        return alpha * x_start + sigma * noise, log_snr, alpha, sigma

    def q_sample_from_to(self, x_from, from_t, to_t, noise):
        """Renoise ``x_from`` at time ``from_t`` to the noisier ``to_t``
        (reference :324-344; JAX schedules.py:143-160); a float time is
        taken for every row."""
        batch = x_from.shape[0]
        from_t, to_t = (torch.full((batch,), t, dtype=x_from.dtype, device=x_from.device)
                        if isinstance(t, float) else t for t in (from_t, to_t))
        alpha, sigma = log_snr_to_alpha_sigma(right_pad_dims_to(x_from, self.log_snr(from_t)))
        alpha_to, sigma_to = log_snr_to_alpha_sigma(
            right_pad_dims_to(x_from, self.log_snr(to_t)))
        return x_from * (alpha_to / alpha) + noise * (sigma_to * alpha - sigma * alpha_to) / alpha

    def q_posterior(self, x_start, x_t, t, t_next=None):
        """Posterior q(x_s | x_t, x0) mean / variance / clipped log variance
        (reference :290-309)."""
        if t_next is None:
            t_next = torch.clamp(t - 1.0 / self.timesteps, min=0.0)
        log_snr = right_pad_dims_to(x_t, self.log_snr(t))
        log_snr_next = right_pad_dims_to(x_t, self.log_snr(t_next))
        alpha, _ = log_snr_to_alpha_sigma(log_snr)
        alpha_next, sigma_next = log_snr_to_alpha_sigma(log_snr_next)
        c = -torch.expm1(log_snr - log_snr_next)
        posterior_mean = alpha_next * (x_t * (1 - c) / alpha + c * x_start)
        posterior_variance = (sigma_next ** 2) * c
        posterior_log_variance = safe_log(posterior_variance, eps=1e-20)
        return posterior_mean, posterior_variance, posterior_log_variance

    def predict_start_from_v(self, x_t, t, v):
        """x0 from v-prediction (reference :346-350)."""
        log_snr = right_pad_dims_to(x_t, self.log_snr(t))
        alpha, sigma = log_snr_to_alpha_sigma(log_snr)
        return alpha * x_t - sigma * v

    def predict_start_from_noise(self, x_t, t, noise):
        """x0 from eps-prediction (reference :352-357)."""
        log_snr = right_pad_dims_to(x_t, self.log_snr(t))
        alpha, sigma = log_snr_to_alpha_sigma(log_snr)
        return (x_t - sigma * noise) / torch.clamp(alpha, min=1e-8)
