"""The diffusion arithmetic of the served and trained cells, in plain fp32
PyTorch: the cosine log-SNR schedule, one ancestral step of the x_start
objective with the z-score clamp, the training loss, and Adam.

imagen-pytorch's continuous-time ``GaussianDiffusionContinuousTimes``
(imagen_pytorch3D.py:222-357) and ``Imagen.p_sample`` / ``p_losses``
(:2032-2056, :2276-2387), as DiffusionIQT's configs use them: cosine
schedule, ``pred_objective='x_start'``, no dynamic thresholding (the
prediction is clamped at the z-score of raw intensity 0), l2 loss, no p2
weighting, the lowres conditioning never noised.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import unet


def log_snr(t: torch.Tensor, s: float = 0.008) -> torch.Tensor:
    """Cosine schedule in log-SNR form, ``-log(cos((t+s)/(1+s) pi/2)^-2 - 1)``
    with the inner term clamped at 1e-5."""
    inner = torch.cos((t + s) / (1 + s) * math.pi * 0.5) ** -2 - 1
    return -torch.log(torch.clamp(inner, min=1e-5))


def alpha_sigma(lsnr: torch.Tensor):
    return torch.sqrt(torch.sigmoid(lsnr)), torch.sqrt(torch.sigmoid(-lsnr))


def sampling_times(steps: int, device) -> torch.Tensor:
    """The uniform grid from 1 down to 0, ``steps + 1`` fp32 times."""
    return torch.linspace(1.0, 0.0, steps + 1, dtype=torch.float32, device=device)


def _rows(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return v.reshape(-1, *([1] * (x.dim() - 1)))


def ancestral_step(x_t, x0_pred, t, t_next, eps, min_bound: float):
    """``x_{t_next}`` from ``x_t`` and the denoiser's x0 prediction: the
    prediction clamped at ``min_bound``, the posterior mean, plus the
    posterior's standard deviation times ``eps`` unless ``t_next`` is 0.
    ``t`` and ``t_next`` are ``(B,)``."""
    x0 = torch.clamp(x0_pred, min=min_bound)
    lsnr, lsnr_next = _rows(log_snr(t), x_t), _rows(log_snr(t_next), x_t)
    alpha, _ = alpha_sigma(lsnr)
    alpha_next, sigma_next = alpha_sigma(lsnr_next)
    c = -torch.expm1(lsnr - lsnr_next)
    mean = alpha_next * (x_t * (1 - c) / alpha + c * x0)
    log_var = torch.log(torch.clamp(sigma_next ** 2 * c, min=1e-20))
    keep = _rows((t_next != 0).float(), x_t)
    return mean + keep * torch.exp(0.5 * log_var) * eps


def row_losses(P, arch, hr, lr, times, noise, min_bound: float, ctx=None):
    """Each row's training loss in one microbatch and the U-Net's raw
    output: ``hr`` diffused to ``times`` with ``noise``, the x0 prediction
    clamped at ``min_bound``, l2 against ``hr``, the mean over the row."""
    lsnr = log_snr(times)
    alpha, sigma = alpha_sigma(_rows(lsnr, hr))
    x_noisy = alpha * hr + sigma * noise
    out = unet.forward(P, arch, x_noisy, lsnr, lr, ctx)
    pred = torch.clamp(out, min=min_bound)
    return ((pred - hr) ** 2).reshape(hr.shape[0], -1).mean(dim=1), out


def loss(P, arch, hr, lr, times, noise, min_bound: float, ctx=None):
    """The training loss of one microbatch (the mean of
    :func:`row_losses` over the rows) and the U-Net's raw output."""
    rows, out = row_losses(P, arch, hr, lr, times, noise, min_bound, ctx)
    return rows.mean(), out


class Adam:
    """Adam with bias correction (Kingma and Ba), as a plain loop over the
    leaves: ``p -= lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, params, lr: float, betas=(0.9, 0.99), eps: float = 1e-8):
        self.params = params
        self.lr, (self.b1, self.b2), self.eps = lr, betas, eps
        self.m = {k: torch.zeros_like(p) for k, p in params.items()}
        self.v = {k: torch.zeros_like(p) for k, p in params.items()}
        self.steps = 0

    @torch.no_grad()
    def step(self, grads):
        self.steps += 1
        c1, c2 = 1 - self.b1 ** self.steps, 1 - self.b2 ** self.steps
        for k, p in self.params.items():
            g = grads[k]
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            p.sub_(self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps))
