"""EDM (Karras et al. 2022, "Elucidating the Design Space...") math
(counterpart of ``diffusioniqt_tpu/core/edm.py``): the preconditioning of
Table 1, the rho-spaced sampling schedule, the churn per step, and the
training sigma distribution and loss weight (reference
``elucidated_imagen.py:96-106`` for the defaults, ``:314-379`` and
``:702-710`` for the math).

Sigmas are fp32, as in the JAX package. Randomness comes only from the
``torch.Generator`` a caller passes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch


@dataclass(frozen=True)
class EDMParams:
    """Per-unet EDM hyperparameters (reference ``Hparams`` fields,
    elucidated_imagen.py:96-106 / :245-259)."""

    num_sample_steps: int = 32
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0
    P_mean: float = -1.2
    P_std: float = 1.2
    S_churn: float = 80.0
    S_tmin: float = 0.05
    S_tmax: float = 50.0
    S_noise: float = 1.003

    # --- preconditioning, Table 1 (reference :314-324) --------------------
    def c_skip(self, sigma):
        return (self.sigma_data ** 2) / (sigma ** 2 + self.sigma_data ** 2)

    def c_out(self, sigma):
        return sigma * self.sigma_data * (self.sigma_data ** 2 + sigma ** 2) ** -0.5

    def c_in(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) ** -0.5

    def c_noise(self, sigma):
        return torch.log(torch.clamp(sigma, min=1e-12)) * 0.25

    # --- sampling schedule, eq. 5 (reference :365-379) --------------------
    def sample_schedule(self, num_sample_steps: Optional[int] = None) -> torch.Tensor:
        """rho-spaced sigmas, descending, with a trailing 0. Shape (N+1,),
        fp32, on the CPU."""
        n = num_sample_steps or self.num_sample_steps
        inv_rho = 1.0 / self.rho
        steps = torch.arange(n, dtype=torch.float32)
        sigmas = (
            self.sigma_max ** inv_rho
            + steps / (n - 1) * (self.sigma_min ** inv_rho - self.sigma_max ** inv_rho)
        ) ** self.rho
        return torch.cat([sigmas, torch.zeros(1, dtype=torch.float32)])

    def gammas(self, sigmas: torch.Tensor,
               num_sample_steps: Optional[int] = None) -> torch.Tensor:
        """Churn amount per step (reference :418-422)."""
        n = num_sample_steps or self.num_sample_steps
        churn = min(self.S_churn / n, math.sqrt(2.0) - 1.0)
        inside = (sigmas >= self.S_tmin) & (sigmas <= self.S_tmax)
        return torch.where(inside, torch.full_like(sigmas, churn), torch.zeros_like(sigmas))

    # --- training distribution & loss weight (reference :702-710) ---------
    def noise_distribution(self, generator: torch.Generator, batch: int) -> torch.Tensor:
        """sigma ~ exp(N(P_mean, P_std)), on the generator's device."""
        normal = torch.randn((batch,), generator=generator, device=generator.device,
                             dtype=torch.float32)
        return torch.exp(self.P_mean + self.P_std * normal)

    def loss_weight(self, sigma):
        return (sigma ** 2 + self.sigma_data ** 2) * (sigma * self.sigma_data) ** -2
