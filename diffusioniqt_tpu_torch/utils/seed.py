"""Seeding helpers (counterpart of ``diffusioniqt_tpu/utils/seed.py``;
reference ``utils_mine.set_seed``, utils_mine.py:8-14)."""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed numpy, Python and torch's default generators (the CUDA ones
    too). The trainer draws its diffusion times and noise from a generator
    of its own; the default generators feed the attention dropout."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)
