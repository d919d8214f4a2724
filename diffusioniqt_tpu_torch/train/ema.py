"""Exponential moving average of parameters (counterpart of
``diffusioniqt_tpu/train/ema.py``): ema-pytorch's warm-up ramp with the
reference's defaults (beta 0.9999, update_after_step 100, update_every 10,
inv_gamma 1, power 2/3), over the parameters of a separate fp32 EMA module.
"""

from __future__ import annotations

import torch
import torch.nn as nn


def ema_decay_schedule(step: int, beta: float = 0.9999, update_after_step: int = 100,
                       inv_gamma: float = 1.0, power: float = 2.0 / 3.0,
                       min_value: float = 0.0) -> float:
    """ema-pytorch's ramped decay: ``1 - (1 + epoch / inv_gamma) ** -power``
    clamped to ``[min_value, beta]``, ``epoch = max(step - update_after_step
    - 1, 0)``; zero up to ``update_after_step`` (the EMA copies the online
    parameters). Computed in fp32 like the JAX schedule."""
    if step <= update_after_step:
        return 0.0
    epoch = torch.tensor(float(max(step - update_after_step - 1, 0)), dtype=torch.float32)
    value = 1.0 - (1.0 + epoch / inv_gamma) ** -power
    return float(torch.clamp(value, min_value, beta))


@torch.no_grad()
def ema_update(ema_model: nn.Module, online: nn.Module, step: int,
               beta: float = 0.9999, update_after_step: int = 100,
               inv_gamma: float = 1.0, power: float = 2.0 / 3.0) -> float:
    """One EMA update, ``ema <- ema * decay + online * (1 - decay)``, as an
    in-place lerp over the EMA module's parameters; returns the decay.

    ``step`` is the trainer's optimizer-step count, not the number of EMA
    updates so far: ema-pytorch advances its counter on every trainer step
    and applies the average only every ``update_every`` of them (JAX
    ema.py:58-67), so the ramp follows the optimizer."""
    decay = ema_decay_schedule(step, beta=beta, update_after_step=update_after_step,
                               inv_gamma=inv_gamma, power=power)
    ema_params = list(ema_model.parameters())
    new_params = [p.detach().to(e.dtype) for e, p in zip(ema_params, online.parameters())]
    if len(ema_params) != len(new_params):
        raise ValueError("the EMA module and the online module differ in parameters")
    # lerp is exact at weight 1: while the decay is 0 the EMA equals the
    # online parameters bit for bit
    torch._foreach_lerp_(ema_params, new_params, 1.0 - decay)
    # on CUDA the foreach op does not bump the version counters, which the
    # kernels' packed-weight caches key on (ops/kernels/conv3d.py)
    torch.autograd.graph.increment_version(ema_params)
    return decay
