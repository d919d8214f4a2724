"""Small shared helpers (counterpart of ``diffusioniqt_tpu/utils/misc.py``)."""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F


def exists(val: Any) -> bool:
    return val is not None


def default(val, d):
    if val is not None:
        return val
    return d() if callable(d) else d


def cast_tuple(val, length: Optional[int] = None) -> Tuple:
    """Reference ``cast_tuple`` semantics (imagen_pytorch3D.py:91-100)."""
    if isinstance(val, list):
        val = tuple(val)
    output = val if isinstance(val, tuple) else ((val,) * (length or 1))
    if length is not None and len(output) != length:
        raise ValueError(f"tuple length {len(output)} != expected {length}")
    return output


def pad_tuple_to_length(t: Tuple, length: int, fillvalue=None) -> Tuple:
    remain = length - len(t)
    if remain <= 0:
        return t
    return (*t, *((fillvalue,) * remain))


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation: x * tanh(softplus(x)) (the reference's default
    nonlinearity, e.g. imagen_pytorch3D.py:547)."""
    return x * torch.tanh(F.softplus(x))


class Mish(torch.nn.Module):
    """:func:`mish` as a module, for ``nn.Sequential`` slots that carry the
    reference's parameter names."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mish(x)


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising when CUDA is asked for and this
    process has none: entry points run on the card unless the caller asks
    for ``device="cpu"``, and never carry on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return device
