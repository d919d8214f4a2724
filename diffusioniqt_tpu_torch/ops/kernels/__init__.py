"""Hand-written CUDA kernels of the main path and their plain versions.

Each kernel module holds the wrapper (CUDA kernel for a CUDA tensor, plain
PyTorch version for a CPU tensor, with a ``launches`` counter), the plain
version, and a note naming the TPU kernel it replaces:

* ``halo``        <- ``diffusioniqt_tpu/ops/pallas/halo.py::halo_exchange_pallas``
* ``conv3d``      <- ``diffusioniqt_tpu/ops/pallas/conv3d.py::conv3d_valid``
* ``fused_block`` <- ``diffusioniqt_tpu/ops/pallas/fused_block.py::fused_boundary_block``

:data:`KERNELS` and :data:`PLAIN` bundle the three entry points the model
calls. Models use :data:`KERNELS`; :data:`PLAIN` runs the plain versions
on any device, so a whole forward can be held against the kernels on the
card (``chip_smoke.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from diffusioniqt_tpu_torch.ops.kernels.conv3d import conv3d_valid, conv3d_valid_plain
from diffusioniqt_tpu_torch.ops.kernels.fused_block import fused_conv, fused_conv_plain
from diffusioniqt_tpu_torch.ops.kernels.halo import halo_exchange, halo_exchange_plain


@dataclass(frozen=True)
class Ops:
    """``halo(x, factor)``, ``conv3d(xh, w, cache)`` and
    ``fused_conv(xh, a_tab, b_tab, w, cache)``."""

    halo: Callable
    conv3d: Callable
    fused_conv: Callable


KERNELS = Ops(halo=halo_exchange, conv3d=conv3d_valid, fused_conv=fused_conv)
PLAIN = Ops(
    halo=halo_exchange_plain,
    conv3d=lambda xh, w, cache=None: conv3d_valid_plain(xh, w),
    fused_conv=lambda xh, a, b, w, cache=None: fused_conv_plain(xh, a, b, w),
)


def launch_counts() -> dict:
    """Launches of each kernel so far in this process."""
    return {"halo": halo_exchange.launches, "conv3d": conv3d_valid.launches,
            "fused_block": fused_conv.launches}


def reset_launch_counts() -> None:
    halo_exchange.launches = 0
    conv3d_valid.launches = 0
    fused_conv.launches = 0
