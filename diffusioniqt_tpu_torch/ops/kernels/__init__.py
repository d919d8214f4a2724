"""Hand-written CUDA kernels of the main path and their plain versions.

Each kernel module holds the wrapper (CUDA kernel for a CUDA tensor, plain
PyTorch version for a CPU tensor; each launch counted by the recorder,
``utils/profiling.py``, as ``kernels.launches.<kernel>``, and timed on the
host while it records), the plain
version, and a note naming the TPU kernel it replaces:

* ``halo``        <- ``diffusioniqt_tpu/ops/pallas/halo.py::halo_exchange_pallas``
* ``conv3d``      <- ``diffusioniqt_tpu/ops/pallas/conv3d.py::conv3d_valid``
* ``fused_block`` <- ``diffusioniqt_tpu/ops/pallas/fused_block.py::fused_boundary_block``
  (two routes: ``fused_block`` counts the implicit GEMM's launches at edges
  that are multiples of 8, ``fused_block_small`` the small-edge route's at
  edges 4 and 2)
* ``flash_attention`` <- ``diffusioniqt_tpu/ops/pallas/flash_attention.py::flash_attention``

:data:`KERNELS` and :data:`PLAIN` bundle the four entry points the model
calls. Models use :data:`KERNELS`; :data:`PLAIN` runs the plain versions
on any device, so a whole forward can be held against the kernels on the
card (``chip_smoke.py``).

The train and evaluate entry points print :func:`launch_counts` last, as
one line that starts with :data:`LAUNCHES_LINE`, so a caller that runs them
as subprocesses reads which kernels they launched.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Callable

from diffusioniqt_tpu_torch.ops.attention import attention_reference
from diffusioniqt_tpu_torch.ops.kernels.conv3d import conv3d_valid, conv3d_valid_plain
from diffusioniqt_tpu_torch.ops.kernels.flash_attention import flash_attention
from diffusioniqt_tpu_torch.ops.kernels.fused_block import fused_conv, fused_conv_plain
from diffusioniqt_tpu_torch.ops.kernels.halo import halo_exchange, halo_exchange_plain
from diffusioniqt_tpu_torch.utils import profiling


@dataclass(frozen=True)
class Ops:
    """``halo(x, factor)``, ``conv3d(xh, w, cache)``,
    ``fused_conv(xh, a_tab, b_tab, w, cache)`` and
    ``attention(q, k, v, scale)``."""

    halo: Callable
    conv3d: Callable
    fused_conv: Callable
    attention: Callable


KERNELS = Ops(halo=halo_exchange, conv3d=conv3d_valid, fused_conv=fused_conv,
              attention=flash_attention)
PLAIN = Ops(
    halo=halo_exchange_plain,
    conv3d=lambda xh, w, cache=None: conv3d_valid_plain(xh, w),
    fused_conv=lambda xh, a, b, w, cache=None: fused_conv_plain(xh, a, b, w),
    attention=attention_reference,
)


KERNEL_NAMES = ("halo", "conv3d", "fused_block", "fused_block_small", "flash_attention")


def launch_counts() -> dict:
    """Launches of each kernel so far in this process (since the last
    :func:`reset_launch_counts`)."""
    return {k: profiling.counter(profiling.LAUNCHES + k) for k in KERNEL_NAMES}


def reset_launch_counts() -> None:
    profiling.reset_counters(profiling.LAUNCHES)


LAUNCHES_LINE = "Kernel launches: "


def launches_line() -> str:
    """:data:`LAUNCHES_LINE` and :func:`launch_counts` as JSON."""
    return LAUNCHES_LINE + json.dumps(launch_counts())
