"""The frozen work arithmetic: the FLOPs of a denoiser forward and the least
time of each fused Block launch, counted from the configuration's shapes.

The count runs the plain reference (``benchmark/reference/unet.py``) on
meta tensors, so nothing is computed and nothing of the program is read,
under a dispatch mode that applies the conv and matmul formulas:

  convolution : 2 * prod(out) * (weight elements / Cout)
  matmul      : 2 * prod(out) * contracted

Elementwise work is not counted. A Block's conv is one 3^3 convolution
(the boundary halo changes which voxels it reads, not how many products it
takes). A fused Block launch reads its input and weights and writes its
output once each, in bf16.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.harness import PEAK_BF16_FLOPS, PEAK_HBM_BYTES
from benchmark.reference import unet

aten = torch.ops.aten
_MATMUL = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0,
           aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1}


class _Count(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.conv = 0
        self.dot = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        if packet in _MATMUL:
            self.dot += 2 * out.numel() * int(args[_MATMUL[packet]].shape[-1])
        elif packet is aten.convolution:
            w = args[1]
            self.conv += 2 * out.numel() * w.numel() // w.shape[0]
        return out


def forward_work(arch: dict, rows: int, edge: int) -> Dict[str, object]:
    """``{"conv": FLOPs, "dot": FLOPs, "blocks": [(rows, edge, cin, cout)]}``
    of one denoiser forward over ``rows`` sub-volumes of ``edge``^3."""
    meta = torch.device("meta")
    weights = {k: torch.empty(s, device=meta) for k, s in unet.param_shapes(arch).items()}
    x = torch.empty((rows, edge, edge, edge, arch["channels"]), device=meta)
    blocks: List[tuple] = []
    with _Count() as count:
        unet.forward(weights, arch, x, torch.empty((rows,), device=meta), x,
                     unet.Ctx(blocks=blocks))
    return {"conv": count.conv, "dot": count.dot, "blocks": blocks}


def block_flops(rows: int, edge: int, cin: int, cout: int) -> int:
    return 2 * rows * edge ** 3 * cout * cin * 27


def block_bytes(rows: int, edge: int, cin: int, cout: int) -> int:
    return 2 * (rows * edge ** 3 * (cin + cout) + cout * cin * 27)


def block_least_s(blocks) -> float:
    """The least time of the Blocks' launches on the card: for each, the
    larger of its FLOPs at the bf16 peak and its bytes at the HBM peak."""
    return sum(max(block_flops(*b) / PEAK_BF16_FLOPS, block_bytes(*b) / PEAK_HBM_BYTES)
               for b in blocks)


def forward_flops(arch: dict, rows: int, edge: int) -> float:
    work = forward_work(arch, rows, edge)
    return float(work["conv"] + work["dot"])

