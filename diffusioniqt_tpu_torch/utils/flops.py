"""Conv and matmul FLOP accounting (counterpart of
``diffusioniqt_tpu/utils/flops.py``).

The JAX walker counts the ``conv_general_dilated`` and ``dot_general`` of a
traced program, a scan's body times its length. Here :func:`flop_counts`
runs the function under a dispatch mode that counts every convolution and
matrix product that reaches the dispatcher, so each pass of a Python
sampler loop counts, with the JAX walker's formulas:

  convolution : 2 * prod(out_shape) * (k_elems / C_out)
  matmul      : 2 * prod(out_shape) * contracted

(``k_elems`` the weight's element count, which counts grouped and depthwise
convs right); a convolution's backward counts each gradient it computes as
the convolution JAX transposes it into (input: ``2 * prod(grad_in) *
k_elems / C_in``; weight: ``2 * k_elems * prod(grad_out) / C_out``).

The hand-written kernels launch outside the dispatcher, so each wrapper
reports its own work through :func:`record` where it launches, the same
count that its plain version's convolution or products give: the fused
Block and the init conv as a 3^3 VALID convolution, flash attention as its
two products.

Elementwise FLOPs are left out, as in the JAX walker.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

aten = torch.ops.aten

# matrix products: the argument index of the left operand, whose last axis
# is the contracted one
_MATMUL = {aten.mm: 0, aten.bmm: 0, aten.mv: 0, aten.dot: 0,
           aten.addmm: 1, aten.baddbmm: 1, aten.addmv: 1}

_ACTIVE: List["FlopCounter"] = []


def record(kind: str, flops: int, source: str) -> None:
    """Add ``flops`` of ``kind`` (``"conv"`` or ``"dot"``) to every counter
    that is running: a hand-written kernel's work, reported by its wrapper
    (``source``, the kernel's name) where it launches (a no-op when no
    counter runs)."""
    for counter in _ACTIVE:
        counter.add(kind, flops, source)


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


class FlopCounter(TorchDispatchMode):
    """Counts conv and matmul FLOPs of what runs inside the block:
    ``counts["conv"]``, ``counts["dot"]``, and the same FLOPs by where they
    ran, ``by_source`` (an aten operation's name or a kernel's)."""

    def __init__(self):
        super().__init__()
        self.counts: Dict[str, int] = {"conv": 0, "dot": 0}
        self.by_source: Dict[str, int] = {}

    def add(self, kind: str, flops: int, source: str) -> None:
        self.counts[kind] += flops
        self.by_source[source] = self.by_source.get(source, 0) + flops

    def __enter__(self):
        _ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        packet = func.overloadpacket
        name = str(packet)
        if packet in _MATMUL:
            lhs = args[_MATMUL[packet]]
            self.add("dot", 2 * out.numel() * int(lhs.shape[-1]), name)
        elif packet is aten.convolution:
            w, transposed = args[1], args[6]
            cout = w.shape[1] * args[8] if transposed else w.shape[0]
            self.add("conv", 2 * out.numel() * w.numel() // cout, name)
        elif packet is aten.convolution_backward:
            grad_out, x, w = args[0], args[1], args[2]
            transposed, groups = args[7], args[9]
            cin, cout = ((w.shape[0], w.shape[1] * groups) if transposed
                         else (w.shape[1] * groups, w.shape[0]))
            grad_in, grad_w = out[0], out[1]
            if grad_in is not None:
                self.add("conv", 2 * grad_in.numel() * w.numel() // cin, name)
            if grad_w is not None:
                rows, width = (x, cin) if transposed else (grad_out, cout)
                self.add("conv", 2 * w.numel() * rows.numel() // width, name)
        return out


def flop_counts(fn, *args, **kwargs) -> Dict[str, int]:
    """``{"conv": .., "dot": ..}``: the FLOPs of one call of
    ``fn(*args, **kwargs)``, which runs (:class:`FlopCounter` gives them by
    source too)."""
    with FlopCounter() as counter:
        fn(*args, **kwargs)
    return dict(counter.counts)


def matmul_flops(fn, *args, **kwargs) -> float:
    """Total conv + matmul FLOPs of one call of ``fn(*args, **kwargs)``."""
    counts = flop_counts(fn, *args, **kwargs)
    return float(counts["conv"] + counts["dot"])


def conv3d_valid_flops(out_shape, cin: int) -> int:
    """A 3^3 VALID convolution's count (the JAX formula) for a
    channels-last output ``(B, s, s, s, Cout)`` from ``cin`` channels."""
    return 2 * _numel(out_shape) * 27 * cin


def attention_flops(b: int, nq: int, nk: int, d: int) -> int:
    """The two products of softmax attention over ``b`` heads."""
    return 4 * b * nq * nk * d
