"""Kernel 4: flash attention forward (``csrc/flash_attention.cu``).

Replaces ``diffusioniqt_tpu/ops/pallas/flash_attention.py::flash_attention``:
``softmax(q k^T * scale) v`` over q ``(B, Nq, D)`` and k, v ``(B, Nk, D)``
with B = batch * heads, computed tile by tile with an online softmax so the
``(Nq, Nk)`` scores never reach device memory.

Bound on the H100: operations (``4 * B * Nq * Nk * D`` FLOP against reading
q, k, v and writing the output once; about 860 FLOP per byte at the main
path's (64, 1728, 64)), with ``B * Nq * Nk`` exponentials on the side. The
kernel is FlashAttention-3 shaped: one CTA per (b, query tile of 192 rows,
128 at D = 128), a producer warpgroup that issues TMA loads of Q and of
128-row K/V tiles into a 3-stage mbarrier ring (3-D tensor maps, so rows
past N are zeros), and consumer warpgroups of 64 query rows that run
``wgmma`` (S = Q K^T from shared memory, O += P V with P from registers)
and overlap each tile's softmax with the previous tile's P V product. The
tensor maps are encoded on the host with the CUDA driver's
``cuTensorMapEncodeTiled`` (:func:`runtime.driver_function`).

The kernel rounds the unnormalised probabilities to bf16 before the P V
product (as the Pallas kernel does); :func:`attention_reference` rounds the
normalised ones, so the two differ by bf16 rounding at different points.
The backward is the plain version through autograd, as the Pallas kernel's
``custom_vjp`` recomputes with the jnp reference.
"""

from __future__ import annotations

import ctypes

import torch

from diffusioniqt_tpu_torch.ops.attention import attention_reference
from diffusioniqt_tpu_torch.ops.kernels import runtime
from diffusioniqt_tpu_torch.utils import flops, profiling

HEAD_DIMS = (32, 64, 128)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_void_p]


def check_flash_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Shapes, dtype, device, contiguity and alignment the kernel takes."""
    name = "flash_attention"
    for t in (q, k, v):
        runtime.require(t.dtype == torch.bfloat16, name,
                        f"inputs must be bfloat16, got {t.dtype}")
        runtime.require(t.dim() == 3, name,
                        f"expected (B, N, D) inputs, got {tuple(t.shape)}")
        runtime.require(t.device == q.device, name, "inputs on different devices")
        runtime.require(t.is_contiguous(), name, "inputs must be contiguous")
        runtime.require(t.data_ptr() % 16 == 0, name, "input not 16-byte aligned")
    b, nq, d = q.shape
    runtime.require(d in HEAD_DIMS, name, f"head dim {d} is not one of {HEAD_DIMS}")
    runtime.require(k.shape == v.shape and k.shape[0] == b and k.shape[2] == d,
                    name, f"k {tuple(k.shape)} / v {tuple(v.shape)} do not match "
                    f"q {tuple(q.shape)}")
    runtime.require(nq > 0 and k.shape[1] > 0 and b > 0, name, "empty input")


def _launch(q, k, v, scale: float) -> torch.Tensor:
    name = "flash_attention"
    b, nq, d = q.shape
    out = torch.empty_like(q)
    fn = runtime.c_function(name, "flash_attention_launch", _ARGTYPES)
    err = fn(runtime.driver_function("cuTensorMapEncodeTiled"), q.data_ptr(),
             k.data_ptr(), v.data_ptr(), out.data_ptr(), b, nq, k.shape[1], d,
             float(scale), runtime.stream_handle(q.device))
    runtime.check_launch(name, err)
    profiling.launched("flash_attention")
    flops.record("dot", flops.attention_flops(b, nq, k.shape[1], d), "flash_attention")
    return out


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.scale = scale
        ctx.save_for_backward(q, k, v)
        return _launch(q, k, v, scale)

    @staticmethod
    def backward(ctx, grad):
        grads = runtime.plain_vjp(attention_reference, list(ctx.saved_tensors),
                                  ctx.needs_input_grad[:3], grad, ctx.scale)
        return (*grads, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Attention: the CUDA kernel for a CUDA tensor (bf16, D in
    :data:`HEAD_DIMS`), :func:`attention_reference` for a CPU tensor."""
    if q.device.type == "cpu":
        return attention_reference(q, k, v, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention kernel: unsupported device {q.device}")
    start = profiling.launch_clock()
    check_flash_args(q, k, v)
    # the kernel takes the max of the raw scores (every caller's scale is
    # dim_head ** -0.5)
    runtime.require(scale > 0, "flash_attention", f"scale must be positive, got {scale}")
    out = _FlashAttention.apply(q, k, v, scale)
    profiling.launch_timed("flash_attention", start)
    return out
