"""Attention compute (counterpart of ``diffusioniqt_tpu/ops/attention.py``).

:func:`scaled_dot_product_attention` is the one entry point the attention
modules call. Unlike the JAX dispatch, which takes its Pallas kernel only on
a TPU and only from 4096 kv tokens (a v5e speed threshold, not semantics),
every call with ``use_flash`` goes to the flash-attention wrapper
(``ops/kernels/flash_attention.py``): on a CUDA tensor that launches the
hand-written kernel at any token count, and raises if the kernel cannot take
the inputs; on a CPU tensor it runs :func:`attention_plain`.
"""

from __future__ import annotations

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Plain softmax attention, q ``(B, Nq, D)``, k/v ``(B, Nk, D)``: fp32
    scores times ``scale``, fp32 softmax, probabilities cast to ``v.dtype``,
    then the second product (the JAX ``attention_reference``)."""
    energy = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    att = torch.softmax(energy, dim=-1).to(v.dtype)
    return torch.einsum("bqk,bkd->bqd", att, v)


def scaled_dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, scale: float,
                                 use_flash: bool = True, ops=None) -> torch.Tensor:
    """softmax(q k^T * scale) v over ``(B, N, D)``. ``use_flash`` routes to
    ``ops.attention`` (default :data:`..kernels.KERNELS`, the flash wrapper);
    ``use_flash=False`` runs :func:`attention_plain`."""
    if not use_flash:
        return attention_plain(q, k, v, scale)
    from diffusioniqt_tpu_torch.ops.kernels import KERNELS

    return (ops or KERNELS).attention(q.contiguous(), k.contiguous(),
                                      v.contiguous(), scale)
