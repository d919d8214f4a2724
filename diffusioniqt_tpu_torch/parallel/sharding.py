"""Data-parallel rules and collectives: the port's counterpart of
``diffusioniqt_tpu/parallel/sharding.py``.

The JAX package annotates shardings and lets XLA place the collectives of
one SPMD program (the reference's Accelerate DDP, trainer.py:296-301,
1123). Each rank here is a process, so the collectives are explicit:

  * :func:`broadcast_params` - rank 0's parameters to every rank (the
    replicated placement of a pure-DP mesh), once per run
  * :func:`all_reduce_mean_` - the gradient mean of one optimizer step
  * :func:`shard_rows` / :func:`all_gather_rows` - this rank's rows of a
    batch, and every rank's rows back in rank order
  * :func:`sharded_sample` - pad a sampling batch by whole groups, sample
    this rank's rows, gather (the JAX trainer's ``_mesh_sample``)
  * :func:`global_extremes` - a batch statistic (min / max) over every
    rank's share, with the one-process gradient

Tensor parallelism (a ``model`` axis larger than 1) is not ported and
raises. Imports torch and the standard library only.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from diffusioniqt_tpu_torch.parallel.mesh import refuse_model_axis
from diffusioniqt_tpu_torch.parallel.multihost import local_batch_slice


def data_size(mesh: Optional[DeviceMesh]) -> int:
    """Ranks along the ``data`` axis (1 without a mesh)."""
    return 1 if mesh is None else mesh["data"].size()


def data_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's index along the ``data`` axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank("data")


def broadcast_params(module: torch.nn.Module, mesh: DeviceMesh) -> None:
    """Overwrite every rank's parameters and buffers with those of data rank
    0 and bump their version counters: the kernels' packed-weight caches
    key on them (``ops/kernels/conv3d.py``), and a stale pack would give
    the ranks different kernel weights with no error. Each tensor's storage
    is the collective's buffer (one broadcast per tensor, once per run):
    NCCL writes it without bumping the version, and so does every backend
    through ``.data``, so the bump below is what repacks, whichever backend
    ran."""
    tensors = list(module.parameters()) + list(module.buffers())
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)
    for t in tensors:
        dist.broadcast(t.data, src, group=group)
    torch.autograd.graph.increment_version(tensors)


def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: DeviceMesh) -> None:
    """Every tensor (all of one dtype, on one device) replaced by its mean
    over the data ranks, in one all-reduce of one flat buffer. Every rank
    gets the same bits."""
    tensors = list(tensors)
    with torch.no_grad():
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=mesh.get_group("data"))
        flat.div_(data_size(mesh))
        views = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [v.view_as(t) for v, t in zip(views, tensors)])


def shard_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous share of ``x``'s rows (the JAX
    ``batch_sharding``); raises unless the rows divide evenly."""
    return x[local_batch_slice(x.shape[0], data_size(mesh), data_rank(mesh))]


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every data rank's ``x`` (of one shape), concatenated in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(data_size(mesh))]
    dist.all_gather(parts, x, group=mesh.get_group("data"))
    return torch.cat(parts)


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` repeated along its rows and cut to ``rows`` (the JAX
    ``_mesh_sample`` padding; whole groups stay whole when both row counts
    are multiples of the group)."""
    n = x.shape[0]
    return x if rows == n else torch.cat([x] * -(-rows // n))[:rows]


def param_shardings(module: torch.nn.Module, mesh: DeviceMesh) -> Dict[str, tuple]:
    """The placement of each parameter (the JAX ``param_shardings``): on a
    pure data-parallel mesh every parameter is replicated. A ``model`` axis
    larger than 1 raises ``NotImplementedError``."""
    from torch.distributed.tensor import Replicate

    names = mesh.mesh_dim_names or ()
    refuse_model_axis(names, [mesh[name].size() for name in names])
    return {name: (Replicate(),) * mesh.ndim for name, _ in module.named_parameters()}


def map_batch_tensors(kwargs: dict, fn: Callable) -> dict:
    """``fn`` over every batch-major tensor of sampling keyword arguments:
    each tensor value, and each tensor in a list or tuple value (the
    per-unet ``init_images``); None and other values are kept (the JAX
    trainer's ``_map_array_kwargs``)."""
    def one(v):
        if isinstance(v, torch.Tensor):
            return fn(v)
        if isinstance(v, (list, tuple)):
            return type(v)(one(u) for u in v)
        return v
    return {k: one(v) for k, v in kwargs.items()}


def map_sample_outputs(out, kwargs: dict, batch_fn: Callable, step_fn: Callable):
    """``batch_fn`` over the batch-major outputs of ``sample(**kwargs)`` and
    ``step_fn`` over its step-major ``(T, B, ...)`` trajectories, as the
    ``return_all_outputs`` / ``return_trajectory`` flags shape them (the
    JAX trainer's ``_map_sample_outputs``)."""
    def head(h):
        return ([batch_fn(o) for o in h] if kwargs.get("return_all_outputs", False)
                else batch_fn(h))
    if kwargs.get("return_trajectory", False):
        return (head(out[0]), *(step_fn(t) for t in out[1:]))
    return head(out)


def sharded_sample(sample: Callable, mesh: Optional[DeviceMesh], *, batch_size: int,
                   noise: Callable, group: int = 1, **kwargs):
    """``sample(batch_size=..., noise=..., **kwargs)`` with its batch spread
    over the data ranks (the JAX trainer's ``_mesh_sample``); without a
    mesh, the call itself.

    The batch (``batch_size`` rows, whole groups of ``group``) is padded by
    repetition to a multiple of ``group`` times the ranks, so that every
    rank samples whole groups; every tensor argument is padded and cut the
    same way. Each rank's ``noise`` draws the shape the one-process sampler
    draws (``batch_size`` rows) and keeps its rows of the padded batch, so
    every rank consumes its generator as the one-process sampler does and
    the result equals the one-process result. The outputs are gathered to
    every rank in order (trajectories along their batch axis) and the
    padding cut off."""
    if mesh is None:
        return sample(batch_size=batch_size, noise=noise, **kwargs)
    if batch_size % group:
        raise ValueError(f"a sampling batch of {batch_size} rows is not whole groups of {group}")
    n = data_size(mesh)
    padded = -(-batch_size // (group * n)) * group * n
    rows = local_batch_slice(padded, n, data_rank(mesh))
    per = rows.stop - rows.start
    kwargs = map_batch_tensors(kwargs, lambda v: pad_rows(v, padded)[rows])

    def local_noise(shape):
        if shape[0] != per:
            raise ValueError(f"noise of {shape[0]} rows asked for by a {per}-row shard")
        return pad_rows(noise((batch_size,) + tuple(shape[1:])), padded)[rows]

    out = sample(batch_size=per, noise=local_noise, **kwargs)
    return map_sample_outputs(
        out, kwargs, lambda o: all_gather_rows(o, mesh)[:batch_size],
        lambda t: all_gather_rows(t.transpose(0, 1), mesh)[:batch_size].transpose(0, 1))


class _SumGradOverRanks(torch.autograd.Function):
    """``value`` (a detached function of every rank's ``local``) in the
    forward; in the backward, ``local``'s gradient is the incoming one summed
    over the ranks, times ``share``."""

    @staticmethod
    def forward(ctx, local, value, share, group):
        ctx.save_for_backward(share)
        ctx.group = group
        return value.clone().to(local.dtype)

    @staticmethod
    def backward(ctx, grad):
        (share,) = ctx.saved_tensors
        grad_sum = grad.float().contiguous()
        dist.all_reduce(grad_sum, group=ctx.group)
        return (grad_sum * share).to(grad.dtype), None, None, None


def global_extremes(stacks: Sequence[torch.Tensor], group) -> tuple:
    """``(lo, hi)``: the min and the max of each tensor of ``stacks`` over
    every rank of ``group``, where each rank holds its own share of the
    same stacks; each of shape ``(len(stacks),)``.

    The values are those of the one-process ``s.min()`` / ``s.max()`` of
    the whole stack, and so is the gradient once the ranks' gradients are
    averaged (as the mesh trainer averages them): the one-process gradient of an
    extreme goes, split evenly, to the elements that attain it, wherever
    they lie; here each extreme's gradient is summed over the ranks and
    each rank passes its local extreme the part of it that its own tied
    elements take (their count over the count on every rank), which its
    local ``min`` / ``max`` splits evenly among them. Two small collectives
    in the forward, one in the backward; every rank of ``group`` calls it."""
    n = len(stacks)
    local = torch.cat([torch.stack([s.min() for s in stacks]),
                       torch.stack([s.max() for s in stacks])])
    with torch.no_grad():
        value = torch.cat([-local[:n], local[n:]]).float()
        dist.all_reduce(value, op=dist.ReduceOp.MAX, group=group)
        value[:n] = -value[:n]
        ties = torch.stack([(s == v).sum() for s, v in zip(list(stacks) * 2, value)]).float()
        total = ties.clone()
        dist.all_reduce(total, group=group)
        share = ties / total
    out = _SumGradOverRanks.apply(local, value, share, group)
    return out[:n], out[n:]
