"""Data- and tensor-parallel rules and collectives: the port's counterpart
of ``diffusioniqt_tpu/parallel/sharding.py``.

The JAX package annotates shardings and lets XLA place the collectives of
one SPMD program (the reference's Accelerate DDP, trainer.py:296-301,
1123). Each rank here is a process, so the collectives are explicit.

Data parallelism (the ``data`` axis):

  * :func:`broadcast_params` - rank 0's parameters to every rank, once per
    run
  * :func:`all_reduce_mean_` - the gradient mean of one optimizer step
  * :func:`shard_rows` / :func:`all_gather_rows` - this rank's rows of a
    batch, and every rank's rows back in rank order
  * :func:`sharded_sample` - pad a sampling batch by whole groups, sample
    this rank's rows, gather (the JAX trainer's ``_mesh_sample``)
  * :func:`global_extremes` - a batch statistic (min / max) over every
    rank's share, with the one-process gradient

Tensor parallelism (the ``model`` axis), the Megatron column split that the
JAX rule (:func:`param_shardings`) asks of XLA:

  * each rank of a model group holds the ``Cout / M`` output channels of
    every weight the rule shards (:func:`shard_module_`) and computes those
    channels of the layer's output; the group all-gathers them along the
    channel axis (:class:`_GatherFromModel`, whose backward keeps the
    rank's own slice) before anything that mixes channels, so activations
    are whole between layers. The layer's input (and its bias, of which
    each rank adds its slice) goes through :class:`_CopyToModel` (identity
    forward; in the backward the group sums the partial gradients that each
    rank's columns give)
  * every other replicated parameter is computed identically on every rank
    of the group, so its gradient is whole everywhere
  * :func:`gather_state` / :func:`slice_state` turn shards into the
    one-process tensors and back (parameters, Adam moments, EMA)

Imports torch and the standard library only.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from diffusioniqt_tpu_torch.parallel.mesh import axis_rank, axis_size
from diffusioniqt_tpu_torch.parallel.multihost import local_batch_slice

# the JAX rule's least parameter size (parallel/sharding.py:52)
MIN_SIZE = 4096
NO_COLUMN_SPLIT = ("a weight of two or more axes whose layer has no column split: give the "
                   "layer the ColumnParallel forward, or name the parameter in its module's "
                   "replicated_params")


def data_size(mesh: Optional[DeviceMesh]) -> int:
    """Ranks along the ``data`` axis (1 without a mesh)."""
    return axis_size(mesh, "data")


def data_rank(mesh: Optional[DeviceMesh]) -> int:
    """This rank's index along the ``data`` axis (0 without a mesh)."""
    return axis_rank(mesh, "data")


def model_size(mesh: Optional[DeviceMesh]) -> int:
    """Ranks along the ``model`` axis (1 without one)."""
    return axis_size(mesh, "model")


def broadcast_params(module: torch.nn.Module, mesh: DeviceMesh) -> None:
    """Overwrite every rank's parameters and buffers with those of rank 0
    (the whole mesh: the ranks of a model group must hold the same full
    weights before each keeps its slice) and bump their version counters:
    the kernels' packed-weight caches key on them
    (``ops/kernels/conv3d.py``), and a stale pack would give the ranks
    different kernel weights with no error. Each tensor's storage is the
    collective's buffer (one broadcast per tensor, once per run): NCCL
    writes it without bumping the version, and so does every backend
    through ``.data``, so the bump below is what repacks, whichever backend
    ran."""
    del mesh  # a mesh covers the whole process group (mesh.create_mesh)
    tensors = list(module.parameters()) + list(module.buffers())
    for t in tensors:
        dist.broadcast(t.data, 0)
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


def _all_gather_cat(x: torch.Tensor, group, size: int, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` (of one shape) over ``group`` (of ``size``
    ranks), concatenated along ``dim`` in rank order."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_gather_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every data rank's ``x`` (of one shape), concatenated in rank order."""
    return _all_gather_cat(x, mesh.get_group("data"), data_size(mesh))


def pad_rows(x: torch.Tensor, rows: int) -> torch.Tensor:
    """``x`` repeated along its rows and cut to ``rows`` (the JAX
    ``_mesh_sample`` padding; whole groups stay whole when both row counts
    are multiples of the group)."""
    n = x.shape[0]
    return x if rows == n else torch.cat([x] * -(-rows // n))[:rows]


class ModelShard:
    """This rank's place in its model group: the group, its size ``M`` and
    the rank's coordinate ``m`` in it. A layer that holds a column shard
    carries one as ``tp``; a copied module (the EMA copy) shares it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, size, rank

    def __deepcopy__(self, memo):
        return self


class ColumnParallel:
    """Mixin of a layer whose weight the rule may shard along its output
    channels (torch axis :attr:`shard_dim`; the JAX kernel's last axis).
    ``tp`` is None until :func:`shard_module_` keeps the local slice.

    A layer that defines ``local(x, bias)`` (its output channels from the
    weight it holds and the given bias, channels last) gets the forward
    below: that call itself while unsharded, else through
    :func:`column_parallel`. A layer whose weight a kernel reads defines
    its own forward."""

    tp: Optional[ModelShard] = None
    shard_dim = 0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return self.local(x, self.bias)
        return column_parallel(self.tp, x, self.local, self.bias)


class _CopyToModel(torch.autograd.Function):
    """Identity in the forward; in the backward, each tensor's gradient is
    summed over the model group (one fp32 all-reduce of one flat buffer):
    the partial gradients of a replicated input of a column-sharded
    computation."""

    @staticmethod
    def forward(ctx, group, *tensors):
        ctx.group = group
        ctx.meta = [(t.shape, t.dtype) for t in tensors]
        return tuple(t.view_as(t) for t in tensors)

    @staticmethod
    def backward(ctx, *grads):
        grads = [torch.zeros(shape, dtype=dtype, device=next(
                     g.device for g in grads if g is not None)) if g is None else g
                 for g, (shape, dtype) in zip(grads, ctx.meta)]
        flat = torch.cat([g.reshape(-1).float() for g in grads])
        dist.all_reduce(flat, group=ctx.group)
        parts = flat.split([g.numel() for g in grads])
        # copies, not views of ``flat``: a parameter's gradient that viewed
        # it would keep every layer's buffer alive until the next zero_grad
        return (None, *(p.view_as(g).to(g.dtype, copy=True) for p, g in zip(parts, grads)))


class _GatherFromModel(torch.autograd.Function):
    """Every model rank's ``x`` concatenated along ``dim`` in rank order;
    in the backward, the rank's own slice of the gradient."""

    @staticmethod
    def forward(ctx, x, shard, dim):
        ctx.shard, ctx.dim, ctx.width = shard, dim, x.shape[dim]
        return _all_gather_cat(x, shard.group, shard.size, dim)

    @staticmethod
    def backward(ctx, grad):
        n = ctx.width
        return grad.narrow(ctx.dim, ctx.shard.rank * n, n), None, None


def copy_to_model(shard: ModelShard, *tensors: torch.Tensor) -> tuple:
    """``tensors`` as they are, their gradients summed over the model group
    in the backward (one all-reduce for all of them)."""
    return _CopyToModel.apply(shard.group, *tensors)


def gather_from_model(x: torch.Tensor, shard: ModelShard, dim: int = -1) -> torch.Tensor:
    """The model group's column shards of an output, whole along ``dim``."""
    return _GatherFromModel.apply(x, shard, dim % x.dim())


def column_parallel(shard: ModelShard, x: torch.Tensor, fn: Callable,
                    bias: Optional[torch.Tensor]) -> torch.Tensor:
    """A column-sharded layer's output, whole (channels last): ``fn(x,
    bias)`` computes this rank's output channels from its weight shard and
    its slice of the replicated ``bias``, in the one call that computes
    them in one process (so each channel rounds as it does there), and the
    group gathers them. The bias enters with the input through
    :func:`copy_to_model`: its slices' gradients are summed whole on every
    rank."""
    if bias is None:
        (x,) = copy_to_model(shard, x)
        return gather_from_model(fn(x, None), shard)
    x, bias = copy_to_model(shard, x, bias)
    n = bias.shape[0] // shard.size
    return gather_from_model(fn(x, bias.narrow(0, shard.rank * n, n)), shard)


def _leaf_sharded(shape, width: int, model: int, min_size: int) -> bool:
    """The JAX ``_leaf_spec`` rule on a leaf's JAX shape: ndim >= 2, size
    >= ``min_size``, output width (the last JAX axis) divisible by the
    model size."""
    return len(shape) >= 2 and torch.Size(shape).numel() >= min_size and width % model == 0


def param_shardings(module: torch.nn.Module, mesh, min_size: int = MIN_SIZE) -> Dict[str, tuple]:
    """The placement of each parameter along each mesh axis (the JAX
    ``param_shardings``): ``Shard(d)`` on the ``model`` axis for a weight
    that the JAX rule shards, torch axis ``d`` being the JAX kernel's last
    (output-channel) axis: 0 for a conv ``(Cout, Cin, k..)`` or a dense
    ``(out, in)`` weight (flax ``(k.., Cin, Cout)`` / ``(in, out)``), 1 for
    the transposed conv's ``(Cin, Cout, k..)``. Everything else is
    ``Replicate()``: 1-D leaves, small kernels, widths that do not divide,
    every leaf on a mesh without a model axis of more than one rank, and
    the leaves that a module names in its ``replicated_params``: the JAX
    rule shards them from its least size on, but they are not a layer's
    weight (the ViT3D ``positions``, ``models/attention.py``; the video
    U-Net's learned tokens and null embeddings, ``models/unet_video.py``).

    Every U-Net family's layers are column-parallel. A parameter of two or
    more axes that is neither a :class:`ColumnParallel` layer's weight nor
    named in ``replicated_params`` raises ``NotImplementedError``: its
    forward has no column split, and replicating it silently would not be
    the JAX placement."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names or ())
    model = axis_size(mesh, "model")
    out = {}
    for prefix, owner in module.named_modules():
        for leaf, p in owner.named_parameters(recurse=False):
            name = f"{prefix}.{leaf}" if prefix else leaf
            spec = [Replicate()] * len(names)
            if model > 1 and p.dim() >= 2 and leaf not in getattr(owner, "replicated_params", ()):
                if not isinstance(owner, ColumnParallel):
                    raise NotImplementedError(f"{name} ({type(owner).__name__}): "
                                              f"{NO_COLUMN_SPLIT}")
                if leaf == "weight" and _leaf_sharded(p.shape, p.shape[owner.shard_dim],
                                                      model, min_size):
                    spec[names.index("model")] = Shard(owner.shard_dim)
            out[name] = tuple(spec)
    return out


def shard_module_(module: torch.nn.Module, mesh) -> Dict[str, int]:
    """Keep, in place, this rank's column slice of every parameter that
    :func:`param_shardings` shards (call it after :func:`broadcast_params`,
    on the full weights), and give its layer the model group (``tp``).
    Returns ``{name: torch axis}`` of the sharded parameters."""
    return keep_shards_(module, mesh, param_shardings(module, mesh))


def keep_shards_(module: torch.nn.Module, mesh, specs: Dict[str, tuple]) -> Dict[str, int]:
    """:func:`shard_module_` for the placements ``specs`` (``{name: spec}``
    as :func:`param_shardings` gives them). The parameter objects stay (an
    optimizer or an EMA copy made afterwards holds the shards); their
    version counters are bumped, and the packed weight caches key on the
    shape too, so no kernel reads a pack of the full weight."""
    model = axis_size(mesh, "model")
    if model == 1:
        return {}
    shard = ModelShard(mesh.get_group("model"), model, axis_rank(mesh, "model"))
    dims, params = {}, []
    for name, spec in specs.items():
        dim = next((s.dim for s in spec if hasattr(s, "dim")), None)
        if dim is None:
            continue
        prefix, _, leaf = name.rpartition(".")
        owner = module.get_submodule(prefix)
        p = getattr(owner, leaf)
        n = p.shape[dim] // model
        p.data = p.detach().narrow(dim, shard.rank * n, n).clone()
        owner.tp = shard
        dims[name] = dim
        params.append(p)
    torch.autograd.graph.increment_version(params)
    return dims


def gather_state(state: Dict[str, torch.Tensor], dims: Dict[str, int],
                 mesh) -> Dict[str, torch.Tensor]:
    """``state`` with each entry named in ``dims`` gathered whole from the
    model group's shards along its axis (every rank of the group calls it,
    with the same names); the other entries as they are."""
    out = dict(state)
    if dims:
        group, size = mesh.get_group("model"), model_size(mesh)
        for name in sorted(dims):
            out[name] = _all_gather_cat(state[name], group, size, dims[name])
    return out


def slice_state(state: Dict[str, torch.Tensor], dims: Dict[str, int],
                mesh) -> Dict[str, torch.Tensor]:
    """``state`` with each entry named in ``dims`` cut to this rank's column
    slice (the inverse of :func:`gather_state`; no collective)."""
    model, rank = axis_size(mesh, "model"), axis_rank(mesh, "model")
    out = dict(state)
    for name, dim in dims.items():
        if name in state:
            n = state[name].shape[dim] // model
            out[name] = state[name].narrow(dim, rank * n, n).clone()
    return out


def sync_default_generators_(mesh, device: torch.device) -> None:
    """Give every rank of a model group the default generators' state of
    its model rank 0 (CPU, and the card's where ``device`` is one): dropout
    draws from them, and the ranks of a group compute the same activations,
    so they must draw the same masks (the JAX program's one dropout key)."""
    if model_size(mesh) == 1:
        return
    group = mesh.get_group("model")
    src = dist.get_global_rank(group, 0)
    on = device if dist.get_backend() == "nccl" else torch.device("cpu")
    gens = [torch.default_generator]
    if device.type == "cuda":
        gens.append(torch.cuda.default_generators[device.index or 0])
    for gen in gens:
        state = gen.get_state().to(on)
        dist.broadcast(state, src, group=group)
        gen.set_state(state.cpu())


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
