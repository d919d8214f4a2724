"""Device mesh construction: the port's counterpart of
``diffusioniqt_tpu/parallel/mesh.py``.

PyTorch's counterpart of ``jax.sharding.Mesh`` is a ``DeviceMesh`` with
named dimensions over the ranks of the process group
(:func:`diffusioniqt_tpu_torch.parallel.multihost.initialize_multihost`).
The JAX mesh is one SPMD program over the devices; here each rank is a
process, and the trainer issues the collectives itself
(``parallel/sharding.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

TP_NOT_PORTED = ("tensor parallelism (a 'model' mesh axis larger than 1) is not ported "
                 "yet: ROADMAP.md section 1, the first of the modules still to port")


def refuse_model_axis(axis_names: Sequence[str], axis_sizes: Sequence[int]) -> None:
    """Raise ``NotImplementedError`` for a ``model`` axis larger than 1."""
    if dict(zip(axis_names, axis_sizes)).get("model", 1) > 1:
        raise NotImplementedError(TP_NOT_PORTED)


def create_mesh(axis_names: Sequence[str] = ("data",),
                axis_sizes: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over every rank of the process group.

    Default: a 1-D ``data`` mesh over all ranks. The sizes must cover the
    world. A ``model`` axis larger than 1 (the JAX package's DP x TP mesh)
    raises ``NotImplementedError``. The mesh's device type is ``cuda``
    under NCCL and ``cpu`` under gloo (gloo ranks that share a card keep
    their tensors there; the collectives take them as they are)."""
    if axis_sizes is not None:
        refuse_model_axis(axis_names, axis_sizes)
    if not dist.is_initialized():
        raise RuntimeError("a mesh spans the ranks of a process group: call "
                           "parallel.multihost.initialize_multihost first")
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = [1] * len(axis_names)
        axis_sizes[0] = n
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_names)} axis names for {len(axis_sizes)} sizes")
    if math.prod(axis_sizes) != n:
        raise ValueError(f"mesh {axis_sizes} does not cover {n} ranks")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, axis_sizes, mesh_dim_names=tuple(axis_names))
