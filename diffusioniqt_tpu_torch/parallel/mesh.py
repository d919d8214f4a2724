"""Device mesh construction: the port's counterpart of
``diffusioniqt_tpu/parallel/mesh.py``.

PyTorch's counterpart of ``jax.sharding.Mesh`` is a ``DeviceMesh`` with
named dimensions over the ranks of the process group
(:func:`diffusioniqt_tpu_torch.parallel.multihost.initialize_multihost`).
The JAX mesh is one SPMD program over the devices; here each rank is a
process, and the trainer and the model layers issue the collectives
themselves (``parallel/sharding.py``).

A mesh is ``("data",)`` or ``("data", "model")``: the ``model`` axis, when
there is one, is the innermost, so that the ranks of one model group are
consecutive (rank ``d * M + m`` is data coordinate ``d``, model coordinate
``m``), as ``mesh_utils.create_device_mesh`` lays the JAX DP x TP mesh out.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = (("data",), ("data", "model"))


def create_mesh(axis_names: Sequence[str] = ("data",),
                axis_sizes: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A mesh over every rank of the process group.

    Default: a 1-D ``data`` mesh over all ranks. ``("data", "model")``
    with sizes ``(D, M)`` is the DP x TP mesh: ``M`` ranks hold the column
    shards of each parameter that ``sharding.param_shardings`` shards, and
    ``D`` replicas of that group split the batch. The sizes must cover the
    world. The mesh's device type is ``cuda`` under NCCL and ``cpu`` under
    gloo (gloo ranks that share a card keep their tensors there; the
    collectives take them as they are)."""
    axis_names = tuple(axis_names)
    if axis_names not in AXES:
        raise ValueError(f"mesh axes {axis_names}: expected one of {AXES}")
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
    return init_device_mesh(device_type, axis_sizes, mesh_dim_names=axis_names)


def axis_size(mesh: Optional[DeviceMesh], name: str) -> int:
    """Ranks along axis ``name`` (1 without a mesh or without that axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 1
    return mesh[name].size()


def axis_rank(mesh: Optional[DeviceMesh], name: str) -> int:
    """This rank's coordinate along axis ``name`` (0 without a mesh or
    without that axis)."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return 0
    return mesh.get_local_rank(name)
