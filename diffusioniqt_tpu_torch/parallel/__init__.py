"""Data and tensor parallelism over ``torch.distributed``: the port's
counterpart of ``diffusioniqt_tpu/parallel``."""

from diffusioniqt_tpu_torch.parallel.mesh import create_mesh  # noqa: F401
from diffusioniqt_tpu_torch.parallel.sharding import (  # noqa: F401
    broadcast_params,
    param_shardings,
    shard_module_,
    shard_rows,
)
