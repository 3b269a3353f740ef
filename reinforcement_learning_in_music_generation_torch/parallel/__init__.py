"""Data parallelism across processes (the counterpart of the JAX package's
``parallel``): the mesh, the launch of its ranks and its collectives
(``mesh``), and the parameter layout rules that ZeRO-1 slices by
(``sharding``).  Tensor parallelism and the pipeline wait for ROADMAP Queue 1
item 9(b) and 9(d)."""

from .mesh import Mesh, launch, make_mesh, shard_batch, shard_rows
from .sharding import param_specs, shard_params, spec_for_path, zero1_specs

__all__ = [
    "Mesh", "launch", "make_mesh", "shard_batch", "shard_rows",
    "param_specs", "shard_params", "spec_for_path", "zero1_specs",
]
