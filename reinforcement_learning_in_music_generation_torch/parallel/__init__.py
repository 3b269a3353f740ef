"""Data and tensor parallelism across processes (the counterpart of the JAX
package's ``parallel``): the (dp, tp) mesh, the launch of its ranks and its
collectives (``mesh``), the parameter layout rules, the rank's shards and
ZeRO-1's slices (``sharding``), and the Megatron layer's collectives
(``tensor``).  The pipeline waits for ROADMAP Queue 1 item 9(d)."""

from .mesh import Mesh, launch, make_mesh, shard_batch, shard_rows
from .sharding import gather_params, param_specs, shard_params, spec_for_path, zero1_specs

__all__ = [
    "Mesh", "launch", "make_mesh", "shard_batch", "shard_rows",
    "gather_params", "param_specs", "shard_params", "spec_for_path", "zero1_specs",
]
