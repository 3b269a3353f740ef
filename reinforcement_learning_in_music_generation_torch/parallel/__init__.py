"""Data, tensor, pipeline and sequence parallelism across processes (the
counterpart of the JAX package's ``parallel``): the meshes, the launch of
their ranks and their collectives (``mesh``), the parameter layout rules,
the rank's shards and ZeRO-1's slices (``sharding``), the Megatron layer's
and the sequence-parallel attention's collectives (``tensor``), and the
GPipe pipeline (``pipeline``)."""

from .mesh import Mesh, launch, make_mesh, make_pp_mesh, named_mesh, shard_batch, shard_rows
from .pipeline import (pipeline_forward_hidden, pipeline_grad_step, pipeline_train_losses,
                       pipeline_train_step, shard_params_pp)
from .sharding import gather_params, param_specs, shard_params, spec_for_path, zero1_specs

__all__ = [
    "Mesh", "launch", "make_mesh", "make_pp_mesh", "named_mesh", "shard_batch", "shard_rows",
    "gather_params", "param_specs", "shard_params", "spec_for_path", "zero1_specs",
    "pipeline_forward_hidden", "pipeline_grad_step", "pipeline_train_losses",
    "pipeline_train_step", "shard_params_pp",
]
