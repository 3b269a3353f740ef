"""Parameter layout rules (the counterpart of the JAX package's
``parallel/sharding.py``).

The Megatron rules map a parameter's key path to the mesh axis each of its
dimensions splits over: column-parallel qkv, FFN-in, embeddings and input
projection, row-parallel attention output, FFN-out and heads; norms and
small leaves whole; stacked layer leaves keep their leading layer axis whole.
A spec is a tuple of axis names or None, one a dimension (``()``: whole), as
JAX's ``PartitionSpec`` entries, and is computed from the axis sizes alone, so
it needs no process group.

The port runs dp only: the parameters are whole on every rank
(``shard_params`` makes them equal), and the rules serve ZeRO-1's slices
(``zero1_specs``, ``train/optim.py zero1``).  Splitting the weights over
``tp`` waits for ROADMAP Queue 1 item 9(b).
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Tuple

import torch

from .mesh import Mesh, broadcast_

Spec = Tuple[Any, ...]

# (regex over the key path, spec given the leaf's ndim)
_RULES = [
    # field embeddings: (V, E) -> the embedding dim
    (r"\['emb'\]", lambda nd: (None, "tp")),
    # input projection (concat -> d_model): column parallel
    (r"\['in_linear'\]\['w'\]", lambda nd: (None, "tp")),
    (r"\['in_linear'\]\['b'\]", lambda nd: ("tp",)),
    (r"\['proj'\]\['w'\]", lambda nd: (None, "tp")),
    (r"\['proj'\]\['b'\]", lambda nd: ("tp",)),
    # stacked layers (leading L axis)
    (r"\['layers'\]\['w[qkv]'\]\['w'\]", lambda nd: (None, None, "tp")),
    (r"\['layers'\]\['w[qkv]'\]\['b'\]", lambda nd: (None, "tp")),
    (r"\['layers'\]\['wo'\]\['w'\]", lambda nd: (None, "tp", None)),
    (r"\['layers'\]\['ffn1'\]\['w'\]", lambda nd: (None, None, "tp")),
    (r"\['layers'\]\['ffn1'\]\['b'\]", lambda nd: (None, "tp")),
    (r"\['layers'\]\['ffn2'\]\['w'\]", lambda nd: (None, "tp", None)),
    # output heads: row parallel over d_model (vocab sizes such as 135 do
    # not divide by tp)
    (r"\['heads'\]\[.*\]\['w'\]", lambda nd: ("tp", None)),
]


def spec_for_path(path_str: str, ndim: int) -> Spec:
    """The spec of the leaf at ``path_str`` (JAX ``keystr`` form,
    ``['layers']['wq']['w']``): the first rule that matches and fits."""
    for pattern, builder in _RULES:
        if re.search(pattern, path_str):
            spec = builder(ndim)
            if len(spec) <= ndim:
                return spec
    return ()


def _with_paths(fn, tree, prefix: str = ""):
    if isinstance(tree, dict):
        return {k: _with_paths(fn, v, f"{prefix}[{k!r}]") for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params: Any) -> Any:
    """A tree of specs mirroring ``params``."""
    return _with_paths(lambda path, leaf: spec_for_path(path, leaf.ndim), params)


def _axis_sizes(mesh) -> Mapping[str, int]:
    return mesh.shape if isinstance(mesh, Mesh) else mesh


def zero1_specs(mesh, params: Any) -> Any:
    """ZeRO-1's specs (``mesh``: a ``Mesh`` or its axis sizes, {"dp": ..,
    "tp": ..}): each leaf's Megatron spec plus "dp" on its largest dimension
    that is still whole and that dp divides, so Adam's moments are sliced
    over the ranks while the parameters stay whole on each.  A leaf with no
    such dimension keeps its Megatron spec (whole over dp)."""
    dp = _axis_sizes(mesh).get("dp", 1)

    def leaf_spec(path, leaf):
        entries = list(spec_for_path(path, leaf.ndim))
        entries += [None] * (leaf.ndim - len(entries))
        if dp > 1:
            free = [i for i in range(leaf.ndim)
                    if entries[i] is None and leaf.shape[i] % dp == 0 and leaf.shape[i] >= dp]
            if free:
                entries[max(free, key=lambda i: leaf.shape[i])] = "dp"
        return tuple(entries)
    return _with_paths(leaf_spec, params)


def dp_axis(spec: Spec):
    """The dimension a spec slices over "dp", or None."""
    return spec.index("dp") if "dp" in spec else None


@torch.no_grad()
def shard_params(mesh: Mesh, params: Any) -> Any:
    """Every rank's parameters set to rank 0's, in place (dp keeps them
    whole on each rank); returns ``params``."""
    leaves = []
    _with_paths(lambda path, leaf: leaves.append(leaf), params)
    broadcast_(mesh, leaves, src=0)
    return params
