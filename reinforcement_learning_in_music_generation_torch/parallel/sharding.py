"""Parameter layout rules (the counterpart of the JAX package's
``parallel/sharding.py`` and of ``pp_param_shardings`` / ``shard_params_pp``
in its ``parallel/pipeline.py``).

The Megatron rules map a parameter's key path to the mesh axis each of its
dimensions splits over: column-parallel qkv, FFN-in, embeddings and input
projection, row-parallel attention output, FFN-out and heads; norms and
small leaves whole; stacked layer leaves keep their leading layer axis whole.
A spec is a tuple of axis names or None, one a dimension (``()``: whole), as
JAX's ``PartitionSpec`` entries, and is computed from the axis sizes alone, so
it needs no process group.

Each rank holds its tp shard of every leaf whose spec splits a dimension
over "tp" (``shard_params``: rank 0's tree, then the rank's slice at its tp
index), and the other leaves whole.  On a pipeline mesh (an axis "pp",
``parallel/mesh.py make_pp_mesh``) every ``['layers']`` leaf keeps its
stage's contiguous L/pp slab of the leading layer axis, then its tp slice;
the embeddings, ``in_linear``, ``final_ln`` and the heads stay whole over
pp, with their tp slices (JAX ``pp_param_shardings``).  ``gather_params``
puts a tree of shards back whole (checkpoints, tests).  The rules also
serve ZeRO-1's slices (``zero1_specs``, ``train/optim.py zero1``): the "dp"
axis they add is never a tp-split dimension, so a shard has its full
length there.
"""

from __future__ import annotations

import re
from typing import Any, Mapping, Tuple

import torch

from .mesh import Mesh, all_gather, broadcast_

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


def tp_axis(spec: Spec):
    """The dimension a spec splits over "tp", or None."""
    return spec.index("tp") if "tp" in spec else None


def is_pp_slab(path: str) -> bool:
    """A leaf a pipeline mesh slices over "pp" on its leading (layer) axis."""
    return "['layers']" in path


def layouts(mesh: Mesh, tree: Any) -> list:
    """Each leaf's (tp dimension or None, slabbed over pp), in leaf order:
    what the rank holds of it on ``mesh``."""
    out = []

    def one(path, leaf):
        tp_dim = tp_axis(spec_for_path(path, leaf.ndim)) if mesh.tp > 1 else None
        out.append((tp_dim, mesh.pp > 1 and is_pp_slab(path)))
    _with_paths(one, tree)
    return out


def shard_tree(mesh: Mesh, tree: Any) -> Any:
    """This rank's shard of each leaf of a whole tree (no collective): its
    stage's slab of the layers on a pipeline mesh, then its tp slice; the
    tree itself where tp and pp are 1."""
    if mesh.tp == 1 and mesh.pp == 1:
        return tree

    def cut(path, leaf):
        if mesh.pp > 1 and is_pp_slab(path):
            k = leaf.shape[0] // mesh.pp
            leaf = leaf.narrow(0, mesh.pp_index * k, k).contiguous()
        axis = tp_axis(spec_for_path(path, leaf.ndim)) if mesh.tp > 1 else None
        if axis is None:
            return leaf
        k = leaf.shape[axis] // mesh.tp
        return leaf.narrow(axis, mesh.tp_index * k, k).contiguous()
    return _with_paths(cut, tree)


@torch.no_grad()
def shard_params(mesh: Mesh, params: Any) -> Any:
    """Rank 0's parameters on every rank (a broadcast, in place), then this
    rank's shard of each leaf (``shard_tree``: its slab of the layers on a
    pipeline mesh, its tp slice of the leaves the Megatron rules split);
    returns the rank's tree (``params`` itself where tp and pp are 1)."""
    leaves = []
    _with_paths(lambda path, leaf: leaves.append(leaf), params)
    broadcast_(mesh, leaves, src=0, axis="world")
    return shard_tree(mesh, params)


def _gather(mesh: Mesh, leaves: list, dims: list, axis: str) -> list:
    """``leaves`` with each leaf whose entry of ``dims`` is a dimension put
    back whole along it from the ranks of ``axis``: one all-gather a dtype of
    those leaves flattened together (bf16 widened to f32 over gloo)."""
    whole = list(leaves)
    by_dtype: dict = {}
    for i, a in enumerate(dims):
        if a is not None:
            by_dtype.setdefault(leaves[i].dtype, []).append(i)
    for dtype, idx in by_dtype.items():
        wide = dtype == torch.bfloat16 and mesh.backend == "gloo"
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        parts = all_gather(mesh, flat.float() if wide else flat, axis=axis)
        off = 0
        for i in idx:
            n = leaves[i].numel()
            whole[i] = torch.cat([p[off:off + n].view_as(leaves[i]).to(dtype) for p in parts],
                                 dims[i])
            off += n
    return whole


@torch.no_grad()
def gather_params(mesh: Mesh, tree: Any) -> Any:
    """A tree of this rank's shards (parameters, gradients, moments) put
    back whole on every rank: one all-gather over the tp group of the split
    leaves, then on a pipeline mesh one over the pp group of the layer
    slabs, each flattened together a dtype.  Every rank calls it."""
    if mesh.tp == 1 and mesh.pp == 1:
        return tree
    leaves = []
    _with_paths(lambda path, leaf: leaves.append(leaf), tree)
    lay = layouts(mesh, tree)
    if mesh.tp > 1:
        leaves = _gather(mesh, leaves, [t for t, _ in lay], "tp")
    if mesh.pp > 1:
        leaves = _gather(mesh, leaves, [0 if pp else None for _, pp in lay], "pp")
    it = iter(leaves)
    return _with_paths(lambda path, leaf: next(it), tree)
