"""Weights crossing between the JAX package and this port.

The port keeps the JAX parameter tree as it is: nested dicts with the same
key paths, linear weights ``w`` stored (in, out), per-layer leaves stacked
(L, ...).  So a tree converts leaf by leaf, and the JAX pickle checkpoints
(``utils/checkpoint.py save_checkpoint``: a dict whose ``params`` entry is
a tree of numpy arrays) load without JAX.
"""

from __future__ import annotations

import pickle
from typing import Any, Optional

import numpy as np
import torch


def from_jax_params(tree: Any, device="cuda") -> Any:
    """Tree of numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``)
    -> the same tree of torch tensors on ``device``.  Exact: no dtype or
    value changes (bfloat16 arrays, which numpy stores via ml_dtypes, are
    re-read bit for bit)."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16).astype(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))          # a writable copy
    return t.to(device)


def to_numpy(tree: Any) -> Any:
    """Tree of torch tensors -> the same tree of numpy arrays (float32 for
    bfloat16 leaves, which numpy has no native type for)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def _flat(tree: Any, prefix: str = "") -> dict:
    """{"['layers']['wq']['w']": leaf, ...}: the JAX ``keystr`` key paths."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}[{k!r}]"))
        return out
    return {prefix: tree}


class _Opaque:
    """Stand-in for a class the params reader does not need (the optax
    optimizer state saved beside the params)."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _ParamsUnpickler(pickle.Unpickler):
    """Reads numpy arrays and plain containers; every other class (optax
    state, anything foreign) becomes an inert ``_Opaque`` so that reading a
    checkpoint imports no JAX and runs no foreign constructor."""

    _ALLOWED = ("numpy", "ml_dtypes", "builtins", "collections", "copyreg",
                "_codecs")

    def find_class(self, module, name):
        if module.split(".")[0] in self._ALLOWED:
            return super().find_class(module, name)
        return _Opaque


def _check_against(params: Any, template: Any) -> None:
    """Every template leaf must exist under the same key path with the same
    shape (JAX ``utils/checkpoint.py _restructure``)."""
    flat_l = _flat(params)
    for key, tv in _flat(template).items():
        if key not in flat_l:
            raise KeyError(f"params: checkpoint has no leaf {key!r} "
                           f"(checkpoint keys: {sorted(flat_l)[:8]}...)")
        l_shape = tuple(np.shape(flat_l[key]))
        t_shape = tuple(tv.shape)
        if l_shape != t_shape:
            raise ValueError(f"params: shape mismatch at {key}: checkpoint "
                             f"{l_shape} vs template {t_shape}")


def load_jax_checkpoint(path: str, template: Optional[Any] = None,
                        device="cuda") -> Any:
    """Params of a JAX ``save_checkpoint`` pickle as torch tensors.

    Only ``params`` is read; the optimizer state is skipped.  With a
    ``template`` (a params tree, e.g. ``init_params`` of the intended
    config), key paths and shapes are checked and a mismatch raises."""
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    params = payload["params"] if isinstance(payload, dict) and "params" in payload else payload
    if not isinstance(params, dict):
        raise ValueError(f"{path}: no params tree in checkpoint")
    if template is not None:
        _check_against(params, template)
    return from_jax_params(params, device)
