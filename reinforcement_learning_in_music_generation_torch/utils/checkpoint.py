"""Checkpoint save/load with resume: the counterpart of the JAX package's
``utils/checkpoint.py`` (the pickle format and ``load_params_lenient``;
orbax waits for the parallelism item of ROADMAP Queue 1).

A checkpoint is a pickle of ``{"params", "opt_state", "step", "extra"}``:

  * ``params`` is the JAX parameter tree as numpy arrays (same key paths,
    ``w`` stored (in, out), per-layer leaves stacked), so the JAX
    package's ``load_checkpoint(path, params_template=...)`` and this
    package's ``weights.load_jax_checkpoint`` both read it;
  * ``opt_state`` is this port's own Adam state, ``{"mu", "nu", "count"}``
    (trees of numpy arrays and an int).  The JAX package's optimizer state
    is an optax object, which the port cannot reproduce, so a JAX run
    cannot resume from a port checkpoint's optimizer state nor the other
    way round; the params cross both ways.

Reading goes through ``weights``' restricted unpickler: numpy arrays and
plain containers only.  Under ZeRO-1 (``train/optim.py Zero1``) a
checkpoint holds the whole moments: ``full_opt_state`` gathers them before
a save, ``local_opt_state`` cuts a rank's slices out of a loaded state.
Under tp the same two gather and cut the moments' tp shards, as
``parallel.gather_params`` and ``parallel.sharding.shard_tree`` do the
parameters': a checkpoint is always the whole tree, in the layout one
process writes, so a run resumes from it at any tp.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Optional

from ..train.optim import AdamState, Zero1
from ..weights import _check_against, _flat, _ParamsUnpickler, from_jax_params, to_numpy


def save_checkpoint(path: str, params: Any, opt_state: Optional[AdamState] = None,
                    step: int = 0, extra: Optional[dict] = None) -> str:
    """Write the checkpoint atomically (temporary file, then rename)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = None
    if opt_state is not None:
        state = {"mu": to_numpy(opt_state.mu), "nu": to_numpy(opt_state.nu),
                 "count": int(opt_state.count)}
    payload = {"params": to_numpy(params), "opt_state": state, "step": int(step),
               "extra": extra or {}}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str, params_template: Any = None, opt_state_template: Any = None,
                    device="cuda") -> dict:
    """Returns {'params', 'opt_state', 'step', 'extra'} with tensors on
    ``device``.  With templates (a params tree; an AdamState) every leaf is
    checked by key path and shape, and a mismatch raises."""
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    params = payload["params"]
    if params_template is not None:
        _check_against(params, params_template)
    out = {"params": from_jax_params(params, device), "opt_state": None,
           "step": int(payload.get("step", 0)), "extra": payload.get("extra", {})}
    state = payload.get("opt_state")
    if isinstance(state, dict) and {"mu", "nu", "count"} <= set(state):
        if opt_state_template is not None:
            _check_against(state["mu"], opt_state_template.mu)
            _check_against(state["nu"], opt_state_template.nu)
        out["opt_state"] = AdamState(from_jax_params(state["mu"], device),
                                     from_jax_params(state["nu"], device),
                                     int(state["count"]))
    return out


def full_opt_state(tx, opt_state: Optional[AdamState], mesh=None) -> Optional[AdamState]:
    """The optimizer state to save: ZeRO-1's moments gathered over dp, and
    under a tp ``mesh`` the moments' shards gathered over tp, and on a
    pipeline mesh their layer slabs over pp (collectives, so every rank
    calls it); any other state as it is."""
    if opt_state is None:
        return None
    if isinstance(tx, Zero1):
        opt_state = tx.full_state(opt_state)
    if mesh is not None and (mesh.tp > 1 or mesh.pp > 1):
        from ..parallel.sharding import gather_params
        opt_state = AdamState(gather_params(mesh, opt_state.mu), gather_params(mesh, opt_state.nu),
                              opt_state.count)
    return opt_state


def local_opt_state(tx, opt_state: AdamState, mesh=None) -> AdamState:
    """A loaded (whole) optimizer state as ``tx`` keeps it on this rank:
    under a tp or pipeline ``mesh`` the moments' shards, then ZeRO-1's
    slices."""
    if mesh is not None and (mesh.tp > 1 or mesh.pp > 1):
        from ..parallel.sharding import shard_tree
        opt_state = AdamState(shard_tree(mesh, opt_state.mu), shard_tree(mesh, opt_state.nu),
                              opt_state.count)
    return tx.local_state(opt_state) if isinstance(tx, Zero1) else opt_state


def load_params_lenient(path: str, params_template: Any) -> Any:
    """``strict=False``-style load (ppo_train.py:226,231; JAX
    ``load_params_lenient``): the params of a pickle checkpoint (the JAX
    package's or this port's; a bare params tree too) merged into
    ``params_template``, a tree of tensors: each leaf whose key path and
    shape match takes the checkpoint's values, in the template leaf's
    dtype and on its device; every other leaf keeps the template's."""
    with open(path, "rb") as f:
        payload = _ParamsUnpickler(f).load()
    loaded = payload["params"] if isinstance(payload, dict) and "params" in payload else payload
    flat_l = _flat(loaded)

    def merge(tree, prefix=""):
        if isinstance(tree, dict):
            return {k: merge(v, f"{prefix}[{k!r}]") for k, v in tree.items()}
        lv = flat_l.get(prefix)
        if lv is not None and tuple(getattr(lv, "shape", ())) == tuple(tree.shape):
            return from_jax_params(lv, tree.device).to(tree.dtype)
        return tree

    return merge(params_template)
