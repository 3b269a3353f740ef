"""Checkpoint save/load with resume: the counterpart of the JAX package's
``utils/checkpoint.py``: the pickle format, ``load_params_lenient``, and
the sharded, asynchronous directory format that takes the place of JAX's
orbax backend (``save_checkpoint_orbax``, ``wait_for_checkpoints``,
``load_checkpoint_orbax``; the section below says more).

A pickle checkpoint is a pickle of ``{"params", "opt_state", "step", "extra"}``:

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

import json
import os
import pickle
import re
import threading
import uuid
import zlib
from typing import Any, Optional

import torch

from ..train.optim import AdamState, Zero1, tree_leaves, tree_map
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


# ---------------------------------------------------------------------------
# The sharded, asynchronous checkpoint (JAX's orbax backend)
# ---------------------------------------------------------------------------
#
# JAX saves its sharded jax.Arrays through orbax: each host writes its own
# shards, in the background (AsyncCheckpointer), and a restore lays them out
# on the template's sharding.  torch tensors carry no sharding, and orbax and
# tensorstore are not used here, so the port has a format of its own, under
# JAX's function names.  A checkpoint is a directory at ``path``:
#
#   index.json                    written by rank 0: the format and version,
#                                 the save's token, the mesh shape, Adam's
#                                 count, every leaf of params, opt_state.mu
#                                 and opt_state.nu (its JAX key path, whole
#                                 shape, dtype and layout: the dimension
#                                 split over tp, whether it is a slab of the
#                                 layers over pp, the dimension ZeRO-1
#                                 slices over dp) and every shard (its rank,
#                                 file, byte range and place in the leaf);
#   shard-<token>-r<rank>.bin     one a writing rank: its shards' raw bytes,
#                                 little-endian, one after another;
#   manifest-<token>-r<rank>.json one a writing rank, written last: the
#                                 rank, its mesh coordinates, the data
#                                 file's size and CRC-32, so the rank's
#                                 shards are committed.
#
# and beside it JAX's sidecar ``path + ".meta.json"``, {"step", "extra"}.
#
# A rank writes its piece of a leaf where its index is 0 on every mesh axis
# that does not split the leaf: the dp replicas hold the same bits, so only
# dp index 0 writes the parameters and whole moments, every dp index its
# ZeRO-1 slices; each tp rank its tp shard, each stage its slab of the
# layers.  Nothing is gathered.  The save copies the rank's shards to host
# memory (the snapshot: the steps update params and the moments in place)
# and returns; a thread writes the files and issues no collective.  A load
# refuses an index that a writing rank's manifest is missing from, puts each
# leaf back whole on the host and cuts the caller's mesh's share of it
# (``shard_tree``, ``local_opt_state``), so a run resumes at any dp, tp or
# pp, or in one process.

FORMAT = "rlmg-torch-sharded"
VERSION = 1
INDEX = "index.json"
_PENDING: list = []             # (thread, errors) of the saves in flight
_TREES = ("params", "mu", "nu")


class NotAPortCheckpoint(ValueError):
    """A directory without the port's index (a JAX orbax directory among
    them: its OCDBT layout is not read here)."""


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _coords(shape: dict, rank: int) -> dict:
    """Rank ``rank``'s index on each axis of a mesh of ``shape`` (row major,
    the minor axis last, as ``parallel.mesh.Mesh.index``)."""
    out, stride = {}, 1
    for axis in reversed(list(shape)):
        out[axis] = (rank // stride) % shape[axis]
        stride *= shape[axis]
    return dict(reversed(list(out.items())))


def _keys(path: str) -> list:
    return re.findall(r"\['([^']*)'\]", path)


def _plan(trees: list, mesh, dp_axes: Optional[list]) -> dict:
    """What every rank writes, computed alike on every rank (no collective).
    ``trees``: [(name, this rank's tree)]; ``dp_axes``: ZeRO-1's sliced
    dimension of each moment leaf (None: no ZeRO-1)."""
    from ..parallel.sharding import layouts
    from ..weights import _flat
    shape = dict(mesh.shape) if mesh is not None else {}
    world = 1
    for n in shape.values():
        world *= n
    leaves = []
    for name, tree in trees:
        flat = _flat(tree)
        lay = layouts(mesh, tree) if mesh is not None else [(None, False)] * len(flat)
        for i, ((path, t), (tp_dim, slab)) in enumerate(zip(flat.items(), lay)):
            dp_dim = dp_axes[i] if dp_axes is not None and name != "params" else None
            whole = list(t.shape)
            split = {}
            if tp_dim is not None:
                whole[tp_dim] *= shape["tp"]
                split["tp"] = tp_dim
            if slab:
                whole[0] *= shape["pp"]
                split["pp"] = 0
            if dp_dim is not None:
                whole[dp_dim] *= shape["dp"]
                split["dp"] = dp_dim
            leaves.append({"tree": name, "path": path, "shape": whole,
                           "dtype": _dtype_name(t.dtype), "tp_dim": tp_dim, "pp_slab": slab,
                           "dp_dim": dp_dim, "split": split, "local": list(t.shape),
                           "itemsize": t.element_size()})
    shards, sizes = [], {}
    for r in range(world):
        c = _coords(shape, r)
        off, first = 0, len(shards)
        for li, leaf in enumerate(leaves):
            if any(c[a] != 0 for a in shape if a not in leaf["split"]):
                continue
            start = [0] * len(leaf["shape"])
            for a, d in leaf["split"].items():
                start[d] = c[a] * leaf["local"][d]
            n = leaf["itemsize"]
            for k in leaf["local"]:
                n *= k
            shards.append({"leaf": li, "rank": r, "offset": off, "nbytes": n, "start": start,
                           "shape": leaf["local"]})
            off += n
        if len(shards) > first:
            sizes[r] = off
    return {"shape": shape, "leaves": leaves, "shards": shards, "sizes": sizes,
            "coords": {r: _coords(shape, r) for r in sizes}}


def _names(token: str, rank: int):
    return f"shard-{token}-r{rank:05d}.bin", f"manifest-{token}-r{rank:05d}.json"


def _write_atomic(path: str, data) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _snapshot(pieces: list) -> torch.Tensor:
    """The rank's shards' bytes, one after another, in host memory: one
    copy, which the steps' later in-place updates cannot reach."""
    flat = torch.cat(pieces)
    return flat.cpu() if flat.is_cuda else flat


def _writer(path: str, rank: int, token: str, index: Optional[bytes], snapshot,
            coords: dict, errors: list) -> None:
    """The background write of one rank's files (no collective): rank 0
    first the index and the removal of every other save's files; then the
    data file; the manifest last."""
    try:
        if index is not None:
            _write_atomic(os.path.join(path, INDEX), index)
            for name in os.listdir(path):
                if name != INDEX and token not in name:
                    os.remove(os.path.join(path, name))
        if snapshot is None:
            return
        data_name, manifest_name = _names(token, rank)
        view = memoryview(snapshot.numpy())
        _write_atomic(os.path.join(path, data_name), view)
        manifest = {"format": FORMAT, "token": token, "rank": rank, "coords": coords,
                    "file": data_name, "nbytes": len(view), "crc32": zlib.crc32(view)}
        _write_atomic(os.path.join(path, manifest_name), json.dumps(manifest).encode())
    except Exception as err:               # re-raised by wait_for_checkpoints
        errors.append(err)


def save_checkpoint_orbax(path: str, params: Any, opt_state: Optional[AdamState] = None,
                          step: int = 0, extra: Optional[dict] = None, wait: bool = False,
                          mesh=None, tx=None) -> str:
    """Asynchronous sharded save to the directory ``path`` (JAX
    ``save_checkpoint_orbax``; the port's own format, no orbax).  Every
    rank of ``mesh`` calls it with its shards (``params`` and
    ``opt_state`` as it holds them; ``tx`` the optimizer, whose ZeRO-1
    slices it reads); the ranks agree on the save's token (one small
    collective, on this thread), each copies its shards to host memory and
    returns with its files being written by a thread of its own.
    ``wait_for_checkpoints()`` (or ``wait=True``) joins it.  A save to a
    path that holds an earlier checkpoint, of any mesh, or a pickle file,
    replaces it."""
    path = os.path.abspath(path)
    rank = mesh.rank if mesh is not None else 0
    wait_for_checkpoints()      # this rank's saves in flight (orbax's AsyncCheckpointer waits too)
    if rank == 0 and os.path.isfile(path):
        os.remove(path)
    token = uuid.uuid4().hex
    if mesh is not None and mesh.size("world") > 1:
        from ..parallel.mesh import all_gather_object
        token = all_gather_object(mesh, token, axis="world")[0]
    os.makedirs(path, exist_ok=True)
    trees = [("params", params)]
    if opt_state is not None:
        trees += [("mu", opt_state.mu), ("nu", opt_state.nu)]
    dp_axes = tree_leaves(tx.axes) if isinstance(tx, Zero1) and opt_state is not None else None
    plan = _plan(trees, mesh, dp_axes)
    mine = [leaf for _, tree in trees for leaf in tree_leaves(tree)]
    pieces = [mine[s["leaf"]].detach().reshape(-1).view(torch.uint8)
              for s in plan["shards"] if s["rank"] == rank]
    snapshot = _snapshot(pieces) if pieces else None
    index = None
    if rank == 0:
        files = {r: _names(token, r)[0] for r in plan["sizes"]}
        index = json.dumps({
            "format": FORMAT, "version": VERSION, "token": token, "mesh": plan["shape"],
            "count": int(opt_state.count) if opt_state is not None else None,
            "writers": sorted(plan["sizes"]),
            "coords": {str(r): c for r, c in plan["coords"].items()},
            "leaves": [{k: v for k, v in leaf.items() if k not in ("split", "local", "itemsize")}
                       for leaf in plan["leaves"]],
            "shards": [dict(s, file=files[s["rank"]]) for s in plan["shards"]],
        }).encode()
        meta = {"step": int(step), "extra": extra or {}}
        with open(path + ".meta.json", "w") as f:
            json.dump(meta, f)
    errors: list = []
    thread = threading.Thread(target=_writer, name=f"checkpoint-r{rank}", daemon=False,
                              args=(path, rank, token, index, snapshot,
                                    plan["coords"].get(rank, {}), errors))
    thread.start()
    _PENDING.append((thread, errors))
    if wait:
        wait_for_checkpoints()
    return path


def wait_for_checkpoints() -> None:
    """Block until this process's saves in flight have committed (their
    manifests written); a save's error is raised here."""
    errors = []
    while _PENDING:
        thread, errs = _PENDING.pop(0)
        thread.join()
        errors += errs
    if errors:
        raise errors[0]


def _read_index(path: str) -> dict:
    name = os.path.join(path, INDEX)
    if not os.path.isfile(name):
        raise NotAPortCheckpoint(
            f"{path} is not a checkpoint of this port: it has no {INDEX} (a JAX orbax "
            "directory's OCDBT layout is not read; the port reads the JAX package's pickle "
            "checkpoints)")
    with open(name) as f:
        index = json.load(f)
    if index.get("format") != FORMAT or index.get("version") != VERSION:
        raise NotAPortCheckpoint(f"{name}: format {index.get('format')!r} version "
                                 f"{index.get('version')!r}, expected {FORMAT!r} {VERSION}")
    return index


def _committed(path: str, index: dict) -> dict:
    """Each writing rank's data, checked against its manifest: a manifest
    missing (the save incomplete), of another save, of another rank or
    mesh coordinates (a rank's shards in another's slot), or a data file
    whose size or CRC-32 differs raises."""
    token, data = index["token"], {}
    for r in index["writers"]:
        data_name, manifest_name = _names(token, r)
        mpath = os.path.join(path, manifest_name)
        if not os.path.isfile(mpath):
            raise RuntimeError(f"{path}: the checkpoint is not complete: rank {r}'s manifest "
                               f"{manifest_name} is missing (a save still in flight, or cut)")
        with open(mpath) as f:
            man = json.load(f)
        want = index["coords"][str(r)]
        if (man.get("token") != token or man.get("rank") != r or man.get("coords") != want
                or man.get("file") != data_name):
            raise RuntimeError(f"{path}: the manifest in rank {r}'s slot is rank "
                               f"{man.get('rank')}'s at {man.get('coords')} of save "
                               f"{man.get('token')}, expected rank {r} at {want} of {token}")
        with open(os.path.join(path, data_name), "rb") as f:
            blob = bytearray(f.read())
        if len(blob) != man["nbytes"] or zlib.crc32(blob) != man["crc32"]:
            raise RuntimeError(f"{path}: {data_name} is not the data rank {r} committed "
                               f"({len(blob)} bytes, CRC-32 {zlib.crc32(blob)}; the manifest "
                               f"says {man['nbytes']}, {man['crc32']})")
        data[r] = blob
    return data


def _assemble(index: dict, data: dict) -> dict:
    """{tree name: {key path: the whole leaf, a CPU tensor}} from the shards;
    a leaf the shards do not cover element for element raises."""
    out = {name: {} for name in _TREES}
    whole, covered = [], []
    for leaf in index["leaves"]:
        t = torch.empty(leaf["shape"], dtype=getattr(torch, leaf["dtype"]))
        whole.append(t)
        covered.append(0)
        out[leaf["tree"]][leaf["path"]] = t
    for s in index["shards"]:
        t = whole[s["leaf"]]
        n = 1
        for k in s["shape"]:
            n *= k
        piece = torch.frombuffer(data[s["rank"]], dtype=t.dtype, count=n,
                                 offset=s["offset"]).view(s["shape"])
        dst = t
        for d, (a, k) in enumerate(zip(s["start"], s["shape"])):
            dst = dst.narrow(d, a, k)
        dst.copy_(piece)
        covered[s["leaf"]] += n
    for leaf, t, n in zip(index["leaves"], whole, covered):
        if n != t.numel():
            raise RuntimeError(f"{leaf['tree']} {leaf['path']}: the shards cover {n} of "
                               f"{t.numel()} elements")
    return out


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        keys = _keys(path)
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = leaf
    return tree


def _check_shapes(what: str, tree: Any, template: Any) -> None:
    """Every template leaf under the same key path with the same shape
    (``weights._check_against``'s rule, on tensors)."""
    from ..weights import _flat
    got = _flat(tree)
    for key, tv in _flat(template).items():
        if key not in got:
            raise KeyError(f"{what}: checkpoint has no leaf {key!r} "
                           f"(checkpoint keys: {sorted(got)[:8]}...)")
        if tuple(got[key].shape) != tuple(tv.shape):
            raise ValueError(f"{what}: shape mismatch at {key}: checkpoint "
                             f"{tuple(got[key].shape)} vs template {tuple(tv.shape)}")


def load_checkpoint_orbax(path: str, params_template: Any = None,
                          opt_state_template: Optional[AdamState] = None, device="cuda",
                          mesh=None, tx=None) -> dict:
    """Returns {'params', 'opt_state', 'step', 'extra'} like
    ``load_checkpoint`` (JAX ``load_checkpoint_orbax``), after waiting for
    this process's saves in flight.  Each leaf is put back whole from its
    shards, whatever mesh wrote them; under ``mesh`` the result is this
    rank's share on it (``shard_tree``; the moments through
    ``local_opt_state`` with ``tx``, ZeRO-1's slices among them), else the
    whole trees, on ``device``.  Templates (the trees as the caller holds
    them: under ``mesh`` its shards) are checked by key path and shape.  A
    directory that is not the port's checkpoint raises
    ``NotAPortCheckpoint``; an incomplete or inconsistent one
    ``RuntimeError``."""
    path = os.path.abspath(path)
    wait_for_checkpoints()
    index = _read_index(path)
    flat = _assemble(index, _committed(path, index))
    # the caller's share is cut on the host, then moved
    params = _nest(flat["params"])
    if mesh is not None:
        from ..parallel.sharding import shard_tree
        params = shard_tree(mesh, params)
    params = tree_map(lambda t: t.to(device), params)
    if params_template is not None:
        _check_shapes("params", params, params_template)
    state = None
    if flat["mu"]:
        state = local_opt_state(tx, AdamState(_nest(flat["mu"]), _nest(flat["nu"]),
                                              int(index["count"])), mesh)
        state = AdamState(tree_map(lambda t: t.to(device), state.mu),
                          tree_map(lambda t: t.to(device), state.nu), state.count)
        if opt_state_template is not None:
            _check_shapes("opt_state.mu", state.mu, opt_state_template.mu)
            _check_shapes("opt_state.nu", state.nu, opt_state_template.nu)
    meta = {"step": 0, "extra": {}}
    if os.path.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            meta = json.load(f)
    return {"params": params, "opt_state": state, "step": int(meta["step"]),
            "extra": meta["extra"]}
