"""The (dp, tp) mesh: one process a rank over ``torch.distributed`` (the
counterpart of the JAX package's ``parallel/mesh.py``).

JAX runs its ('dp', 'tp') mesh as one program over the devices (GSPMD).  The
port runs one process a rank.  A mesh of dp x tp ranks lays them out as JAX
lays out its devices (``reshape(dp, tp)``, tp the minor axis): rank r sits
at dp index r // tp and tp index r % tp.  The ranks of one dp index (a tp
group) hold the same rows of each global batch, rows
[i b/dp, (i+1) b/dp) for dp index i (a batch whose leading size dp does not
divide is kept whole on every rank, as JAX's ``shard_batch`` replicates
it), and each holds its tp shard of the parameters that the Megatron rules
split (``parallel/sharding.py``).  The callers add the collectives that
GSPMD inserts: over the dp group the masked CE's denominator and the
gradients (``ops/losses.py``, ``train/pretrain.py``), ZeRO-1's updates
(``train/optim.py``) and the songs (``generate/sampler.py``); over the tp
group the Megatron layer's (``parallel/tensor.py``) and the clip's norm.

Backends: ``nccl`` where each rank has a card of its own (rank r on
``cuda:r``), ``gloo`` on the CPU.  NCCL refuses two ranks on one card (a
duplicate GPU), so ``make_mesh`` raises where the ranks' devices share a card
unless the caller passes ``backend="gloo"``; gloo then carries the CUDA
tensors as they are (the card's PyTorch 2.11 runs every collective used here
on them: ``chip_smoke.py`` phase 34).

``launch`` starts the ranks of one machine: a process each (start method
``spawn``), a ``file://`` rendezvous in a fresh temporary directory, a
timeout on the process group's collectives and on every join; a rank that
raises stops them all.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import queue as queue_lib
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..config import MeshConfig

# the collectives' and the rendezvous' limit (torch's own default for gloo)
DEFAULT_TIMEOUT_S = 1800.0
_JOIN_S = 60.0          # a rank that has sent its result must exit within this


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """A rank's view of the mesh: the axis sizes (``shape["dp"]``,
    ``shape["tp"]``), this process's rank, the device it computes on, the
    process group's backend (the default group), and the subgroups of its
    two axes: ``groups["dp"]`` the ranks of its tp index (its dp row),
    ``groups["tp"]`` the ranks of its dp index (its tp column).  An axis
    that spans the world has None (the default group) as its group; an axis
    of size 1 needs none."""

    shape: Dict[str, int]
    rank: int
    device: torch.device
    backend: str
    groups: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def dp(self) -> int:
        return self.shape["dp"]

    @property
    def tp(self) -> int:
        return self.shape.get("tp", 1)

    @property
    def dp_index(self) -> int:
        return self.rank // self.tp

    @property
    def tp_index(self) -> int:
        return self.rank % self.tp

    def size(self, axis: str) -> int:
        """The ranks of ``axis`` ("dp", "tp" or "world")."""
        return self.dp * self.tp if axis == "world" else self.shape.get(axis, 1)

    def group(self, axis: str):
        """The process group of ``axis`` (None: the default group)."""
        if axis == "world":
            return None
        if axis not in ("dp", "tp"):
            raise ValueError(f"axis {axis!r}: expected 'dp', 'tp' or 'world'")
        return self.groups.get(axis)


def _axis_groups(dp: int, tp: int, rank: int) -> Dict[str, Any]:
    """Every dp row's and every tp column's group, made on every rank in the
    same order (``dist.new_group`` is collective); this rank's two.  Only a
    mesh with both axes above 1 needs them: otherwise the axis of size > 1
    is the world."""
    if dp == 1 or tp == 1:
        return {}
    mine = {}
    for t in range(tp):                         # dp rows: the ranks of tp index t
        g = dist.new_group([d * tp + t for d in range(dp)])
        if rank % tp == t:
            mine["dp"] = g
    for d in range(dp):                         # tp columns: the ranks of dp index d
        g = dist.new_group([d * tp + t for t in range(tp)])
        if rank // tp == d:
            mine["tp"] = g
    return mine


def make_mesh(dp: int = -1, tp: int = 1, devices: Optional[Sequence] = None,
              backend: Optional[str] = None) -> Mesh:
    """This rank's ``Mesh`` over the initialized process group, whose size
    must be dp * tp (dp = -1: the world size / tp); rank r at dp index
    r // tp, tp index r % tp.  ``devices``: one torch device a rank
    (default ``cuda:r`` under nccl, the CPU under gloo).  Ranks that share a
    card need ``backend="gloo"``, passed explicitly; ``backend`` must name
    the group's backend where given.  Every rank calls it (the axes'
    subgroups are made collectively)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group "
                           "(parallel.launch starts one a rank; under torchrun, "
                           "init_process_group)")
    world, rank = dist.get_world_size(), dist.get_rank()
    dp, tp = MeshConfig(dp, tp).axis_sizes(world)
    if dp * tp != world:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} ranks; the process group has {world}")
    group_backend = dist.get_backend()
    if backend is not None and backend != group_backend:
        raise ValueError(f"backend={backend!r}, but the process group runs {group_backend!r}")
    if devices is None:
        devices = [torch.device("cuda", r) if group_backend == "nccl" else torch.device("cpu")
                   for r in range(world)]
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    cards = {d.index or 0 for d in devices if d.type == "cuda"}
    if any(d.type == "cuda" for d in devices):
        if not torch.cuda.is_available() or max(cards) >= torch.cuda.device_count():
            raise ValueError(f"devices {devices}: this machine has "
                             f"{torch.cuda.device_count()} CUDA cards")
        if len(cards) < world and backend != "gloo":
            raise ValueError(f"{world} ranks on {len(cards)} card(s): NCCL takes one card a "
                             "rank; pass backend='gloo' (over a gloo process group) to share "
                             "a card")
    elif group_backend == "nccl":
        raise ValueError("an nccl process group needs CUDA devices")
    return Mesh({"dp": dp, "tp": tp}, rank, devices[rank], group_backend,
                _axis_groups(dp, tp, rank))


def row_block(mesh: Mesh, n: int) -> Tuple[int, int]:
    """(i, k): this rank holds the i-th of k equal blocks of a leading axis
    of ``n`` rows, (dp index, dp), or (0, 1) where dp does not divide n."""
    return (0, 1) if n % mesh.dp else (mesh.dp_index, mesh.dp)


def shard_rows(mesh: Mesh, n: int) -> slice:
    """The rows of this rank's dp index on a leading axis of ``n``: its 1/dp
    share, or all of them where dp does not divide n (``row_block``).  The
    ranks of one tp group get the same rows."""
    i, k = row_block(mesh, n)
    return slice(i * (n // k), (i + 1) * (n // k))


def shard_batch(mesh: Mesh, batch):
    """Each leaf's rows of this rank (``shard_rows`` of its leading axis);
    a tuple, list or dict of tensors or numpy arrays."""
    if isinstance(batch, dict):
        return {k: shard_batch(mesh, v) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, v) for v in batch)
    return batch[shard_rows(mesh, batch.shape[0])] if batch.ndim else batch


def _in_place(tensors: Sequence[torch.Tensor], collective: Callable) -> None:
    """``collective`` on one flat buffer a dtype of the tensors, its result
    copied back into them."""
    groups: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        groups.setdefault(t.dtype, []).append(t)
    for group in groups.values():
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        collective(flat)
        off = 0
        for t in group:
            t.detach().copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def all_reduce_(mesh: Mesh, tensors: Sequence[torch.Tensor], op: str = "sum", *,
                axis: str) -> None:
    """Each tensor summed ("sum") or maxed ("max") over the ranks of
    ``axis`` ("dp", "tp" or "world"), in place: one collective a dtype."""
    if mesh.size(axis) == 1:
        return
    group = mesh.group(axis)
    _in_place(tensors, lambda flat: dist.all_reduce(flat, op=_OPS[op], group=group))


def broadcast_(mesh: Mesh, tensors: Sequence[torch.Tensor], src: int = 0, *,
               axis: str) -> None:
    """The values of each tensor on the ``src``-th rank of ``axis`` on every
    rank of it, in place."""
    if mesh.size(axis) == 1:
        return
    group = mesh.group(axis)
    root = src if group is None else dist.get_global_rank(group, src)
    _in_place(tensors, lambda flat: dist.broadcast(flat, src=root, group=group))


def all_gather(mesh: Mesh, t: torch.Tensor, *, axis: str) -> List[torch.Tensor]:
    """Every ``axis`` rank's ``t`` (the same shape and dtype on each), in
    the order of their index on the axis."""
    n = mesh.size(axis)
    if n == 1:
        return [t]
    src = t.detach().contiguous()
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=mesh.group(axis))
    return out


def all_gather_object(mesh: Mesh, obj: Any, *, axis: str) -> list:
    """Every ``axis`` rank's picklable ``obj``, in the order of their index
    on the axis."""
    n = mesh.size(axis)
    if n == 1:
        return [obj]
    out = [None] * n
    dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out


# -- launching the ranks ---------------------------------------------------------

def _to_host(obj):
    """Tensors in a rank's result as numpy arrays (bf16 widened to f32)."""
    if torch.is_tensor(obj):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)) and not hasattr(obj, "_fields"):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_entry(fn, args, rank, world, backend, init_method, results):
    """A spawned rank: join the group (nccl: on ``cuda:rank``), run ``fn``,
    send its result or its traceback."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=DEFAULT_TIMEOUT_S))
        out = _to_host(fn(*args))
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:               # reported to the parent, which stops every rank
        results.put((rank, False, traceback.format_exc()))
        results.close()
        results.join_thread()
        sys.exit(1)


def launch(fn: Callable, world: int, args: tuple = (), *, backend: str = "gloo",
           timeout_s: Optional[float] = None) -> list:
    """Run ``fn(*args)`` in ``world`` new processes, one a rank of a process
    group of ``backend``; returns each rank's return value, in rank order
    (tensors as numpy arrays).  ``fn`` is pickled by reference, so it lives
    at the top level of a module the children can import; they start from a
    fresh interpreter (``spawn``).  ``timeout_s`` bounds the whole run
    (None: no bound), ``DEFAULT_TIMEOUT_S`` the rendezvous and each
    collective.  A rank that raises or dies, or a run past ``timeout_s``,
    kills every rank and raises here."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="rlmg_dp_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_entry, daemon=True,
                         args=(fn, args, r, world, backend, init_method, results))
             for r in range(world)]
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    out: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue_lib.Empty:
                for r, p in enumerate(procs):
                    if r not in out and p.exitcode is not None:
                        raise RuntimeError(f"rank {r} exited with code {p.exitcode} "
                                           "and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for r, p in enumerate(procs):
            p.join(_JOIN_S)
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} sent its result, then exited with code "
                                   f"{p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(_JOIN_S)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]


def launched_by_torchrun() -> bool:
    """The environment of a rank that ``torchrun`` started (RANK and
    WORLD_SIZE set), whose group the CLI joins instead of launching."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def join_torchrun_group(backend: str, timeout_s: float = DEFAULT_TIMEOUT_S) -> int:
    """Join ``torchrun``'s process group (env:// rendezvous; nccl: on
    ``cuda:LOCAL_RANK``) unless already in one; returns the rank."""
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))
        dist.init_process_group(backend, init_method="env://",
                                timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank()
