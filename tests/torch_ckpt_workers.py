"""Rank functions for tests/test_torch_checkpoint.py.

``parallel.launch`` starts each rank in a fresh interpreter that imports
this module by name, so it imports only torch, numpy and the port (and the
helpers of tests/torch_dp_workers.py, which import no jax either): never
jax, the JAX package or tests/conftest.py.  Each function runs on every
rank of a gloo group on the CPU, on one intra-op thread, and returns numpy
arrays and plain values.

Config: tests/test_torch_pipeline_parallel.py's small one (d_model 32, 2
layers, 2 heads, FFN 64, embeddings 8, vocab 8 a field), dropout 0; 16
songs of 16 tokens, batches of 8, lr 1e-3.
"""

import glob
import json
import os
import sys

import torch

import torch_dp_workers as DW
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.utils import checkpoint as tck

KW = dict(vocab_sizes=(8,) * 6, emb_sizes=(8,) * 6, d_model=32, n_layer=2, n_head=2,
          d_inner=64, dropout=0.0)
CFG = TC.LinearTransformerConfig(**KW)
BATCH = 8
# the meshes in order: each saves, the next resumes from its directory
MESHES = {"A": {"dp": 2, "tp": 2}, "B": {"dp": 2, "pp": 2, "tp": 1},
          "C": {"dp": 1, "pp": 2, "tp": 2}}


def newest(ckpt_dir: str) -> str:
    """The checkpoint of the latest epoch in ``ckpt_dir`` (its sidecar's
    epoch for a directory, the pickle's own for a file)."""
    names = [n for n in glob.glob(os.path.join(ckpt_dir, "*.ckpt"))]

    def epoch(name):
        if os.path.isdir(name):
            with open(name + ".meta.json") as f:
                return json.load(f)["extra"]["epoch"]
        return tck.load_checkpoint(name, device="cpu")["extra"]["epoch"]
    return max(names, key=epoch)


def run(mesh, jparams, data, tmp, tag, backend, n_epoch, resume=None, zero1=False):
    """``pretrain`` on ``mesh`` from the JAX weights (or ``resume``) with the
    ``backend`` checkpoints in ``tmp/tag``: (history, newest checkpoint)."""
    pcfg = TC.PretrainConfig(n_epoch=n_epoch, batch_size=BATCH, lr=1e-3, zero1=zero1,
                             ckpt_backend=backend, ckpt_dir=os.path.join(tmp, tag),
                             exp_dir=os.path.join(tmp, tag + "_exp"))
    _, _, hist = tpre.pretrain(tw.from_jax_params(jparams, device="cpu"), CFG, *data, pcfg,
                               mesh=mesh, resume_from=resume)
    torch.distributed.barrier()         # rank 0 has written its pickle
    return hist, newest(pcfg.ckpt_dir)


def whole_state(mesh, params, state):
    """{"params", "mu", "nu", "count"} put back whole (rank's shards
    gathered over tp and pp)."""
    g = (lambda t: psh.gather_params(mesh, t)) if mesh is not None else (lambda t: t)
    return {"params": DW.flat(g(params)), "mu": DW.flat(g(state.mu)),
            "nu": DW.flat(g(state.nu)), "count": state.count}


def loaded(mesh, path, tx=None):
    """A checkpoint read on ``mesh`` as the resume reads it (the
    directory's shards put together and cut, or the pickle's whole tree
    cut), gathered back whole."""
    if os.path.isdir(path):
        ck = tck.load_checkpoint_orbax(path, device="cpu", mesh=mesh, tx=tx)
        return whole_state(mesh, ck["params"], ck["opt_state"])
    ck = tck.load_checkpoint(path, device="cpu")
    return whole_state(mesh, psh.shard_tree(mesh, ck["params"]),
                       tck.local_opt_state(tx, ck["opt_state"], mesh))


def ckpt_ranks(jparams, data, tmp):
    """On four ranks: at dp = 2 x tp = 2 with ZeRO-1 ("A"), one epoch with
    each backend; at dp = 2 x pp = 2 ("B") A's checkpoints read and each
    run resumed from its own backend's for a second epoch; at pp = 2 x tp =
    2 ("C") the same from B's for a third.  Each mesh's histories, the
    checkpoints' paths, and (rank 0) the trees each read gives."""
    torch.set_num_threads(1)
    out = {"rank": torch.distributed.get_rank(),
           "modules": sorted(m for m in sys.modules if m.split(".")[0] in
                             ("jax", "reinforcement_learning_in_music_generation_tpu",
                              "conftest"))}
    prev = None
    for i, (tag, shape) in enumerate(MESHES.items()):
        mesh = pm.named_mesh(shape)
        res = {}
        if prev is not None:
            res["read"] = {b: loaded(mesh, prev[b]) for b in ("orbax", "pickle")}
        for b in ("orbax", "pickle"):
            res[b] = run(mesh, jparams, data, tmp, f"{tag}_{b}", b, i + 1,
                         resume=None if prev is None else prev[b], zero1=tag == "A")
        prev = {b: res[b][1] for b in ("orbax", "pickle")}
        if mesh.rank != 0:
            res.pop("read", None)
        out[tag] = res
    return out
