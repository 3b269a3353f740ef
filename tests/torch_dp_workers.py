"""Rank functions for tests/test_torch_parallel.py.

``parallel.launch`` starts each rank in a fresh interpreter that imports
this module by name, so it imports only torch, numpy and the port: never
jax, the JAX package or tests/conftest.py.  Each function runs on every
rank of a gloo group on the CPU, on one intra-op thread (the suite's
workers share the machine), and returns numpy arrays and plain values for
the test to hold against the JAX package's mesh.

Small config: vocab (8,) * 6, embeddings 8, d_model 32, 2 layers, 2 heads,
FFN 64, dropout 0 (tests/test_ffn_block.py's dp test).
"""

import dataclasses
import glob
import os
import sys

import torch
import torch.distributed

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import attention_block as tab
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_torch.train.data_pipeline import prefetch_batches
from reinforcement_learning_in_music_generation_torch.utils.saver import MetricsBus, QuietSaver

KW = dict(vocab_sizes=(8,) * 6, emb_sizes=(8,) * 6, d_model=32, n_layer=2, n_head=2,
          d_inner=64, dropout=0.0)
CFG = TC.LinearTransformerConfig(**KW)
ROUTES = {"xla": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"},
          "kernels": {"RLMG_FFN_BACKEND": "pallas-tail", "RLMG_ATTN_BACKEND": "pallas-qkv"}}


def flat(tree, prefix=""):
    """{key path: numpy array} of a tree of tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy().copy()}


def _route(name):
    os.environ.update(ROUTES[name])


def _tensors(batch):
    x, y, m = batch
    return torch.from_numpy(x).long(), torch.from_numpy(y).long(), torch.from_numpy(m).float()


class _Counted:
    """Counts the calls of a module's plain kernel twin (the wrappers take it
    on CPU tensors), so a rank can show which route its layers ran."""

    def __init__(self, module, name):
        self.module, self.name, self.fn, self.calls = module, name, getattr(module, name), 0

    def __enter__(self):
        def counted(*a, **k):
            self.calls += 1
            return self.fn(*a, **k)
        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def _steps(mesh, jparams, batch, route, n=3):
    """``n`` agent_train_steps on this rank's rows of ``batch``: the
    global losses, the first step's all-reduced gradient, this rank's own
    (local-mean) loss and gradient for the naive-mean control, and the
    calls of C's and D's plain twins in the first gradient step."""
    _route(route)
    tp = tw.from_jax_params(jparams, device="cpu")
    x, y, m = _tensors(pm.shard_batch(mesh, batch))
    with _Counted(tab, "qkv_attention_block_plain") as c, \
            _Counted(tfb, "attn_tail_block_plain") as d:
        grads, (loss0, _) = tpre.agent_grad_step(tp, CFG, x, y, m, None, dp_mesh=mesh)
    local_grads, (local_loss, _) = tpre.agent_grad_step(tp, CFG, x, y, m, None)
    tx = topt.adam(1e-4, grad_clip=3.0)
    ts = tx.init(tp)
    losses, per_field = [], []
    for _ in range(n):
        tp, ts, (loss, fl) = tpre.agent_train_step(tp, ts, CFG, tx, x, y, m, None, dp_mesh=mesh)
        losses.append(float(loss))
        per_field.append(fl.numpy().copy())
    return {"rows": int(x.shape[0]), "loss0": float(loss0), "grads": flat(grads),
            "local_loss": float(local_loss), "local_grads": flat(local_grads),
            "losses": losses, "per_field": per_field, "params": flat(tp),
            "c_calls": c.calls, "d_calls": d.calls}


def _run(mesh, jparams, data, pcfg, max_steps=None, resume=None):
    tp = tw.from_jax_params(jparams, device="cpu")
    return tpre.pretrain(tp, CFG, *data, pcfg, mesh=mesh, max_steps=max_steps,
                         resume_from=resume)


class _InterruptOnRank1(MetricsBus):
    """Sets the loop's interrupt flag on rank 1 alone, at its first logged
    batch, as a signal delivered to one process would."""

    def __init__(self, rank):
        super().__init__(QuietSaver())
        self.rank = rank

    def log(self, metrics, step=None):
        super().log(metrics, step)
        if self.rank == 1:
            tpre.INTERRUPT.set()


def _interrupt(mesh, jparams, data, pcfg):
    bus = _InterruptOnRank1(mesh.rank)
    tp = tw.from_jax_params(jparams, device="cpu")
    tpre.pretrain(tp, CFG, *data, pcfg, mesh=mesh, metrics=bus)
    return {"steps": bus.saver.global_step,
            "files": sorted(os.listdir(pcfg.ckpt_dir)) if os.path.isdir(pcfg.ckpt_dir) else []}


def _masks(mesh):
    """Kernel D's dropout under the mesh: the rank's seed for the same
    generator state, the masks D draws with it, and a forward on the D
    route (dropout 0.1) of the same rows from the same generator seed, with
    and without the mesh."""
    gen = torch.Generator().manual_seed(5)
    seed = tlt._dropout_seed(gen, 0.1, torch.device("cpu"), mesh)
    mask = tfb.dropout_scale(seed, 1, 0, 64, 32, 0.1, torch.device("cpu"))
    _route("kernels")
    cfg = dataclasses.replace(CFG, dropout=0.1)
    tp = tlt.init_params(cfg, seed=0, device="cpu")
    x = torch.randint(0, 8, (2, 16, 6), generator=torch.Generator().manual_seed(9))
    outs = {}
    for name, dp_mesh in (("mesh", mesh), ("none", None)):
        g = torch.Generator().manual_seed(11)
        outs[name] = tlt.forward_hidden(tp, cfg, x, deterministic=False, generator=g,
                                        dp_mesh=dp_mesh).detach().numpy()
    return {"seed": int(seed), "mask": mask.numpy(), "out_mesh": outs["mesh"],
            "out_none": outs["none"]}


def _generate(mesh, jparams):
    tp = tw.from_jax_params(jparams, device="cpu")
    gcfg = TC.GenerateConfig(batch_size=4, max_tokens=12, bar_production=10 ** 9, greedy=True)
    stoch = dataclasses.replace(gcfg, greedy=False, seed=3)
    return {"greedy": tsam.generate_songs(tp, CFG, gcfg, mesh=mesh),
            "stochastic": tsam.generate_songs(tp, CFG, stoch, mesh=mesh),
            "whole": tsam.generate_songs(tp, CFG, dataclasses.replace(stoch, batch_size=3),
                                         mesh=mesh)}


def dp2(jparams, batch, whole_batch, data, tmp):
    """Every dp = 2 scenario of the test file on this rank."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(2)
    out = {"rank": mesh.rank,
           "modules": sorted(m for m in sys.modules if m.split(".")[0] in
                             ("jax", "reinforcement_learning_in_music_generation_tpu", "conftest")),
           "xla": _steps(mesh, jparams, batch, "xla"),
           "kernels": _steps(mesh, jparams, batch, "kernels"),
           "whole": _steps(mesh, jparams, whole_batch, "xla", n=1)}
    _route("xla")

    def mk(tag, **kw):
        return TC.PretrainConfig(**{"batch_size": 8, "exp_dir": os.path.join(tmp, tag, "exp"),
                                    "ckpt_dir": os.path.join(tmp, tag, "ckpt"), **kw})

    # grad_accum = 2: the summed half-scaled micro-gradients of two global
    # batches (this rank's rows of each), and the loop's step with them
    tp = tw.from_jax_params(jparams, device="cpu")
    acc = [tpre.agent_grad_step(tp, CFG, bx, by, bm, None, scale=0.5, dp_mesh=mesh)[0]
           for i, (bx, by, bm) in prefetch_batches(*data, 8, "cpu", mesh=mesh) if i < 2]
    p, _, _ = _run(mesh, jparams, data, mk("accum", grad_accum=2), max_steps=2)
    out["accum"] = {"grads": flat(topt.tree_map(torch.add, *acc)), "params": flat(p)}
    p_plain, _, _ = _run(mesh, jparams, data, mk("plain"), max_steps=3)
    p_zero, s_zero, _ = _run(mesh, jparams, data, mk("zero1", zero1=True), max_steps=3)
    out["zero1"] = {"plain": flat(p_plain), "zero1": flat(p_zero),
                    "mu_ffn1": tuple(s_zero.mu["layers"]["ffn1"]["w"].shape)}
    # a checkpoint at the end of epoch 0 (rank 0 writes, ZeRO-1 moments
    # gathered), a resume from it for epoch 1, and the same two epochs
    # straight through
    two = data[0][:16], data[1][:16], data[2][:16]
    p1, _, h1 = _run(mesh, jparams, two, mk("ckpt", zero1=True, n_epoch=1))
    torch.distributed.barrier()             # rank 0 has written the file
    paths = sorted(glob.glob(os.path.join(tmp, "ckpt", "ckpt", "*.ckpt")))
    p_res, _, _ = _run(mesh, jparams, two, mk("resume", zero1=True, n_epoch=2), resume=paths[0])
    p_str, _, h_str = _run(mesh, jparams, two, mk("straight", zero1=True, n_epoch=2))
    out["ckpt"] = {"paths": paths, "params": flat(p1), "history": h1, "resumed": flat(p_res),
                   "straight": flat(p_str), "straight_history": h_str}
    torch.distributed.barrier()
    out["interrupt"] = _interrupt(mesh, jparams, data, mk("interrupt", log_every=1,
                                                          save_on_interrupt=True))
    out["masks"] = _masks(mesh)
    out["generate"] = _generate(mesh, jparams)
    return out


def dp1(jparams, batch):
    """A dp = 1 mesh against no mesh: two steps and a forward with dropout
    on the D route, from the same generator seed."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(1)
    out = {}
    for name, dp_mesh in (("mesh", mesh), ("none", None)):
        _route("xla")
        tp = tw.from_jax_params(jparams, device="cpu")
        x, y, m = _tensors(batch)
        tx = topt.adam(1e-4, grad_clip=3.0)
        ts = tx.init(tp)
        losses = []
        for _ in range(2):
            tp, ts, (loss, _) = tpre.agent_train_step(tp, ts, CFG, tx, x, y, m, None,
                                                      dp_mesh=dp_mesh)
            losses.append(float(loss))
        _route("kernels")
        cfg = dataclasses.replace(CFG, dropout=0.1)
        g = torch.Generator().manual_seed(11)
        h = tlt.forward_hidden(tp, cfg, x, deterministic=False, generator=g, dp_mesh=dp_mesh)
        out[name] = {"losses": losses, "params": flat(tp), "h": h.detach().numpy()}
    return out
