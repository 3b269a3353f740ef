"""Rank functions for tests/test_torch_tensor_parallel.py.

``parallel.launch`` starts each rank in a fresh interpreter that imports
this module by name, so it imports only torch, numpy and the port (and the
helpers of tests/torch_dp_workers.py, which import no jax either): never
jax, the JAX package or tests/conftest.py.  Each function runs on every
rank of a gloo group on the CPU, on one intra-op thread, and returns numpy
arrays and plain values; trees of tp shards come back whole
(``parallel.gather_params``), so the test holds them against the JAX
package's mesh and against one process.

Small config of tests/test_torch_parallel.py (d_model 32, 2 layers, 2
heads, FFN 64, embeddings 8, dropout 0); generation at JAX's TINY
(tests/test_sharded_generation.py: d_model 16, 1 layer, 2 heads, FFN 32).
"""

import dataclasses
import glob
import os
import sys

import torch
import torch.distributed

import torch_dp_workers as DW
from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import attention_block as tab
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_torch.ops import linear_attention_kernel as tlk
from reinforcement_learning_in_music_generation_torch.ops import losses as tlo
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre

CFG = DW.CFG
TINY = TC.LinearTransformerConfig(vocab_sizes=(8,) * 6, emb_sizes=(8,) * 6, d_model=16,
                                  n_layer=1, n_head=2, d_inner=32)
CLIP = 0.1              # below the first step's gradient norm: the clip engages
ROUTES = {"xla": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"},
          "f": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "pallas"}}


def _route(name):
    os.environ.update(ROUTES[name])


def gathered(mesh, tree):
    return DW.flat(psh.gather_params(mesh, tree))


def _local(mesh, jparams):
    """This rank's shards of the JAX weights (rank 0's broadcast)."""
    return psh.shard_params(mesh, tw.from_jax_params(jparams, device="cpu"))


def _steps(mesh, jparams, batch, route):
    """The first gradient (whole and clipped), its global norm, and one
    agent_train_step on this rank's rows and shards; the plain twins' calls
    of C, D, G and F in the gradient step."""
    _route(route)
    p = _local(mesh, jparams)
    x, y, m = DW._tensors(pm.shard_batch(mesh, batch))
    with DW._Counted(tab, "qkv_attention_block_plain") as c, \
            DW._Counted(tfb, "attn_tail_block_plain") as d, \
            DW._Counted(tfb, "ffn_block_plain") as g, \
            DW._Counted(tlk, "causal_product_plain") as f:
        grads, (loss0, fields0) = tpre.agent_grad_step(p, CFG, x, y, m, None, dp_mesh=mesh)
    tx = topt.adam(1e-4, grad_clip=CLIP)
    norm = float(topt.global_norm(grads, mesh))
    clipped = tx.clip(grads, mesh)
    p1, st, (loss1, _) = tpre.agent_train_step(p, tx.init(p), CFG, tx, x, y, m, None,
                                               dp_mesh=mesh)
    return {"rows": int(x.shape[0]), "loss0": float(loss0), "fields0": fields0.numpy().copy(),
            "grads": gathered(mesh, grads), "clipped": gathered(mesh, clipped), "norm": norm,
            "params": gathered(mesh, p1), "mu": gathered(mesh, st.mu),
            "calls": {"C": c.calls, "D": d.calls, "G": g.calls, "F": f.calls}}


def _controls(mesh, jparams, batch):
    """The three faults the gates must catch, each on the plain route: the
    mask sum all-reduced over the world (each dp shard counted tp times),
    the clip by each rank's local norm, and torch.distributed.nn's
    all_reduce in place of reduce_from_tp (its backward sums the replicated
    gradient again)."""
    import torch.distributed.nn.functional as dnf
    _route("xla")
    p = _local(mesh, jparams)
    x, y, m = DW._tensors(pm.shard_batch(mesh, batch))
    out = {}
    keep = tlo._mask_sum

    def world_sum(mask, mesh_):
        den = mask.float().sum().detach()
        pm.all_reduce_(mesh_, [den], axis="world")
        return den
    tlo._mask_sum = world_sum
    try:
        grads, (loss, _) = tpre.agent_grad_step(p, CFG, x, y, m, None, dp_mesh=mesh)
    finally:
        tlo._mask_sum = keep
    out["world_mask_sum"] = {"loss0": float(loss), "grads": gathered(mesh, grads)}
    grads, _ = tpre.agent_grad_step(p, CFG, x, y, m, None, dp_mesh=mesh)
    tx = topt.adam(1e-4, grad_clip=CLIP)
    out["local_clip"] = {"clipped": gathered(mesh, tx.clip(grads)),
                         "norms": pm.all_gather_object(mesh, float(topt.global_norm(grads)),
                                                       axis="world")}
    keep = tlt.reduce_from_tp
    tlt.reduce_from_tp = lambda t, mesh_: dnf.all_reduce(t, group=mesh_.group("tp"))
    try:
        grads, (loss, _) = tpre.agent_grad_step(p, CFG, x, y, m, None, dp_mesh=mesh)
    finally:
        tlt.reduce_from_tp = keep
    out["dist_nn_all_reduce"] = {"loss0": float(loss), "grads": gathered(mesh, grads)}
    return out


def _shapes(mesh, jparams):
    return {k: v.shape for k, v in DW.flat(_local(mesh, jparams)).items()}


def _generate(mesh, tiny_jparams, prompt, b):
    """Greedy songs from the CP seed and from ``prompt``'s first 5 rows (the
    per-token steps); with dp = 1 also a stochastic run from all of
    ``prompt`` (20 rows: the parallel prefill)."""
    p = tw.from_jax_params(tiny_jparams, device="cpu")
    gcfg = TC.GenerateConfig(batch_size=b, max_tokens=12, bar_production=10 ** 9, greedy=True)
    out = {"greedy": tsam.generate_songs(p, TINY, gcfg, mesh=mesh),
           "prompt": tsam.generate_songs(p, TINY, gcfg, init=prompt[:5], mesh=mesh)}
    if mesh.dp == 1:
        stoch = dataclasses.replace(gcfg, greedy=False, seed=3)
        out["stochastic_prefill"] = tsam.generate_songs(p, TINY, stoch, init=prompt, mesh=mesh)
    return out


def _mkcfg(tmp, tag, **kw):
    return TC.PretrainConfig(**{"batch_size": 8, "exp_dir": os.path.join(tmp, tag, "exp"),
                                "ckpt_dir": os.path.join(tmp, tag, "ckpt"), **kw})


def _run(mesh, jparams, data, pcfg, max_steps=None, resume=None, cfg=CFG):
    p = tw.from_jax_params(jparams, device="cpu")
    p, st, hist = tpre.pretrain(p, cfg, *data, pcfg, mesh=mesh, max_steps=max_steps,
                                resume_from=resume)
    return p, st, hist


def _header(mesh):
    return {"rank": mesh.rank, "dp_index": mesh.dp_index, "tp_index": mesh.tp_index,
            "modules": sorted(m for m in sys.modules if m.split(".")[0] in
                              ("jax", "reinforcement_learning_in_music_generation_tpu",
                               "conftest"))}


def tp2(jparams, batch, data, tiny_jparams, prompt, ckpt_tp1, tmp):
    """Every dp = 1 x tp = 2 scenario of the test file on this rank."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(1, 2)
    out = _header(mesh)
    out["shapes"] = _shapes(mesh, jparams)
    out["xla"] = _steps(mesh, jparams, batch, "xla")
    out["f"] = _steps(mesh, jparams, batch, "f")
    _route("xla")
    # remat: the same step (dropout 0.1, the same generator seed) with and
    # without torch.utils.checkpoint around each layer
    x, y, m = DW._tensors(batch)
    rem = {}
    for flag in (False, True):
        cfg = dataclasses.replace(CFG, dropout=0.1, remat=flag)
        g = torch.Generator().manual_seed(5)
        grads, (loss, _) = tpre.agent_grad_step(_local(mesh, jparams), cfg, x, y, m, g,
                                                dp_mesh=mesh)
        rem[flag] = {"loss": float(loss), "grads": gathered(mesh, grads)}
    out["remat"] = rem
    # dropout 0.1: the forward and the loss of one generator seed
    cfg = dataclasses.replace(CFG, dropout=0.1)
    g = torch.Generator().manual_seed(11)
    h = tlt.forward_hidden(_local(mesh, jparams), cfg, x, deterministic=False, generator=g,
                           dp_mesh=mesh)
    g = torch.Generator().manual_seed(11)
    _, (loss, _) = tpre.agent_grad_step(_local(mesh, jparams), cfg, x, y, m, g, dp_mesh=mesh)
    out["dropout"] = {"h": h.detach().numpy(), "loss": float(loss)}
    # checkpoints: one epoch at tp = 2 (rank 0 writes the whole tree), and a
    # resume at tp = 2 from a checkpoint one process wrote
    two = tuple(a[:16] for a in data)
    p1, _, h1 = _run(mesh, jparams, two, _mkcfg(tmp, "tp2", n_epoch=1))
    torch.distributed.barrier()
    paths = sorted(glob.glob(os.path.join(tmp, "tp2", "ckpt", "*.ckpt")))
    p_res, _, h_res = _run(mesh, jparams, two, _mkcfg(tmp, "res", n_epoch=2), resume=ckpt_tp1)
    p_str, _, h_str = _run(mesh, jparams, two, _mkcfg(tmp, "str", n_epoch=2))
    out["ckpt"] = {"paths": paths, "params": gathered(mesh, p1), "history": h1,
                   "resumed": gathered(mesh, p_res), "resumed_history": h_res,
                   "straight": gathered(mesh, p_str), "straight_history": h_str}
    out["generate"] = _generate(mesh, tiny_jparams, prompt, 4)
    return out


def dp2tp2(jparams, batch, data, tiny_jparams, prompt, tmp):
    """Every dp = 2 x tp = 2 scenario of the test file on this rank."""
    torch.set_num_threads(1)
    mesh = pm.make_mesh(2, 2)
    out = _header(mesh)
    out["shapes"] = _shapes(mesh, jparams)
    out["xla"] = _steps(mesh, jparams, batch, "xla")
    out["f"] = _steps(mesh, jparams, batch, "f")
    out["controls"] = _controls(mesh, jparams, batch)
    _route("xla")
    # the loop, two epochs of 8-row batches, against JAX's loop on (2, 2)
    p, _, hist = _run(mesh, jparams, data, _mkcfg(tmp, "loop", n_epoch=2, grad_clip=CLIP))
    out["loop"] = {"history": hist, "params": gathered(mesh, p)}
    # ZeRO-1 against plain Adam on the same mesh, three steps
    p_plain, _, _ = _run(mesh, jparams, data, _mkcfg(tmp, "plain"), max_steps=3)
    p_zero, s_zero, _ = _run(mesh, jparams, data, _mkcfg(tmp, "zero1", zero1=True), max_steps=3)
    out["zero1"] = {"plain": gathered(mesh, p_plain), "zero1": gathered(mesh, p_zero),
                    "mu_ffn1": tuple(s_zero.mu["layers"]["ffn1"]["w"].shape)}
    out["generate"] = _generate(mesh, tiny_jparams, prompt, 8)
    return out
