"""Rank functions for tests/test_torch_sequence_parallel.py and
tests/test_torch_pipeline_parallel.py.

``parallel.launch`` starts each rank in a fresh interpreter that imports
this module by name, so it imports only torch, numpy and the port (and the
helpers of tests/torch_dp_workers.py, which import no jax either): never
jax, the JAX package or tests/conftest.py.  Each function runs on every
rank of a gloo group on the CPU, on one intra-op thread, and returns numpy
arrays and plain values; trees of shards come back whole
(``parallel.gather_params``), so the tests hold them against the JAX
package and against one process.

Pipeline configs of JAX's tests/test_pipeline_parallel.py (vocab (56, 135,
18, 87, 18, 25), embeddings 16, d_model 64, 4 layers, 4 heads, FFN 128;
and its 2-layer d_model 32 one for the grad step and the loop), dropout 0.
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
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_torch.ops import linear_attention as tla
from reinforcement_learning_in_music_generation_torch.ops import linear_attention_kernel as tlk
from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
from reinforcement_learning_in_music_generation_torch.parallel import pipeline as ppl
from reinforcement_learning_in_music_generation_torch.parallel import sharding as psh
from reinforcement_learning_in_music_generation_torch.parallel import tensor as ptn
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre

KW = dict(vocab_sizes=(56, 135, 18, 87, 18, 25), emb_sizes=(16,) * 6, d_model=64, n_layer=4,
          n_head=4, d_inner=128, dropout=0.0)
CFG = TC.LinearTransformerConfig(**KW)
SMALL_KW = dict(vocab_sizes=(8,) * 6, emb_sizes=(8,) * 6, d_model=32, n_layer=2, n_head=2,
                d_inner=64, dropout=0.0)
SMALL = TC.LinearTransformerConfig(**SMALL_KW)
CLIP = 0.1              # below the first gradient's norm: the clip engages
ROUTES = {"xla": {"RLMG_FFN_BACKEND": "xla", "RLMG_ATTN_BACKEND": "xla"},
          "d": {"RLMG_FFN_BACKEND": "pallas-tail", "RLMG_ATTN_BACKEND": "xla"},
          "g": {"RLMG_FFN_BACKEND": "pallas", "RLMG_ATTN_BACKEND": "xla"}}


def _header(mesh):
    return {"rank": mesh.rank, "index": {a: mesh.index(a) for a in mesh.shape},
            "modules": sorted(m for m in sys.modules if m.split(".")[0] in
                              ("jax", "reinforcement_learning_in_music_generation_tpu",
                               "conftest"))}


# -- sequence parallelism ------------------------------------------------------

class _OwnSlot(torch.autograd.Function):
    """The control of the gather's backward: each rank keeps its own slot of
    the cotangent, without the sum over the ranks."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.i = mesh.index(axis)
        parts = [torch.empty_like(x) for _ in range(mesh.size(axis))]
        torch.distributed.all_gather(parts, x.contiguous(), group=mesh.group(axis))
        return torch.stack(parts)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.i], None, None


def _sp_call(mesh, q, k, v, chunk, backend):
    """The rank's shard of q, k, v through causal_linear_attention_sp; out
    and the cotangents of sum(out^2)'s gradient on the shard."""
    n, i = mesh.size("sp"), mesh.index("sp")
    s = q.shape[2] // n
    parts = [torch.from_numpy(t[:, :, i * s:(i + 1) * s]).requires_grad_(True)
             for t in (q, k, v)]
    out = tla.causal_linear_attention_sp(*parts, mesh, "sp", chunk=chunk, backend=backend)
    (out ** 2).sum().backward()
    return {"out": out.detach(), "grads": [p.grad for p in parts]}


def sp(q, k, v, chunk):
    """On each rank of an sp mesh over the world: the sp call on the chunked
    core and on kernel F's route (its plain twin here, counted), then the
    two controls on the chunked core: an inclusive prefix, and a gather
    whose backward keeps the rank's own slot."""
    torch.set_num_threads(1)
    mesh = pm.named_mesh({"sp": torch.distributed.get_world_size()})
    out = _header(mesh)
    out["xla"] = _sp_call(mesh, q, k, v, chunk, "xla")
    with DW._Counted(tlk, "_plain_fwd") as f, DW._Counted(tlk, "_plain_bwd") as b:
        out["pallas"] = _sp_call(mesh, q, k, v, chunk, "pallas")
    out["pallas"]["calls"] = (f.calls, b.calls)
    keep = tla.prefix_weights
    tla.prefix_weights = lambda n, idx, dtype, device: (
        torch.arange(n, device=device) <= idx).to(dtype)
    try:
        out["inclusive_prefix"] = _sp_call(mesh, q, k, v, chunk, "xla")
    finally:
        tla.prefix_weights = keep
    keep = ptn.gather_over
    ptn.gather_over = lambda x, mesh_, axis: _OwnSlot.apply(x, mesh_, axis)
    try:
        out["no_reduce_scatter"] = _sp_call(mesh, q, k, v, chunk, "xla")
    finally:
        ptn.gather_over = keep
    return out


# -- pipeline parallelism ------------------------------------------------------

def gathered(mesh, tree):
    return DW.flat(psh.gather_params(mesh, tree))


def _local(mesh, jparams):
    """This rank's shards of the JAX weights (rank 0's broadcast)."""
    return ppl.shard_params_pp(mesh, tw.from_jax_params(jparams, device="cpu"))


def _tensors(batch):
    x, y, m = batch
    return torch.from_numpy(x).long(), torch.from_numpy(y).long(), torch.from_numpy(m).float()


def _route(name):
    os.environ.update(ROUTES[name])


def _step(mesh, jparams, batch, cfg=CFG, route="xla"):
    """The pipeline's forward (h of the whole batch), its loss and gradient,
    the clipped gradient and one Adam step; the plain twins' calls of D and
    G in the gradient step."""
    _route(route)
    p = _local(mesh, jparams)
    x, y, m = _tensors(batch)
    h = ppl.pipeline_forward_hidden(p, cfg, x, mesh)
    with DW._Counted(tfb, "attn_tail_block_plain") as d, \
            DW._Counted(tfb, "ffn_block_plain") as g:
        grads, (loss, fields) = tpre.agent_pp_grad_step(p, cfg, x, y, m, None, mesh=mesh)
    tx = topt.adam(1e-4, grad_clip=CLIP)
    p1, st, (loss1, _) = tpre.agent_pp_train_step(p, tx.init(p), cfg, tx, x, y, m, None,
                                                  mesh=mesh)
    out = {"h": h.numpy(), "loss": float(loss), "fields": fields.numpy().copy(),
           "grads": gathered(mesh, grads), "norm": float(topt.global_norm(grads, mesh)),
           "clipped": gathered(mesh, tx.clip(grads, mesh)), "params": gathered(mesh, p1),
           "calls": {"D": d.calls, "G": g.calls}, "loss1": float(loss1)}
    # the controls: every stage's head gradient summed (the heads' and
    # final_ln's gradients counted pp times), and the clip by the rank's own
    # norm
    twice = {k: v * (mesh.pp if k.startswith(("/heads", "/final_ln")) else 1)
             for k, v in out["grads"].items()}
    out["controls"] = {"double_counted_heads": twice,
                       "local_norm": gathered(mesh, tx.clip(grads))}
    return out


def _dropout_masks(mesh, jparams):
    """Dropout 0.5 on a batch of one row repeated: the last stage's hidden
    states, which differ between microbatches only by their masks."""
    _route("xla")
    cfg = dataclasses.replace(CFG, dropout=0.5)
    p = _local(mesh, jparams)
    x = torch.randint(0, 8, (1, 16, 6), generator=torch.Generator().manual_seed(2))
    x = x.repeat(8, 1, 1)
    gen = torch.Generator().manual_seed(3 + 7919 * mesh.dp_index)
    with torch.no_grad():
        h, _ = ppl._schedule(p, cfg, x, mesh, 4, gen, False)
    return None if h is None else h.numpy()


def _mkcfg(tmp, tag, **kw):
    return TC.PretrainConfig(**{"batch_size": 4, "lr": 1e-3,
                                "exp_dir": os.path.join(tmp, tag, "exp"),
                                "ckpt_dir": os.path.join(tmp, tag, "ckpt"), **kw})


def _loop(mesh, jparams_small, data, pcfg):
    p = tw.from_jax_params(jparams_small, device="cpu")
    p, _, hist = tpre.pretrain(p, SMALL, *data, pcfg, mesh=mesh)
    return {"history": hist, "params": gathered(mesh, p)}


def pp2(jparams, batch, jparams_small, small_batch, data, tmp):
    """Every dp = 1 x pp = 2 scenario on this rank: the step on the plain
    route and on kernels D's and G's, the grad step on halves, the loop
    with and without gradient accumulation and its checkpoint."""
    torch.set_num_threads(1)
    mesh = ppl.make_pp_mesh(2)
    out = _header(mesh)
    out["shapes"] = {k: v.shape for k, v in DW.flat(_local(mesh, jparams)).items()}
    for route in ("xla", "d", "g"):
        out[route] = _step(mesh, jparams, batch, route=route)
    _route("xla")
    # JAX :238-262: two half batches at scale 0.5 sum to the whole batch's
    p = _local(mesh, jparams_small)
    x, y, m = _tensors(small_batch)
    full, _ = tpre.agent_pp_grad_step(p, SMALL, x, y, m, None, mesh=mesh)
    g1, _ = tpre.agent_pp_grad_step(p, SMALL, x[:2], y[:2], m[:2], None, mesh=mesh, scale=0.5)
    g2, _ = tpre.agent_pp_grad_step(p, SMALL, x[2:], y[2:], m[2:], None, mesh=mesh, scale=0.5)
    out["halves"] = {"full": gathered(mesh, full),
                     "sum": gathered(mesh, topt.tree_map(torch.add, g1, g2))}
    out["loop"] = _loop(mesh, jparams_small, data, _mkcfg(tmp, "loop", n_epoch=2))
    torch.distributed.barrier()
    out["ckpt"] = sorted(glob.glob(os.path.join(tmp, "loop", "ckpt", "*.ckpt")))
    accum = _loop(mesh, jparams_small, data, _mkcfg(tmp, "accum", n_epoch=2, batch_size=2,
                                                     grad_accum=2))
    out["accum"] = accum
    return out


def dp2pp2(jparams, batch, jparams_small, data, tmp):
    """dp = 2 x pp = 2: the step and the loop."""
    torch.set_num_threads(1)
    mesh = ppl.make_pp_mesh(2, dp=2)
    out = _header(mesh)
    out["xla"] = _step(mesh, jparams, batch)
    out["loop"] = _loop(mesh, jparams_small, data, _mkcfg(tmp, "loop", n_epoch=2))
    return out


def pp2tp2(jparams, batch):
    """dp = 1 x pp = 2 x tp = 2: the step (the Megatron stage layer), and
    the dropout masks of one stage's tp ranks."""
    torch.set_num_threads(1)
    mesh = ppl.make_pp_mesh(2, tp=2)
    out = _header(mesh)
    out["xla"] = _step(mesh, jparams, batch)
    out["masks"] = _dropout_masks(mesh, jparams)
    return out


def dp2pp2tp2(jparams, batch):
    """dp = 2 x pp = 2 x tp = 2 (eight ranks): the step."""
    torch.set_num_threads(1)
    mesh = ppl.make_pp_mesh(2, dp=2, tp=2)
    out = _header(mesh)
    out["xla"] = _step(mesh, jparams, batch)
    return out
