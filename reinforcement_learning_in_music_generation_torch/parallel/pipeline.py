"""GPipe pipeline parallelism over the stacked layer axis: the counterpart of
the JAX package's ``parallel/pipeline.py`` (``make_pp_mesh``,
``shard_params_pp``, ``pipeline_forward_hidden``, ``pipeline_train_losses``,
``pipeline_train_step``, ``pipeline_grad_step``).

The mesh is (dp, pp, tp) (``parallel/mesh.py make_pp_mesh``), one process a
rank.  Each of the pp stages holds a contiguous L/pp slab of every
``['layers']`` leaf (``parallel/sharding.py``: ``shard_params_pp`` is
``shard_params`` on such a mesh); the embeddings, ``in_linear``,
``final_ln`` and the heads are whole on every stage, each with its tp
slice.  The callers pass the global batch, as to JAX's functions; each rank
keeps its dp index's rows, split into ``m`` microbatches.

The forward: stage 0 embeds, projects, adds the positional table and
applies the input dropout to its rows, then for each microbatch in turn runs
its layers on it and sends the activation to stage 1; every later stage
receives each microbatch from the stage before it, runs its layers and
sends the result on; the last stage keeps its outputs and, once all have
come, applies ``final_ln``, the heads and the masked CE over its dp index's
rows (``ops/losses.py``: the global loss's share).  The stage's layer is
``models/linear_transformer._layer_forward`` with attention "xla" and, under
tp > 1, the Megatron composition (JAX ``_layer_forward_tp``: one all-reduce
after ``wo`` and one after ``ffn2``).  Its FFN route follows JAX's stage,
which passes no mesh: the composition unless RLMG_FFN_BACKEND asks for
"pallas-tail" (kernel D) or "pallas" (kernel G) on the stage's microbatch,
with no row-count default; under tp > 1 the fused routes stay off, with
``_ffn_backend``'s warning.

The backward is an explicit GPipe schedule (JAX gets it from ``ppermute``'s
transpose): the microbatches in reverse order; on the last stage the
cotangents of its outputs come from one backward through the heads, on the
others each is received from the stage after; each stage runs
``torch.autograd.backward`` on the microbatch's kept output and sends its
input's gradient to the stage before; stage 0 finally runs the embedding's
backward on all its rows.  Every rank makes its sends and receives in the
same order as its neighbours, outside autograd, so no two ranks wait on
each other.  Gradients: a stage holds its slab's; the replicated leaves
get theirs on one stage (the heads and ``final_ln`` on the last, the
embeddings and ``in_linear`` on the first) and zeros on the others, and a
sum over the pp group gives every stage the one-process gradient (the heads
run once, so their gradient is counted once); then the gradients and the
losses are summed over the dp group, the ranks of the same stage and tp
index.  The clip's norm sums the slabs' squares over pp and counts the
replicated leaves once (``train/optim.py global_norm``).

The hop's transport follows the mesh's backend: under NCCL one
``batch_isend_irecv`` a send or a receive, on the card; under gloo, whose
send and receive take host memory only (a CUDA tensor's send kills the
sending process, ``parallel/mesh.py``), a host copy (bf16 carried as its
int16 bits).

Dropout: every draw comes from the caller's generator, in the order the
rank runs its microbatches, so masks differ between microbatches; the
caller seeds it per dp index and stage (``train/pretrain.py``), alike on the
ranks of one stage's tp group, whose activations stay equal.  The fused
kernels' seeds are drawn from it too, plus 7919 x dp index (JAX's rule).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import LinearTransformerConfig
from ..models import common as cm
from ..models import linear_transformer as lt
from ..ops.losses import fields_cross_entropy
from ..train import optim
from .mesh import Mesh, all_gather, all_reduce_, make_pp_mesh, shard_rows
from .sharding import layouts, shard_params

__all__ = ["make_pp_mesh", "shard_params_pp", "pipeline_forward_hidden",
           "pipeline_train_losses", "pipeline_train_step", "pipeline_grad_step"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def shard_params_pp(mesh: Mesh, params: dict) -> dict:
    """Rank 0's parameters, then this rank's stage slab and tp slices (JAX
    ``shard_params_pp``; ``parallel/sharding.py shard_params``)."""
    return shard_params(mesh, params)


def n_microbatches(cfg: LinearTransformerConfig, mesh: Mesh, batch: int,
                   n_microbatch: Optional[int] = None) -> int:
    """The microbatch count for a global batch of ``batch`` rows (default
    min(2 pp, batch // dp), JAX's), after JAX's checks: ``ValueError``
    unless pp divides the layers, tp the heads and d_inner (and the other
    Megatron dimensions, ``lt.check_tp``) and dp x m the batch."""
    pp, dp, tp = mesh.pp, mesh.dp, mesh.tp
    if cfg.n_layer % pp != 0:
        raise ValueError(f"n_layer={cfg.n_layer} not divisible by pp={pp}")
    if cfg.n_head % tp != 0 or cfg.d_inner % tp != 0:
        raise ValueError(f"tp={tp} must divide n_head={cfg.n_head} and d_inner={cfg.d_inner} "
                         "(Megatron column shards)")
    lt.check_tp(cfg, tp)
    m = n_microbatch or min(2 * pp, batch // dp)
    if m < 1 or batch % (dp * m) != 0:
        raise ValueError(f"batch {batch} not divisible by dp*m={dp}*{m}")
    return m


class _Hops:
    """The activation hops of one schedule between this rank and the
    same-index ranks of the neighbouring stages.  Sends are asynchronous
    and held until ``wait``; receives block."""

    def __init__(self, mesh: Mesh):
        self.mesh, self.pending = mesh, []

    def send(self, t: torch.Tensor, stage: int) -> None:
        dst = self.mesh.rank_at("pp", stage)
        if self.mesh.backend == "nccl":
            buf = t.detach().contiguous()
            self.pending.append((dist.batch_isend_irecv([dist.P2POp(dist.isend, buf, dst)]),
                                 buf))
        else:
            buf = t.detach().to("cpu", copy=True).contiguous()
            if buf.dtype == torch.bfloat16:
                buf = buf.view(torch.int16)
            self.pending.append(([dist.isend(buf, dst)], buf))

    def recv(self, shape, dtype: torch.dtype, stage: int) -> torch.Tensor:
        src = self.mesh.rank_at("pp", stage)
        if self.mesh.backend == "nccl":
            buf = torch.empty(shape, dtype=dtype, device=self.mesh.device)
            for w in dist.batch_isend_irecv([dist.P2POp(dist.irecv, buf, src)]):
                w.wait()
            return buf
        wire = torch.int16 if dtype == torch.bfloat16 else dtype
        buf = torch.empty(shape, dtype=wire)
        dist.recv(buf, src)
        return buf.view(dtype).to(self.mesh.device)

    def wait(self) -> None:
        for works, _ in self.pending:
            for w in works:
                w.wait()
        self.pending.clear()


def _stage_layers(cfg: LinearTransformerConfig, h: torch.Tensor, layers: dict,
                  generator: Optional[torch.Generator], deterministic: bool,
                  mesh: Mesh) -> torch.Tensor:
    """The stage's L/pp layers on one microbatch (JAX ``stage_fn``)."""
    layer = lt._remat_layer if cfg.remat and torch.is_grad_enabled() else lt._layer_forward
    for l in range(cfg.n_layer // mesh.pp):
        lp = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in layers.items()}
        h = layer(cfg, h, lp, generator, deterministic, "xla", mesh, (0, 1), False)
    return h


def _schedule(params: dict, cfg: LinearTransformerConfig, x: torch.Tensor, mesh: Mesh, m: int,
              generator: Optional[torch.Generator], deterministic: bool,
              target: Optional[tuple] = None, backward: bool = False):
    """One pass of the pipeline over this rank's rows of the global batch
    ``x`` -> (h, losses): on the last stage h = final_ln of its outputs
    (the rank's rows, in order) and, with ``target`` = (y, mask), the
    rank's share of the per-field losses; None elsewhere.  ``backward``:
    then the GPipe backward of the losses' mean, which leaves each leaf's
    gradient in its ``.grad`` (``params``' leaves require grad)."""
    deterministic = deterministic or generator is None
    stage, pp = mesh.pp_index, mesh.pp
    last = stage == pp - 1
    rows = shard_rows(mesh, x.shape[0])
    xr = x[rows]
    mb = xr.shape[0] // m
    shape = (mb, x.shape[1], cfg.d_model)
    dtype = params["in_linear"]["w"].dtype
    hops = _Hops(mesh)
    h0 = h_in = None
    if stage == 0:
        h0 = lt.embed_project(params, xr, mesh)
        h0 = h0 + cm.sinusoidal_table(x.shape[1], cfg.d_model, h0.dtype, h0.device)[None]
        h0 = cm.dropout(generator, h0, cfg.dropout, deterministic)
        h_in = h0.detach().requires_grad_(backward)
    kept = []
    for i in range(m):
        if stage == 0:
            x_in = h_in[i * mb:(i + 1) * mb]
        else:
            x_in = hops.recv(shape, dtype, stage - 1).requires_grad_(backward)
        y = _stage_layers(cfg, x_in, params["layers"], generator, deterministic, mesh)
        if not last:
            hops.send(y, stage + 1)
        kept.append((x_in, y))
    h = losses = outs = None
    if last:
        outs = [y.detach().requires_grad_(backward) for _, y in kept]
        h = cm.layernorm(params["final_ln"], torch.cat(outs))
        if target is not None:
            y_t, mask = (t[rows] for t in target)
            losses = fields_cross_entropy(lt.forward_output(params, cfg, h, mesh), y_t, mask,
                                          mesh=mesh)
            if backward:
                losses.mean().backward()
    if backward:
        for i in reversed(range(m)):
            x_in, y = kept[i]
            g = outs[i].grad if last else hops.recv(shape, y.dtype, stage + 1)
            torch.autograd.backward(y, g)
            if stage > 0:
                hops.send(x_in.grad, stage - 1)
            kept[i] = None
        if stage == 0:
            torch.autograd.backward(h0, h_in.grad)
    hops.wait()
    return h, losses


@torch.no_grad()
def pipeline_forward_hidden(params: dict, cfg: LinearTransformerConfig, x: torch.Tensor,
                            mesh: Mesh, *, n_microbatch: Optional[int] = None,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``forward_hidden`` through the pipeline (forward only): x (B, S,
    n_fields) int, the global batch, -> h (B, S, D) after ``final_ln``, the
    whole batch's on every rank (the last stage's outputs summed over pp
    with the other stages' zeros, as JAX's psum, then gathered over dp).
    ``params``: the rank's shards (``shard_params_pp``)."""
    m = n_microbatches(cfg, mesh, x.shape[0], n_microbatch)
    h, _ = _schedule(params, cfg, x, mesh, m, generator, deterministic)
    dtype = params["final_ln"]["scale"].dtype
    if h is None:
        rows = shard_rows(mesh, x.shape[0])
        h = torch.zeros((rows.stop - rows.start, x.shape[1], cfg.d_model), device=mesh.device)
    h = h.float()                       # gloo is not asked to carry bf16
    all_reduce_(mesh, [h], axis="pp")
    return torch.cat(all_gather(mesh, h, axis="dp")).to(dtype)


def _losses_and_grads(params: dict, cfg: LinearTransformerConfig, x, y, mask, mesh: Mesh,
                      m: int, generator, deterministic: bool, backward: bool):
    """(grads tree or None, loss, per-field losses): the schedule on
    detached leaves of ``params`` (cast to cfg.dtype for the compute), the
    replicated leaves' gradients and the losses summed over pp, then every
    gradient and the losses over dp; every rank ends with the global loss
    and its shards' gradients."""
    leaves = [t.detach().requires_grad_(backward) for t in optim.tree_leaves(params)]
    p = optim.tree_unflatten(params, leaves)
    if cfg.dtype != "float32":
        p = lt.cast_params(p, _DTYPES[cfg.dtype])
    with torch.set_grad_enabled(backward):
        _, losses = _schedule(p, cfg, x, mesh, m, generator, deterministic, (y, mask),
                              backward)
    if losses is None:
        losses = torch.zeros(len(cfg.vocab_sizes), device=mesh.device)
    losses = losses.detach().float()
    grads = None
    if backward:
        grads = [torch.zeros_like(t) if t.grad is None else t.grad.to(t.dtype) for t in leaves]
        whole = [g for g, (_, slab) in zip(grads, layouts(mesh, params)) if not slab]
        all_reduce_(mesh, whole + [losses], axis="pp")
        all_reduce_(mesh, grads + [losses], axis="dp")
        grads = optim.tree_unflatten(params, grads)
    else:
        all_reduce_(mesh, [losses], axis="pp")
        all_reduce_(mesh, [losses], axis="dp")
    return grads, losses.mean(), losses


def pipeline_train_losses(params: dict, cfg: LinearTransformerConfig, x, target, mask,
                          mesh: Mesh, *, n_microbatch: Optional[int] = None,
                          deterministic: bool = False,
                          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """The per-field masked CE (n_fields,) of the global batch through the
    pipeline, on every rank (forward only; ``pipeline_grad_step`` runs the
    backward)."""
    m = n_microbatches(cfg, mesh, x.shape[0], n_microbatch)
    _, _, losses = _losses_and_grads(params, cfg, x, target, mask, mesh, m, generator,
                                     deterministic, backward=False)
    return losses


def pipeline_grad_step(params: dict, cfg: LinearTransformerConfig, x, y, mask,
                       generator: Optional[torch.Generator], mesh: Mesh,
                       n_microbatch: Optional[int] = None, scale: float = 1.0):
    """Gradients and loss of the global batch through the GPipe schedule,
    no optimizer (JAX ``pipeline_grad_step``, the unit of gradient
    accumulation on a pipeline mesh) -> (grads of the rank's shards, (loss,
    per-field losses)); ``scale`` multiplies the gradients."""
    m = n_microbatches(cfg, mesh, x.shape[0], n_microbatch)
    grads, loss, losses = _losses_and_grads(params, cfg, x, y, mask, mesh, m, generator,
                                            False, backward=True)
    if scale != 1.0:
        grads = optim.tree_map(lambda g: g * scale, grads)
    return grads, (loss, losses)


def pipeline_train_step(params: dict, opt_state, cfg: LinearTransformerConfig, tx, x, y, mask,
                        generator: Optional[torch.Generator], mesh: Mesh,
                        n_microbatch: Optional[int] = None) -> Tuple[dict, object, tuple]:
    """One Adam step through the pipeline (JAX ``pipeline_train_step``,
    ``train/pretrain.py agent_train_step``'s loss): the rank's shards of
    ``params`` and ``opt_state`` updated in place -> (params, opt_state,
    (loss, per-field losses)); the clip's norm is the whole gradient's."""
    grads, out = pipeline_grad_step(params, cfg, x, y, mask, generator, mesh, n_microbatch)
    updates, opt_state = tx.update(grads, opt_state, params, mesh=mesh)
    return optim.apply_updates(params, updates), opt_state, out
