"""Pretraining: the counterpart of the JAX package's ``train/pretrain.py``
(``agent_train_step``, ``agent_grad_step``, ``agent_pp_train_step``,
``agent_pp_grad_step``, ``longformer_lm_step``, ``longformer_grad_step``,
``apply_grads``, ``pretrain``).

Agent step: loss = mean of the six masked field CEs, Adam lr 1e-4 with
global-norm clipping at 3 (dqn_policy/agent_pretrain.py:516,557-565).
With ``cfg.dtype == "bfloat16"`` the step is mixed precision: float32
master weights in the optimizer, compute in bfloat16 (the CE reduces in
float32).  Discriminator-LM step: the per-field masked CE of the
window transformer's token logits (dqn_policy/discrim-pretrain.py:342-490).
The loop keeps the JAX loop's behaviour for either step: epochs,
``log_every``, ``max_steps``, gradient accumulation, loss-bucketed
checkpoints and early stop at loss <= 0.05 (agent_pretrain.py:594-632),
``save_on_interrupt`` and ``resume_from`` (in the port's checkpoint
format).

Runs on one device, or on each rank of a (dp, tp) mesh
(``parallel/mesh.py``): every step takes ``dp_mesh``, with which the loss is
the global masked CE and the gradients (with the loss values) are
all-reduced (SUM) over the dp group before clipping and Adam, so every rank
clips the global gradient by its global norm, as under JAX's GSPMD.  Under
tp the parameters are the rank's tp shards: a split leaf's gradient is its
shard's, a whole leaf's is already equal on the tp ranks, and the clip's
norm sums the shards' over the tp group (``optim.global_norm``).  The
Longformer LM step has no tensor-parallel layer and takes dp only.
``pretrain(mesh=...)`` adds ZeRO-1 (``PretrainConfig.zero1``,
``optim.zero1``).  On a pipeline mesh (a "pp" axis, ``parallel.make_pp_mesh``)
the agent step runs through the GPipe schedule (``agent_pp_train_step``,
``parallel/pipeline.py``) on the global batch.  ``PretrainConfig.ckpt_backend
= "orbax"`` writes the port's sharded, asynchronous checkpoint directories
(``utils/checkpoint.py save_checkpoint_orbax``) in place of pickles.  The
steps update ``params`` and the optimizer state in place and return them.
"""

from __future__ import annotations

import functools
import os
import threading
from typing import Callable, Optional

import numpy as np
import torch

from ..config import LinearTransformerConfig, PretrainConfig, WindowTransformerConfig
from ..models import linear_transformer as lt
from ..models import longformer as lf
from ..ops.losses import fields_cross_entropy
from ..parallel.mesh import all_reduce_
from ..parallel.sharding import gather_params, shard_params, shard_tree
from ..utils.checkpoint import (full_opt_state, load_checkpoint, load_checkpoint_orbax,
                                local_opt_state, save_checkpoint, save_checkpoint_orbax,
                                wait_for_checkpoints)
from ..utils.saver import MetricsBus, QuietSaver, Saver, loss_bucket_filename
from . import optim
from .data_pipeline import prefetch_batches

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _grads(params: dict, losses_fn: Callable, dp_mesh=None):
    """(grads tree, loss, per-field losses) of the mean of
    ``losses_fn(params)``; leaves the loss does not reach get zeros.  Under
    a dp mesh ``losses_fn`` gives this rank's share of the global losses:
    the gradients and the losses are summed over the dp group
    (``optim.value_and_grad``), so every rank holds the global ones."""
    def loss_fn(p):
        losses = losses_fn(p)
        return losses.mean(), losses.detach()
    loss, losses, grads = optim.value_and_grad(loss_fn, params, dp_mesh)
    return grads, loss.detach(), losses


def _scaled(grads: dict, scale: float) -> dict:
    return grads if scale == 1.0 else optim.tree_map(lambda g: g * scale, grads)


def _agent_losses(cfg: LinearTransformerConfig, x, y, mask,
                  generator: Optional[torch.Generator], dp_mesh) -> Callable:
    def losses_fn(p):
        if cfg.dtype != "float32":
            p = lt.cast_params(p, _DTYPES[cfg.dtype])
        return lt.train_losses(p, cfg, x, y, mask, deterministic=False, generator=generator,
                               dp_mesh=dp_mesh)
    return losses_fn


def _longformer_losses(cfg: WindowTransformerConfig, x, y, mask,
                       generator: Optional[torch.Generator], dp_mesh) -> Callable:
    def losses_fn(p):
        logits = lf.token_logits(p, cfg, x, mask, deterministic=False, generator=generator)
        return fields_cross_entropy(logits, y, mask, mesh=dp_mesh)
    return losses_fn


def agent_train_step(params: dict, opt_state: optim.AdamState, cfg: LinearTransformerConfig,
                     tx: optim.Adam, x, y, mask, generator: Optional[torch.Generator],
                     dp_mesh=None):
    """One CE pretrain step -> (params', opt_state', (loss, per-field)).
    ``dp_mesh``: x, y, mask are this rank's rows of the global batch, and
    under tp ``params`` and ``opt_state`` the rank's shards."""
    grads, loss, losses = _grads(params, _agent_losses(cfg, x, y, mask, generator, dp_mesh),
                                 dp_mesh)
    updates, opt_state = tx.update(grads, opt_state, params, mesh=dp_mesh)
    return optim.apply_updates(params, updates), opt_state, (loss, losses)


def agent_grad_step(params: dict, cfg: LinearTransformerConfig, x, y, mask,
                    generator: Optional[torch.Generator], scale: float = 1.0, dp_mesh=None):
    """Gradients and loss only, the micro-batch unit of gradient
    accumulation; ``scale`` pre-divides by the accumulation count, so the
    summed micro-gradients are the mean gradient."""
    grads, loss, losses = _grads(params, _agent_losses(cfg, x, y, mask, generator, dp_mesh),
                                 dp_mesh)
    return _scaled(grads, scale), (loss, losses)


def agent_pp_train_step(params: dict, opt_state: optim.AdamState, cfg: LinearTransformerConfig,
                        tx: optim.Adam, x, y, mask, generator: Optional[torch.Generator],
                        mesh=None, n_microbatch: Optional[int] = None):
    """``agent_train_step`` through the pipeline (JAX :95-104): the layer
    slabs staged over the mesh's "pp" axis, the rows over "dp"; x, y, mask
    the global batch, ``params`` and ``opt_state`` the rank's shards."""
    from ..parallel.pipeline import pipeline_train_step
    return pipeline_train_step(params, opt_state, cfg, tx, x, y, mask, generator, mesh,
                               n_microbatch)


def agent_pp_grad_step(params: dict, cfg: LinearTransformerConfig, x, y, mask,
                       generator: Optional[torch.Generator], mesh=None,
                       n_microbatch: Optional[int] = None, scale: float = 1.0):
    """The accumulation unit on a pipeline mesh (JAX :107-116): gradients
    and loss through the GPipe schedule, no optimizer."""
    from ..parallel.pipeline import pipeline_grad_step
    return pipeline_grad_step(params, cfg, x, y, mask, generator, mesh, n_microbatch, scale)


def longformer_lm_step(params: dict, opt_state: optim.AdamState, cfg: WindowTransformerConfig,
                       tx: optim.Adam, x, y, mask, generator: Optional[torch.Generator],
                       dp_mesh=None):
    """Discriminator-LM pretrain step (dqn_policy/discrim-pretrain.py:342-490):
    per-field masked CE through the window transformer -> (params',
    opt_state', (loss, per-field))."""
    grads, loss, losses = _grads(
        params, _longformer_losses(cfg, x, y, mask, generator, dp_mesh), dp_mesh)
    updates, opt_state = tx.update(grads, opt_state, params, mesh=dp_mesh)
    return optim.apply_updates(params, updates), opt_state, (loss, losses)


def longformer_grad_step(params: dict, cfg: WindowTransformerConfig, x, y, mask,
                         generator: Optional[torch.Generator], scale: float = 1.0,
                         dp_mesh=None):
    """``longformer_lm_step`` without the optimizer: the accumulation unit."""
    grads, loss, losses = _grads(
        params, _longformer_losses(cfg, x, y, mask, generator, dp_mesh), dp_mesh)
    return _scaled(grads, scale), (loss, losses)


# the micro-gradient step that gradient accumulation pairs with each step
_GRAD_STEPS = {agent_train_step: agent_grad_step, longformer_lm_step: longformer_grad_step}


def apply_grads(params: dict, opt_state: optim.AdamState, tx: optim.Adam, grads: dict,
                mesh=None):
    """The optimizer step on summed micro-gradients; ``mesh``: the steps'
    mesh (the clip's norm)."""
    updates, opt_state = tx.update(grads, opt_state, params, mesh=mesh)
    return optim.apply_updates(params, updates), opt_state


# Set by the SIGTERM/SIGINT handler (pcfg.save_on_interrupt) or by an
# embedding application: the loop checkpoints and returns at the next batch.
INTERRUPT = threading.Event()


def _install_interrupt_handler() -> None:
    import signal

    def handler(signum, frame):
        INTERRUPT.set()
    try:
        signal.signal(signal.SIGTERM, handler)
        signal.signal(signal.SIGINT, handler)
    except ValueError:
        pass        # not the main thread; the caller sets INTERRUPT directly


def pretrain(params: dict, cfg, train_x, train_y, train_mask,
             pcfg: PretrainConfig = PretrainConfig(), *,
             step_fn: Callable = agent_train_step, mesh=None,
             metrics: Optional[MetricsBus] = None, max_steps: Optional[int] = None,
             resume_from: Optional[str] = None):
    """The pretrain loop (agent_pretrain.py:485-632) on the device that
    holds ``params``.  Returns (params, opt_state, history of epoch losses).

    ``step_fn`` is ``agent_train_step`` (a ``LinearTransformerConfig``) or
    ``longformer_lm_step`` (a ``WindowTransformerConfig``); gradient
    accumulation takes the matching grad step and raises ``ValueError`` for
    any other ``step_fn``.  ``max_steps`` bounds the batches (for tests and
    measurements).  A ``metrics`` bus that carries a ``Saver`` logs to that
    saver's ``log.txt``; otherwise the loop opens ``pcfg.exp_dir/log.txt``.

    ``mesh`` (``parallel.make_mesh``; JAX's loop :201-387): every rank
    runs this loop on its dp index's rows of each global batch of
    ``pcfg.batch_size``, from rank 0's parameters (under tp, its shards of
    them), with a generator of its own (seed ``pcfg.seed + 7919 *
    dp_index``: the ranks of a tp group draw the same dropout masks); the
    steps make the loss and the gradients global, so every rank holds the
    same parameters (shards) and history.  ``pcfg.zero1`` slices Adam's
    moments over the dp ranks (``optim.zero1``; it needs dp > 1).  Only rank
    0 logs.  A pickle checkpoint (``pcfg.ckpt_backend`` "pickle") is the
    whole tree (the ZeRO-1 moments gathered over dp, the tp shards over tp,
    the layer slabs over pp), in the layout one process writes, by rank 0;
    with "orbax" every rank writes its own shards to the checkpoint's
    directory in the background (``save_checkpoint_orbax``, no gather), and
    every return waits for the saves in flight, then holds a barrier, so
    that no rank returns before every rank's shards are committed (JAX
    :343-344, :385-386).  A ``resume_from`` directory is read by
    ``load_checkpoint_orbax``, a file as a pickle (JAX :232-236); every
    rank puts the whole tree together and keeps its shards, so a run
    resumes at another dp, tp or pp.  Under
    tp or pp the returned params and state are the rank's shards
    (``parallel.gather_params`` puts them back whole).  On a pipeline mesh
    (JAX :249-256) every rank reads the global batch and the agent step
    runs through ``agent_pp_train_step`` (gradient accumulation through
    ``agent_pp_grad_step``), each rank's generator seeded by its dp index
    and stage (``pcfg.seed + 7919 (dp_index pp + stage)``); ZeRO-1 and the
    Longformer step raise ``ValueError`` there, as in JAX.  With
    ``save_on_interrupt`` the interrupt flag is all-reduced (MAX) at every
    batch, so all ranks stop at the same one."""
    if pcfg.ckpt_backend not in ("pickle", "orbax"):
        raise ValueError(f"ckpt_backend={pcfg.ckpt_backend!r}: expected 'pickle' or 'orbax'")
    sharded_ckpt = pcfg.ckpt_backend == "orbax"
    dp = mesh.dp if mesh is not None else 1
    tp = mesh.tp if mesh is not None else 1
    pp = mesh.pp if mesh is not None else 1
    piped = mesh is not None and "pp" in mesh.shape
    rank = mesh.rank if mesh is not None else 0
    if tp > 1:
        if step_fn is not agent_train_step:
            raise NotImplementedError("pretrain(mesh=...) with tp > 1 takes the agent step: the "
                                      "Longformer LM has no tensor-parallel layer")
        lt.check_tp(cfg, tp)
    if pcfg.zero1 and dp <= 1:
        raise ValueError("PretrainConfig.zero1 needs a mesh with dp>1 (the optimizer state "
                         "shards over 'dp')")
    if pcfg.zero1 and piped:
        raise ValueError("zero1 on a pipeline mesh is not implemented (moments would need the "
                         "layer-stack 'pp' sharding on top of 'dp'); use a ('dp','tp') mesh")
    if piped and step_fn is not agent_train_step:
        raise ValueError("a pipeline mesh only supports the LinearTransformer agent path "
                         "(agent_train_step)")
    accum = max(1, pcfg.grad_accum)
    grad_step = _GRAD_STEPS.get(step_fn)
    if accum > 1 and grad_step is None:
        raise ValueError("grad_accum needs a known step_fn (agent_train_step / "
                         "longformer_lm_step); custom step_fns must apply their own "
                         "accumulation")
    device = optim.tree_leaves(params)[0].device
    if mesh is not None:
        if grad_step is None:
            raise ValueError("pretrain(mesh=...) needs a known step_fn (agent_train_step / "
                             "longformer_lm_step): the steps hold the collectives")
        if mesh.device != device:
            raise ValueError(f"the mesh computes on {mesh.device}, params are on {device}")
        n_whole = lt.n_params(params)
        params = shard_params(mesh, params)
        if piped:
            step_fn = functools.partial(agent_pp_train_step, mesh=mesh)
            grad_step = functools.partial(agent_pp_grad_step, mesh=mesh)
        else:
            step_fn = functools.partial(step_fn, dp_mesh=mesh)
            grad_step = functools.partial(grad_step, dp_mesh=mesh)
    # schedules count OPTIMIZER steps; milestones are epochs
    num_batch_sched = max(1, len(train_x) // pcfg.batch_size // accum)
    lr = (optim.multistep_lr(pcfg.lr, tuple(int(m) * num_batch_sched
                                            for m in pcfg.lr_milestones), pcfg.lr_gamma)
          if pcfg.lr_milestones else pcfg.lr)
    tx = optim.adam(lr, grad_clip=pcfg.grad_clip)
    if pcfg.zero1:
        tx = optim.zero1(tx, mesh, params)
    opt_state = tx.init(params)
    start_epoch = 0
    if resume_from is not None:
        if os.path.isdir(resume_from):
            # a directory is the sharded backend, a file a pickle (JAX :232-236)
            ck = load_checkpoint_orbax(resume_from, params_template=params,
                                       opt_state_template=opt_state, device=device, mesh=mesh,
                                       tx=tx)
            params = ck["params"]
            if ck["opt_state"] is not None:
                opt_state = ck["opt_state"]
        else:
            whole = params if mesh is None else gather_params(mesh, params)
            ck = load_checkpoint(resume_from, params_template=whole,
                                 opt_state_template=optim.AdamState(whole, whole, 0),
                                 device=device)
            del whole
            params = ck["params"] if mesh is None else shard_tree(mesh, ck["params"])
            if ck["opt_state"] is not None:
                opt_state = local_opt_state(tx, ck["opt_state"], mesh)
        start_epoch = int(ck["extra"].get("epoch", -1)) + 1
    if metrics is not None and metrics.saver is not None:
        saver = metrics.saver
    else:
        saver = Saver(pcfg.exp_dir) if rank == 0 else QuietSaver()
    bus = metrics or MetricsBus(saver)
    saver.add_summary_msg(f" > params amount: "
                          f"{n_whole if mesh is not None else lt.n_params(params):,d}")

    def save(name: str, extra: dict) -> str:
        """Every rank calls it.  Sharded: each rank's shards, written in the
        background.  Pickle: ZeRO-1 gathers the moments, tp and pp the
        shards, and rank 0 writes the whole tree."""
        path = f"{pcfg.ckpt_dir}/{name}.ckpt"
        if sharded_ckpt:
            return save_checkpoint_orbax(path, params, opt_state, step=saver.global_step,
                                         extra=extra, mesh=mesh, tx=tx)
        state = full_opt_state(tx, opt_state, mesh)
        whole = params if mesh is None else gather_params(mesh, params)
        if rank == 0:
            save_checkpoint(path, whole, state, step=saver.global_step, extra=extra)
        return path

    def done(*out):
        """``out``, once this process's sharded saves have committed and,
        on a mesh, every rank's have (a barrier on this thread)."""
        if sharded_ckpt:
            wait_for_checkpoints()
            if mesh is not None:
                all_reduce_(mesh, [torch.zeros(1, device=device)], axis="world")
        return out

    def interrupted() -> bool:
        flag = INTERRUPT.is_set()
        if mesh is not None:
            t = torch.tensor([float(flag)], device=device)
            all_reduce_(mesh, [t], op="max", axis="world")
            flag = bool(t.item())
        return flag

    if pcfg.save_on_interrupt:
        _install_interrupt_handler()
        INTERRUPT.clear()
    num_batch = len(train_x) // pcfg.batch_size
    generator = torch.Generator(device=device)
    generator.manual_seed(pcfg.seed + 7919 * (0 if mesh is None
                                              else mesh.dp_index * pp + mesh.pp_index))
    grads_acc, micro = None, 0
    steps_done = 0
    history = []
    for epoch in range(start_epoch, pcfg.n_epoch):
        # losses accumulate on the device; fetching every batch would
        # synchronise the host with each step
        acc_loss = torch.zeros((), device=device)
        acc_losses = torch.zeros(len(cfg.vocab_sizes), device=device)
        for bidx, (bx, by, bm) in prefetch_batches(train_x, train_y, train_mask,
                                                   pcfg.batch_size, device,
                                                   depth=pcfg.prefetch_depth,
                                                   mesh=None if piped else mesh):
            saver.global_step_increment()
            if accum == 1:
                params, opt_state, (loss, losses) = step_fn(params, opt_state, cfg, tx, bx, by,
                                                            bm, generator)
            else:
                # K micro-gradients pre-scaled by 1/K sum to the mean
                # gradient; one optimizer step per K.  The window carries
                # across epoch boundaries.
                grads, (loss, losses) = grad_step(params, cfg, bx, by, bm, generator,
                                                  scale=1.0 / accum)
                grads_acc = grads if grads_acc is None else optim.tree_map(
                    torch.add, grads_acc, grads)
                micro += 1
                if micro == accum:
                    params, opt_state = apply_grads(params, opt_state, tx, grads_acc, mesh)
                    grads_acc, micro = None, 0
            acc_loss = acc_loss + loss
            acc_losses = acc_losses + losses
            if (bidx + 1) % max(1, pcfg.log_every) == 0 or bidx == num_batch - 1:
                bus.log({"batch loss": float(loss)})
            steps_done += 1
            if pcfg.save_on_interrupt and interrupted():
                if grads_acc is not None:
                    params, opt_state = apply_grads(params, opt_state, tx, grads_acc, mesh)
                path = save("interrupt", {"epoch": epoch - 1, "interrupted": True})
                out = done(params, opt_state, history)
                saver.add_summary_msg(f" > interrupted: checkpoint saved to {path}")
                return out
            if max_steps is not None and steps_done >= max_steps:
                # a pending partial window still applies (1/K-scaled)
                if grads_acc is not None:
                    params, opt_state = apply_grads(params, opt_state, tx, grads_acc, mesh)
                return done(params, opt_state, history)

        epoch_loss = float(acc_loss) / max(num_batch, 1)
        history.append(epoch_loss)
        bus.log({"epoch loss": epoch_loss})
        saver.add_summary("epoch each loss", ", ".join(
            f"{v / max(num_batch, 1):04f}" for v in np.asarray(acc_losses.cpu())))
        # loss-bucketed checkpointing + early stop (agent_pretrain.py:594-632)
        bucket = loss_bucket_filename(epoch_loss)
        if bucket is None:
            if grads_acc is not None:           # pending partial accumulation window
                params, opt_state = apply_grads(params, opt_state, tx, grads_acc, mesh)
                grads_acc = None
            save("trainloss_final", {"epoch": epoch, "loss": epoch_loss})
            return done(params, opt_state, history)
        save(bucket, {"epoch": epoch, "loss": epoch_loss})
    if grads_acc is not None:
        params, opt_state = apply_grads(params, opt_state, tx, grads_acc, mesh)
    return done(params, opt_state, history)
