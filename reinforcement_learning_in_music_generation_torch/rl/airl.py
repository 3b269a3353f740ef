"""AIRL discriminator trainer: the counterpart of the JAX package's
``rl/airl.py`` (reference: dqn_policy/AIRL.py:33-236 ``RewardDiscri``).

A window-transformer discriminator (``models/longformer.py``, score head)
trained with BCE(D(expert) -> 1) + BCE(D(agent) -> 0) + an LM-style token CE,
then used to re-score both replay buffers as rewards.  The JAX package scans
the minibatches of an epoch and the scoring batches on the device; here they
are Python loops of eager steps.  Steps update the parameters in place and
return the new state.

On a (dp, tp) mesh (``mesh``) the discriminator's parameters and Adam
moments are the rank's tp shards and its layers run the Longformer's
Megatron layer (``models/longformer.py``).  Two ways to spread the
minibatches over dp:

  * by default (the CLI's, as JAX's CLI passes whole buffers) every dp
    rank runs each minibatch whole, so the work is replicated over dp and
    split over tp: the means are each rank's own and the gradients are not
    summed over dp.  Every dp rank takes the same update, from the same
    generator state; the first rank of each dp group hands its gradients
    and BatchNorm statistics to the others (``disc_step``), so they end
    with the same parameters bit for bit;
  * ``dp_rows=True`` (JAX's library configuration, its buffers split over
    dp by ``shard_batch``): the callers still pass whole buffers and
    minibatches, and rank r runs rows [i bs + r bs/dp, i bs + (r+1) bs/dp)
    of minibatch i (``parallel/mesh.py row_block``), so global minibatch i
    holds one process's rows.  The score head's BatchNorm statistics, the
    BCE means and the token CE's mean are the global minibatch's, the
    dropout masks its draw at the rank's rows, and the gradients and
    losses are summed over dp (``optim.value_and_grad``): every rank holds
    the same sums, so no broadcast.  A minibatch whose rows dp does not
    divide runs whole on every rank, as by default.
``calculate_reward`` and ``gradient_penalty`` take whole buffers in both.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import torch

from ..config import AIRLConfig, WindowTransformerConfig
from ..models import longformer as lf
from ..ops.losses import binary_cross_entropy
from ..parallel.mesh import broadcast_, row_block
from ..train import optim


class AIRLState(NamedTuple):
    params: dict
    bn_state: dict              # the score head's BatchNorm running stats
    opt_state: optim.AdamState


def make_optimizer(cfg: AIRLConfig) -> optim.Adam:
    """Adam with StepLR stepped per minibatch, as the reference steps it
    (AIRL.py:176)."""
    return optim.adam(optim.step_lr(cfg.lr, cfg.lr_step, cfg.lr_gamma))


def init_state(mcfg: WindowTransformerConfig, cfg: AIRLConfig, *, seed: int = 0,
               device="cuda") -> AIRLState:
    params = lf.init_params(mcfg, seed=seed, device=device)
    return AIRLState(params, lf.init_state(mcfg, device=device), make_optimizer(cfg).init(params))


def disc_step(state: AIRLState, mcfg: WindowTransformerConfig, tx: optim.Adam,
              expert_states, expert_masks, agent_states, generator: Optional[torch.Generator],
              mesh=None, dp_rows: bool = False) -> Tuple[AIRLState, dict]:
    """One minibatch update (AIRL.py:142-182): global = BCE(D(expert) -> 1)
    + BCE(D(agent) -> 0) + CE_token(agent | expert), dropout from
    ``generator`` (None: no dropout).  The BatchNorm state threads from the
    expert pass into the agent pass and out, outside autograd.  Returns
    (state', {"expert_loss", "agent_loss", "ce_loss", "global_loss"} as 0-d
    device tensors, the minibatch's).  ``mesh``: the tp shards; the rows
    whole, or with ``dp_rows`` the rank's block of the whole minibatch
    given (the module's docstring)."""
    rows = row_block(mesh, expert_states.shape[0]) if dp_rows and mesh is not None else (0, 1)
    split = rows[1] > 1
    if split:
        n = expert_states.shape[0] // rows[1]
        expert_states, expert_masks, agent_states = (
            t[rows[0] * n:(rows[0] + 1) * n] for t in (expert_states, expert_masks, agent_states))
    kw = dict(train=True, deterministic=False, generator=generator, mesh=mesh, rows=rows)
    dp_mesh = mesh if split else None
    bn2 = {}                    # the agent pass's BatchNorm statistics

    def loss_fn(p):
        exp_score, bn1 = lf.score_forward(p, mcfg, expert_states, expert_masks, state.bn_state,
                                          **kw)
        bn1 = {k: v.detach() for k, v in bn1.items()}
        agent_score, bn_out = lf.score_forward(p, mcfg, agent_states, expert_masks, bn1, **kw)
        bn2.update(bn_out)
        exp_bce = binary_cross_entropy(exp_score, torch.ones_like(exp_score), dp_mesh)
        agent_bce = binary_cross_entropy(agent_score, torch.zeros_like(agent_score), dp_mesh)
        ce = lf.token_ce(p, mcfg, agent_states, expert_states, expert_masks,
                         deterministic=False, generator=generator, mesh=mesh, rows=rows)
        return exp_bce + agent_bce + ce, (exp_bce, agent_bce, ce)

    # split: each rank's share of the losses, summed with the gradients over
    # dp; the BatchNorm statistics are already the minibatch's on every rank
    total, (exp_bce, agent_bce, ce), grads = optim.value_and_grad(loss_fn, state.params, dp_mesh)
    if mesh is not None and mesh.dp > 1 and not split:
        # every dp rank computed this step on the same rows, but a card's
        # backward need not repeat its bits from process to process: the dp
        # group takes its first rank's gradients and BatchNorm statistics,
        # so that its ranks keep one discriminator
        broadcast_(mesh, optim.tree_leaves(grads) + list(bn2.values()), src=0, axis="dp")
    updates, opt_state = tx.update(grads, state.opt_state, state.params, mesh=mesh)
    params = optim.apply_updates(state.params, updates)
    metrics = {"expert_loss": exp_bce.detach(), "agent_loss": agent_bce.detach(),
               "ce_loss": ce.detach(), "global_loss": total.detach()}
    return AIRLState(params, {k: v.detach() for k, v in bn2.items()}, opt_state), metrics


def disc_epoch(state: AIRLState, mcfg: WindowTransformerConfig, tx: optim.Adam,
               expert_states, expert_masks, agent_states,
               generator: Optional[torch.Generator], batch_size: int,
               mesh=None, dp_rows: bool = False) -> Tuple[AIRLState, dict]:
    """One pass over the buffers in minibatches (AIRL.py:136-212 inner
    loop); the metrics are the epoch's means (0-d device tensors).  The
    buffers are whole; ``dp_rows``: each minibatch split over dp
    (``disc_step``)."""
    hist: List[dict] = []
    for i in range(expert_states.shape[0] // batch_size):
        sl = slice(i * batch_size, (i + 1) * batch_size)
        state, m = disc_step(state, mcfg, tx, expert_states[sl], expert_masks[sl],
                             agent_states[sl], generator, mesh, dp_rows)
        hist.append(m)
    return state, {k: torch.stack([m[k] for m in hist]).mean() for k in hist[0]}


@torch.no_grad()
def calculate_reward(state: AIRLState, mcfg: WindowTransformerConfig, states, masks,
                     batch_size: int = 100, mesh=None) -> torch.Tensor:
    """Score a whole buffer (AIRL.py:69-90): (N, S, 6) -> (N, 1), in batches,
    no dropout.  Scoring uses train-mode BatchNorm with each batch's own
    statistics and throws the updated running stats away: the reference's
    ``calculate_reward`` calls ``eval()`` but its ``all_forward`` re-enters
    ``train()`` (AIRL.py:63, 75), and only this mode separates expert from
    agent (the JAX docstring and PARITY.md section 2.6 #15).  So a score
    depends on which rows share its batch; a ragged tail is its own batch."""
    n = states.shape[0]
    scores = [lf.score_forward(state.params, mcfg, states[i:i + batch_size],
                               masks[i:i + batch_size], state.bn_state, train=True,
                               deterministic=True, mesh=mesh)[0]
              for i in range(0, n, batch_size)]
    return torch.cat(scores, dim=0)


def update_disc(state: AIRLState, mcfg: WindowTransformerConfig, cfg: AIRLConfig,
                tx: optim.Adam, agent_buffer: dict, expert_buffer: dict,
                generator: Optional[torch.Generator], *, train: bool = True, mesh=None,
                dp_rows: bool = False):
    """Full discriminator update and buffer re-scoring (AIRL.py:121-236):
    ``cfg.epochs`` epochs when ``train`` (``dp_rows``: their minibatches
    split over dp, ``disc_step``), then both buffers scored whole with the
    expert buffer's ``mask_state`` (it masks the agent states too).
    Returns (state, agent_rewards (N, 1), expert_rewards (N, 1), per-epoch
    metrics as floats)."""
    hist = []
    if train:
        for _ in range(cfg.epochs):
            state, metrics = disc_epoch(state, mcfg, tx, expert_buffer["state"],
                                        expert_buffer["mask_state"], agent_buffer["state"],
                                        generator, cfg.batch_size, mesh, dp_rows)
            hist.append({k: float(v) for k, v in metrics.items()})
    agent_r = calculate_reward(state, mcfg, agent_buffer["state"], expert_buffer["mask_state"],
                               cfg.score_batch_size, mesh)
    expert_r = calculate_reward(state, mcfg, expert_buffer["state"],
                                expert_buffer["mask_state"], cfg.score_batch_size, mesh)
    return state, agent_r, expert_r, hist


def gradient_penalty(state: AIRLState, mcfg: WindowTransformerConfig, expert_states,
                     agent_states, masks, generator: Optional[torch.Generator] = None,
                     lambda_term: float = 5.0, *, eta: Optional[torch.Tensor] = None,
                     mesh=None) -> torch.Tensor:
    """WGAN-GP on interpolated embeddings (the reference defines it, never
    calls it and marks it '# Error #', AIRL.py:93-118): token ids are
    discrete, so it interpolates embeddings with eta ~ U(0, 1) per row
    (drawn from ``generator`` unless ``eta`` (B, 1, 1) is given) and takes
    the score's gradient there, through ``longformer.score_from_embeddings``
    in eval mode.  Differentiable in the parameters.  Under tp (``mesh``)
    it interpolates the gathered, whole embeddings, so the gradient's norm
    is over the whole concat, as JAX's."""
    if eta is None:
        eta = torch.rand((expert_states.shape[0], 1, 1), generator=generator,
                         device=expert_states.device)
    e_emb = lf.embed(state.params, mcfg, expert_states, mesh)
    a_emb = lf.embed(state.params, mcfg, agent_states, mesh)
    inter = eta * e_emb + (1.0 - eta) * a_emb
    if not inter.requires_grad:
        inter = inter.detach().requires_grad_(True)
    with torch.enable_grad():
        score, _ = lf.score_from_embeddings(state.params, mcfg, inter, masks, state.bn_state,
                                            train=False, deterministic=True, mesh=mesh)
        grads, = torch.autograd.grad(score.sum(), inter, create_graph=True)
    norms = torch.sqrt(torch.sum(grads ** 2, dim=(1, 2)) + 1e-12)
    return torch.mean((norms - 1.0) ** 2) * lambda_term
