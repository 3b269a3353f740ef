"""DQN policy over CP token actions: the counterpart of the JAX package's
``rl/dqn.py`` (reference: dqn_policy/IRL_dqn_train.py:210-383).

The eval and target nets are linear transformers with the JAX parameter
tree; actions are the per-field argmaxes over the last ``n_actions``
positions; the TD loss gathers Q(s, a) per field against reward + gamma (1 -
done) top_k(max_a' Q_target), in a 0.3 MSE + 0.7 CE(agent state -> expert
next state) composite (IRL_dqn_train.py:317-336).

The optimizer's ``apply_updates`` adds in place, so the target tree is a
copy of the eval tree (``init_state`` clones it) and a hard sync copies the
eval values into the target's own tensors: the target changes only at a
sync.  ``update`` updates the eval tree in place and returns the new state.

On a (dp, tp) mesh (``mesh``, ``parallel/mesh.py``) the trees are the
rank's tp shards (``parallel/sharding.py``; the hard sync copies shard into
shard); ``update`` takes the whole batches and keeps the rank's dp rows
(``shard_batch``), and the CE's dropout masks are the whole batch's draw
at those rows, so the generator stays in step on every rank.  The
target's top-k reads the reduced, replicated logits; the MSE is
``ops/losses.py batch_mean``'s and the CE the global masked CE, each this
rank's share of the global loss, and the gradients and losses are summed
over the dp group (``optim.value_and_grad``), as JAX's GSPMD program on
``make_mesh(dp, tp)`` computes them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import DQNConfig, LinearTransformerConfig
from ..models import linear_transformer as lt
from ..ops.losses import batch_mean
from ..parallel import mesh as pmesh
from ..train import optim


class DQNState(NamedTuple):
    eval_params: dict
    target_params: dict
    opt_state: optim.AdamState
    target_count: int          # updates taken


def make_optimizer(cfg: DQNConfig) -> optim.Adam:
    return optim.adam(optim.multistep_lr(cfg.lr, cfg.lr_milestones, cfg.lr_gamma))


def init_state(mcfg: LinearTransformerConfig, cfg: DQNConfig,
               pretrain_params: Optional[dict] = None, *, seed: int = 0,
               device="cuda") -> DQNState:
    """Eval params from ``pretrain_params`` or random from ``seed``; the
    target a clone of them, never an alias."""
    eval_params = pretrain_params or lt.init_params(mcfg, seed=seed, device=device)
    target_params = optim.tree_map(torch.clone, eval_params)
    return DQNState(eval_params, target_params, make_optimizer(cfg).init(eval_params), 0)


@torch.no_grad()
def choose_action(params: dict, mcfg: LinearTransformerConfig, state: torch.Tensor,
                  n_actions: int = 25, mesh=None) -> torch.Tensor:
    """state (B, S, 6) -> action (B, n_actions, 6) int32: the per-field
    argmax over the last n_actions positions, in temporal order
    (IRL_dqn_train.py:240-264, as the JAX function reads it); ``mesh``:
    ``params`` the rank's tp shards, the argmax over replicated logits."""
    h = lt.forward_hidden(params, mcfg, state, deterministic=True, dp_mesh=mesh)
    logits = lt.forward_output(params, mcfg, h, mesh)
    return torch.stack([lg[:, -n_actions:, :].argmax(-1) for lg in logits],
                       dim=-1).to(torch.int32)


def _q_gather(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
    """Q(s, a) of one field: logits at the last n_actions positions,
    gathered at the actions (IRL_dqn_train.py:287-292)."""
    window = logits[:, -actions.shape[1]:, :]
    return torch.gather(window, -1, actions.long()[..., None])[..., 0]


def update(state: DQNState, mcfg: LinearTransformerConfig, cfg: DQNConfig, tx: optim.Adam,
           batch: dict, expert_batch: dict, generator: Optional[torch.Generator],
           mesh=None) -> Tuple[DQNState, dict]:
    """One DQN update (IRL_dqn_train.py:267-348) -> (state', {"mse", "ce",
    "total"} as 0-d device tensors).

    batch: agent transitions {'state', 'action', 'reward', 'next_state',
    'done'}; expert_batch: {'state', 'next_state', 'mask_next_state'} for
    the CE term, which runs with dropout drawn from ``generator`` (None: no
    dropout).  The target hard-syncs when target_count % target_update == 0,
    checked before the update, so the first update syncs (:269-271).
    ``mesh``: the trees are this rank's tp shards, the batches whole; the
    update runs on the rank's dp rows of them (all of them where dp does
    not divide them), and the metrics are the global ones on every rank.
    The CE's dropout draws from ``generator`` what one process draws and
    keeps the rank's rows (``lt.forward_hidden``'s ``rows``; a fused
    kernel's seed + 7919 dp index, ``lt._dropout_seed``), so the generator
    stays equal on every rank."""
    rows = (0, 1)
    if mesh is not None:
        rows = pmesh.row_block(mesh, batch["state"].shape[0])
        batch, expert_batch = pmesh.shard_batch(mesh, batch), pmesh.shard_batch(mesh, expert_batch)
    eval_params, target_params = state.eval_params, state.target_params
    if state.target_count % cfg.target_update == 0:
        optim.tree_map(lambda t, e: t.copy_(e), target_params, eval_params)
    a_state, a_action = batch["state"], batch["action"]
    a_reward = batch["reward"]                               # (B, 1)
    a_done = batch["done"].to(torch.float32)
    n_act = a_action.shape[1]
    with torch.no_grad():                                    # stop_gradient of the target
        ht = lt.forward_hidden(target_params, mcfg, batch["next_state"], deterministic=True,
                               dp_mesh=mesh)
        tops = [torch.topk(tlg.max(dim=-1).values, n_act, dim=-1).values
                for tlg in lt.forward_output(target_params, mcfg, ht, mesh)]

    def loss_fn(p):
        h = lt.forward_hidden(p, mcfg, a_state, deterministic=True, dp_mesh=mesh)
        logits = lt.forward_output(p, mcfg, h, mesh)
        mse = 0.0
        for i, (lg, top) in enumerate(zip(logits, tops)):
            target = a_reward + cfg.gamma * (1.0 - a_done) * top
            mse = mse + batch_mean((_q_gather(lg, a_action[..., i]) - target) ** 2, mesh)
        mse = mse / len(logits)
        ce = torch.mean(lt.train_losses(p, mcfg, a_state, expert_batch["next_state"],
                                        expert_batch["mask_next_state"], deterministic=False,
                                        generator=generator, dp_mesh=mesh, rows=rows))
        return cfg.alpha * mse + (1.0 - cfg.alpha) * ce, (mse, ce)

    total, (mse, ce), grads = optim.value_and_grad(loss_fn, eval_params, mesh)
    updates, opt_state = tx.update(grads, state.opt_state, eval_params, mesh=mesh)
    optim.apply_updates(eval_params, updates)
    metrics = {"mse": mse.detach(), "ce": ce.detach(), "total": total.detach()}
    return DQNState(eval_params, target_params, opt_state, state.target_count + 1), metrics
