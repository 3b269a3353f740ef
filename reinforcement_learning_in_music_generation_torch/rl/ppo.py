"""PPO with a learned reward: the counterpart of the JAX package's
``rl/ppo.py`` (reference: ppo_policy/ppo_train.py:217-528).

The actor is a linear transformer with a value head, the critic a trunk
with per-field value heads (``models/critic.py``), the reward a window-
transformer eval model (``models/longformer.py eval_score``).  A song's
rollout is 30 episodes of choose_action / critic value / learned reward;
then discounted returns, advantages = returns - values, and 10 clipped-
surrogate steps with a CE-vs-expert auxiliary loss and a critic MSE.

As in the JAX package, returns accumulate in reverse order by default;
``PPOConfig.compat_forward_returns`` restores the reference's forward order.
Returns and advantages are normalised with the population std (ddof 0,
``jnp.std``'s).  The rollout stores the post-step state as ``state``, as
the reference does (ppo_train.py:487, 494).

The optimizer adds its updates in place: ``update_policy_step`` updates the
actor's and the critic's trees (two separate trees, never sharing storage)
and returns the state with them.  The rollout's transitions are new tensors
and the losses read them detached, so an update never changes them.

On a (dp, tp) mesh (``mesh``) the three trees and the two optimizers'
moments are the rank's tp shards.  The rollout is the same on every rank
(eager at tp > 1, ``env.tp_eager``); returns and advantages are computed
on the whole rollout, then the transitions and both are sharded over dp
(``shard_batch``, the caller's).  The surrogate and the value MSE are
``ops/losses.py batch_mean``'s and the actor's CE the global masked CE,
each this rank's share of the global loss, and the actor's and critic's
gradients and losses are summed over the dp group.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..config import LinearTransformerConfig, PPOConfig, WindowTransformerConfig
from ..models import critic as critic_lib
from ..models import linear_transformer as lt
from ..models import longformer as lf
from ..ops.losses import batch_mean
from ..train import optim
from . import episode_graph
from .env import _windows, tp_eager


class PPOState(NamedTuple):
    actor_params: dict
    critic_params: dict
    reward_params: dict
    actor_opt: optim.AdamState
    critic_opt: optim.AdamState


def make_optimizers(cfg: PPOConfig) -> Tuple[optim.Adam, optim.Adam]:
    return optim.adam(cfg.lr), optim.adam(cfg.lr)


def init_state(actor_cfg: LinearTransformerConfig, critic_cfg: LinearTransformerConfig,
               reward_cfg: WindowTransformerConfig, cfg: PPOConfig, *,
               actor_params: Optional[dict] = None, reward_params: Optional[dict] = None,
               seed: int = 0, device="cuda") -> PPOState:
    """Actor and reward params as given or random; the critic random.  The
    three draws use seeds seed, seed + 1 and seed + 2."""
    actor_params = actor_params or lt.init_params(actor_cfg, seed=seed, device=device)
    critic_params = critic_lib.init_params(critic_cfg, seed=seed + 1, device=device)
    reward_params = reward_params or lf.init_params(reward_cfg, seed=seed + 2, device=device)
    atx, ctx = make_optimizers(cfg)
    return PPOState(actor_params, critic_params, reward_params, atx.init(actor_params),
                    ctx.init(critic_params))


def _policy_logprobs(logits, n_actions: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-field argmax actions over the last n_actions positions and their
    log-probs (ppo_train.py:251-290 choose_action, fixed indexing) ->
    (actions (B, n_actions, F) int32, logp (B, n_actions, F))."""
    actions, logps = [], []
    for lg in logits:
        window = torch.log_softmax(lg[:, -n_actions:, :], dim=-1)
        act = window.argmax(dim=-1)
        actions.append(act)
        logps.append(torch.gather(window, -1, act[..., None])[..., 0])
    return torch.stack(actions, dim=-1).to(torch.int32), torch.stack(logps, dim=-1)


@torch.no_grad()
def choose_action(actor_params: dict, acfg: LinearTransformerConfig, state: torch.Tensor,
                  n_actions: int = 25, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """state (B, S, F) -> (actions, log-probs), each (B, n_actions, F);
    ``mesh``: the actor's tp shards, the logits reduced and replicated."""
    h = lt.forward_hidden(actor_params, acfg, state, deterministic=True, dp_mesh=mesh)
    return _policy_logprobs(lt.forward_output(actor_params, acfg, h, mesh), n_actions)


class _PpoEpisodes(episode_graph.EpisodeLoop):
    """A song's PPO episodes on static buffers: the current state, the
    song's state masks, the stacked next states, actions, log-probs, values
    and rewards, and the episode index; ``mesh``: the tp mesh of the
    weights' shards (None: whole weights)."""

    def __init__(self, cfgs, episodes: int, n_states: int, n_actions: int, nf: int, dev,
                 mesh=None):
        super().__init__(dev)
        i32, f32 = dict(dtype=torch.int32, device=dev), dict(dtype=torch.float32, device=dev)
        self.cfgs, self.n_actions, self.mesh = cfgs, n_actions, mesh
        self.cur = torch.zeros((n_states, nf), **i32)
        self.mask_state = torch.zeros((episodes, n_states), **f32)
        self.nexts = torch.zeros((episodes, n_states, nf), **i32)
        self.actions = torch.zeros((episodes, n_actions, nf), **i32)
        self.logps = torch.zeros((episodes, n_actions, nf), **f32)
        self.values = torch.zeros((episodes, 1), **f32)
        self.rewards = torch.zeros((episodes, 1), **f32)
        self.idx = torch.zeros((1,), dtype=torch.long, device=dev)

    def body(self, trees) -> None:
        """One episode: the actor's action and log-probs, the next state,
        the critic's value of it and the reward model's score under the
        episode's mask, all stored at the index."""
        (actor, critic, reward), (acfg, ccfg, rcfg) = trees, self.cfgs
        mesh = self.mesh
        action, logp = choose_action(actor, acfg, self.cur[None], n_actions=self.n_actions,
                                     mesh=mesh)
        nxt = torch.cat([self.cur[:self.n_actions], action[0]], dim=0)[None]
        value = critic_lib.value_produce(critic, ccfg, nxt, dp_mesh=mesh)
        score = lf.eval_score(reward, rcfg, nxt, self.mask_state.index_select(0, self.idx),
                              mesh=mesh)
        self.nexts.index_copy_(0, self.idx, nxt)
        self.actions.index_copy_(0, self.idx, action)
        self.logps.index_copy_(0, self.idx, logp)
        self.values.index_copy_(0, self.idx, value[None])
        self.rewards.index_copy_(0, self.idx, score)
        self.cur.copy_(nxt[0])
        self.idx.add_(1)


@torch.no_grad()
def rollout_song(state: PPOState, state_cfgs, song_x: torch.Tensor, expert_y: torch.Tensor,
                 song_mask: torch.Tensor, *, episodes: int = 30, n_states: int = 50,
                 n_actions: int = 25, graph: bool = True, mesh=None) -> Tuple[Dict, Dict]:
    """One song's rollout (ppo_train.py:460-497) -> (agent, expert)
    transitions, each stacked (episodes, ...), tensors of their own.  A
    loop of episodes on the device: nothing waits for the host; on CUDA
    each episode is a replay of one CUDA graph, cached per weights
    (``episode_graph.cached``), and ``graph=False`` runs the eager loop
    there (for comparisons).  Expert and mask windows start at the episode
    number (clamped into the song, as ``lax.dynamic_slice_in_dim`` clamps);
    the next state's mask starts one later, the reference's offset.
    ``mesh``: every rank runs this same rollout; at tp > 1 the trees are
    the rank's tp shards and the loop runs eagerly (``env.tp_eager``)."""
    dev = song_x.device
    nf = song_x.shape[-1]
    trees = (state.actor_params, state.critic_params, state.reward_params)
    ep_mesh = mesh if tp_eager(mesh) else None
    build = lambda: _PpoEpisodes(state_cfgs, episodes, n_states, n_actions, nf, dev, ep_mesh)
    graph = graph and dev.type == "cuda" and not tp_eager(mesh)
    ep = episode_graph.cached(("ppo", tuple(state_cfgs), episodes, n_states, n_actions, nf, dev),
                              trees, build) if graph else build()
    num = torch.arange(episodes, device=dev)
    mask_state = _windows(song_mask, num, n_states).to(torch.float32)
    ep.mask_state.copy_(mask_state)
    ep.cur.copy_(song_x[:n_states])
    ep.idx.zero_()
    ep.run(episodes, trees, graph)
    next_states, action = ep.nexts.clone(), ep.actions.clone()
    col = lambda v, dt: torch.full((episodes, 1), v, dtype=dt, device=dev)
    agent_t = {"state": next_states, "action": action, "log_action": ep.logps.clone(),
               "value": ep.values.clone(), "reward": ep.rewards.clone(),
               "next_state": next_states, "done": col(0, torch.int32)}
    expert_t = {"state": _windows(expert_y, num, n_states).to(torch.int32), "action": action,
                "reward": col(1.0, torch.float32),
                "next_state": _windows(expert_y, num + n_states, n_states).to(torch.int32),
                "done": col(0, torch.int32), "mask_state": mask_state,
                "mask_next_state": _windows(song_mask, num + 1, n_states).to(torch.float32)}
    return agent_t, expert_t


def _normalize(x: torch.Tensor) -> torch.Tensor:
    """(x - mean) / (std + 1e-8), the population std (``jnp.std``, ddof 0)."""
    return (x - x.mean()) / (x.std(correction=0) + 1e-8)


def calculate_returns(rewards: torch.Tensor, discount: float, *, normalize: bool = True,
                      compat_forward: bool = False) -> torch.Tensor:
    """Discounted returns (ppo_train.py:348-357) -> (T, 1).

    Standard: R_t = r_t + discount R_{t+1} (reverse accumulation).  The
    reference accumulates in forward order and inserts each sum at the
    front: ``compat_forward=True`` reproduces it.  The sums run in the JAX
    scan's order, on the device."""
    r = rewards.reshape(-1)
    n = r.shape[0]
    acc = torch.zeros((), dtype=r.dtype, device=r.device)
    out = []
    for i in (range(n) if compat_forward else range(n - 1, -1, -1)):
        acc = r[i] + acc * discount
        out.append(acc)
    # reverse order: out[j] is R_{n-1-j}; forward order: the reference's
    # insert(0, .) reverses the sums
    returns = torch.stack(out).flip(0).reshape(-1, 1)
    return _normalize(returns) if normalize else returns


def calculate_advantages(returns: torch.Tensor, values: torch.Tensor, *,
                         normalize: bool = True) -> torch.Tensor:
    adv = returns - values
    return _normalize(adv) if normalize else adv


def update_policy_step(state: PPOState, state_cfgs, cfg: PPOConfig, txs, agent_all: dict,
                       expert_all: dict, advantages: torch.Tensor, returns: torch.Tensor,
                       mesh=None) -> Tuple[PPOState, dict]:
    """One clipped-surrogate actor update and one critic MSE update
    (ppo_train.py:380-412) -> (state', {"actor_loss", "policy_loss",
    "value_loss"} as 0-d device tensors).  Updates both trees in place.
    ``mesh``: the transitions, advantages and returns are this rank's dp
    rows, the trees its tp shards; the metrics are the global ones."""
    acfg, ccfg, _ = state_cfgs
    atx, ctx = txs
    old_logp = agent_all["log_action"].detach()                 # (N, n_act, F)
    adv = advantages.detach()[:, :, None]                        # (N, 1, 1)
    returns = returns.detach()
    states = agent_all["state"]

    def actor_loss_fn(ap):
        h = lt.forward_hidden(ap, acfg, states, deterministic=True, dp_mesh=mesh)
        _, new_logp = _policy_logprobs(lt.forward_output(ap, acfg, h, mesh), cfg.n_actions)
        ratio = torch.exp(new_logp - old_logp)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1.0 - cfg.ppo_clip, 1.0 + cfg.ppo_clip) * adv
        policy_loss = -batch_mean(torch.minimum(surr1, surr2), mesh)
        ce = lt.train_losses(ap, acfg, states, expert_all["state"], expert_all["mask_state"],
                             deterministic=True, dp_mesh=mesh)
        return policy_loss + torch.mean(ce), policy_loss

    def critic_loss_fn(cp):
        values = critic_lib.value_produce(cp, ccfg, states, dp_mesh=mesh)[:, None]
        return batch_mean((returns - values) ** 2, mesh), None

    a_loss, p_loss, a_grads = optim.value_and_grad(actor_loss_fn, state.actor_params, mesh)
    v_loss, _, c_grads = optim.value_and_grad(critic_loss_fn, state.critic_params, mesh)
    a_up, actor_opt = atx.update(a_grads, state.actor_opt, state.actor_params, mesh=mesh)
    optim.apply_updates(state.actor_params, a_up)
    c_up, critic_opt = ctx.update(c_grads, state.critic_opt, state.critic_params, mesh=mesh)
    optim.apply_updates(state.critic_params, c_up)
    new_state = PPOState(state.actor_params, state.critic_params, state.reward_params,
                         actor_opt, critic_opt)
    return new_state, {"actor_loss": a_loss.detach(), "policy_loss": p_loss.detach(),
                       "value_loss": v_loss.detach()}


def update_policy(state: PPOState, state_cfgs, cfg: PPOConfig, txs, agent_all: dict,
                  expert_all: dict, advantages: torch.Tensor, returns: torch.Tensor,
                  mesh=None) -> Tuple[PPOState, dict]:
    """cfg.ppo_steps updates (ppo_train.py:365-417) -> (state', the mean of
    each metric over the steps, 0-d device tensors: nothing is read on the
    host here)."""
    steps = []
    for _ in range(cfg.ppo_steps):
        state, metrics = update_policy_step(state, state_cfgs, cfg, txs, agent_all, expert_all,
                                            advantages, returns, mesh)
        steps.append(metrics)
    return state, {k: torch.stack([m[k] for m in steps]).mean() for k in steps[0]}
