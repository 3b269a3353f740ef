"""Teacher-forced token "environment" rollouts on the device: the
counterpart of the JAX package's ``rl/env.py``.

The reference's env loop (dqn_policy/IRL_dqn_train.py:442-470) steps one
episode at a time: slide expert windows over the song, run the agent on the
current 50-token state, build next_state = concat(state[:25], action) (the
first half of the state, not a sliding window), store the transitions.  The
JAX package scans the episodes in one device program; here one episode is a
body on static buffers (``episode_graph.EpisodeLoop``): on CUDA one CUDA
graph replay an episode, elsewhere a Python loop, its forwards under
``torch.no_grad()`` and its states on the device, so no episode waits for
the host.

On a (dp, tp) mesh every rank runs the same rollout (``mesh``).  At tp = 1
each runs this graphed loop on its whole weights, without collectives.  At
tp > 1 the episodes run the Megatron forward on the rank's shards
eagerly: the tp collectives run over the process group, and the gloo
collectives the one-card runs take cannot be captured in a CUDA graph.
``tp_eager`` makes that choice from the mesh.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import LinearTransformerConfig
from . import dqn as dqn_lib
from . import episode_graph


def _windows(x: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """x[s : s + size] for each start, the start clamped into [0, len - size]
    as ``lax.dynamic_slice_in_dim`` clamps it."""
    starts = torch.clamp(starts, 0, x.shape[0] - size)
    return x[starts[:, None] + torch.arange(size, device=x.device)[None]]


def tp_eager(mesh) -> bool:
    """A rollout on ``mesh`` runs eagerly, with the mesh's collectives: tp >
    1.  At tp = 1 (or with no mesh) a rank's rollout needs no collective and
    takes the graphed loop, built without the mesh: only meshless loops
    are ever captured (``episode_graph.cached``)."""
    return mesh is not None and mesh.tp > 1


class _DqnEpisodes(episode_graph.EpisodeLoop):
    """A song's DQN episodes on static buffers: the current state, the
    stacked states, actions and next states, and the episode index;
    ``mesh``: the tp mesh of the weights' shards (None: whole weights)."""

    def __init__(self, mcfg: LinearTransformerConfig, episodes: int, n_states: int,
                 n_actions: int, nf: int, dev, mesh=None):
        super().__init__(dev)
        i32 = dict(dtype=torch.int32, device=dev)
        self.mcfg, self.n_actions, self.mesh = mcfg, n_actions, mesh
        self.state = torch.zeros((n_states, nf), **i32)
        self.states = torch.zeros((episodes, n_states, nf), **i32)
        self.actions = torch.zeros((episodes, n_actions, nf), **i32)
        self.nexts = torch.zeros((episodes, n_states, nf), **i32)
        self.idx = torch.zeros((1,), dtype=torch.long, device=dev)

    def body(self, trees) -> None:
        """One episode: the agent's action on the state, next_state =
        concat(state[:n_actions], action), both stored at the index."""
        action = dqn_lib.choose_action(trees[0], self.mcfg, self.state[None],
                                       n_actions=self.n_actions, mesh=self.mesh)
        nxt = torch.cat([self.state[:self.n_actions], action[0]], dim=0)
        self.states.index_copy_(0, self.idx, self.state[None])
        self.actions.index_copy_(0, self.idx, action)
        self.nexts.index_copy_(0, self.idx, nxt[None])
        self.state.copy_(nxt)
        self.idx.add_(1)


@torch.no_grad()
def dqn_rollout_song(params: dict, mcfg: LinearTransformerConfig, song_x: torch.Tensor,
                     expert_y: torch.Tensor, song_mask: torch.Tensor, *, episodes: int = 50,
                     n_states: int = 50, n_actions: int = 25, graph: bool = True,
                     mesh=None) -> Tuple[Dict, Dict]:
    """One song's episode loop (IRL_dqn_train.py:442-470).

    song_x: (S0, 6) agent stream; expert_y: (S1, 6) expert stream with
    S1 >= episodes + 2 n_states; song_mask: (S1,).  Returns
    (agent_transitions, expert_transitions), each stacked (episodes, ...),
    tensors of their own; the rewards are the reference's placeholders 0.5
    (agent) and 1.0 (expert).  On CUDA each episode is a replay of one CUDA
    graph, cached per weights (``episode_graph.cached``); ``graph=False``
    runs the eager loop there (for comparisons).  ``mesh``: every rank runs
    this same rollout; at tp > 1 ``params`` are the rank's tp shards and
    the loop runs eagerly (``tp_eager``)."""
    dev = song_x.device
    nf = song_x.shape[-1]
    ep_mesh = mesh if tp_eager(mesh) else None
    build = lambda: _DqnEpisodes(mcfg, episodes, n_states, n_actions, nf, dev, ep_mesh)
    graph = graph and dev.type == "cuda" and not tp_eager(mesh)
    ep = episode_graph.cached(("dqn", mcfg, episodes, n_states, n_actions, nf, dev),
                              (params,), build) if graph else build()
    ep.state.copy_(song_x[:n_states])
    ep.idx.zero_()
    ep.run(episodes, (params,), graph)
    action = ep.actions.clone()
    col = lambda v, dt: torch.full((episodes, 1), v, dtype=dt, device=dev)
    agent_t = {"state": ep.states.clone(), "action": action,
               "reward": col(0.5, torch.float32), "next_state": ep.nexts.clone(),
               "done": col(0, torch.int32)}
    num = torch.arange(episodes, device=dev)
    expert_t = {"state": _windows(expert_y, num, n_states).to(torch.int32), "action": action,
                "reward": col(1.0, torch.float32),
                "next_state": _windows(expert_y, num + n_states, n_states).to(torch.int32),
                "done": col(0, torch.int32),
                "mask_state": _windows(song_mask, num, n_states).to(torch.float32),
                "mask_next_state": _windows(song_mask, num + 1, n_states).to(torch.float32)}
    return agent_t, expert_t
