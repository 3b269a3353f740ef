"""Teacher-forced token "environment" rollouts on the device: the
counterpart of the JAX package's ``rl/env.py``.

The reference's env loop (dqn_policy/IRL_dqn_train.py:442-470) steps one
episode at a time: slide expert windows over the song, run the agent on the
current 50-token state, build next_state = concat(state[:25], action) (the
first half of the state, not a sliding window), store the transitions.  The
JAX package scans the episodes in one device program; here they are a
Python loop whose forwards run under ``torch.no_grad()`` and whose states
stay on the device, so no episode waits for the host.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..config import LinearTransformerConfig
from . import dqn as dqn_lib


def _windows(x: torch.Tensor, starts: torch.Tensor, size: int) -> torch.Tensor:
    """x[s : s + size] for each start, the start clamped into [0, len - size]
    as ``lax.dynamic_slice_in_dim`` clamps it."""
    starts = torch.clamp(starts, 0, x.shape[0] - size)
    return x[starts[:, None] + torch.arange(size, device=x.device)[None]]


def dqn_rollout_song(params: dict, mcfg: LinearTransformerConfig, song_x: torch.Tensor,
                     expert_y: torch.Tensor, song_mask: torch.Tensor, *, episodes: int = 50,
                     n_states: int = 50, n_actions: int = 25) -> Tuple[Dict, Dict]:
    """One song's episode loop (IRL_dqn_train.py:442-470).

    song_x: (S0, 6) agent stream; expert_y: (S1, 6) expert stream with
    S1 >= episodes + 2 n_states; song_mask: (S1,).  Returns
    (agent_transitions, expert_transitions), each stacked (episodes, ...);
    the rewards are the reference's placeholders 0.5 (agent) and 1.0
    (expert)."""
    dev = song_x.device
    state = song_x[:n_states].to(torch.int32)
    states, actions, nexts = [], [], []
    for _ in range(episodes):
        action = dqn_lib.choose_action(params, mcfg, state[None], n_actions=n_actions)[0]
        next_state = torch.cat([state[:n_actions], action], dim=0)
        states.append(state)
        actions.append(action)
        nexts.append(next_state)
        state = next_state
    action = torch.stack(actions)
    col = lambda v, dt: torch.full((episodes, 1), v, dtype=dt, device=dev)
    agent_t = {"state": torch.stack(states), "action": action,
               "reward": col(0.5, torch.float32), "next_state": torch.stack(nexts),
               "done": col(0, torch.int32)}
    num = torch.arange(episodes, device=dev)
    expert_t = {"state": _windows(expert_y, num, n_states).to(torch.int32), "action": action,
                "reward": col(1.0, torch.float32),
                "next_state": _windows(expert_y, num + n_states, n_states).to(torch.int32),
                "done": col(0, torch.int32),
                "mask_state": _windows(song_mask, num, n_states).to(torch.float32),
                "mask_next_state": _windows(song_mask, num + 1, n_states).to(torch.float32)}
    return agent_t, expert_t
