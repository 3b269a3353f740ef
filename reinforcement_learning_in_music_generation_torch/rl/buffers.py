"""Fixed-shape replay buffers on the device: the counterpart of the JAX
package's ``rl/buffers.py``.

A buffer is a dict of device tensors, each (capacity, ...), plus a counter
of all stores (a host int, so reading it syncs nothing).  Stores write into
the tensors in place, at counter % capacity, and return the buffer with the
counter moved on (the JAX buffer is rebuilt by ``.at[].set``).  Sampling is
uniform over the whole capacity, as the reference's
``np.random.choice(BUFFER_SIZE, batch)`` (IRL_dqn_train.py:107); callers
sample once the buffer is full.

Agent layout (IRL_dqn_train.py:80-86): state (50, 6), action (25, 6),
reward (1,), next_state (50, 6), done (1,).  The expert variant adds the
state and next-state masks (:144-146).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch


class ReplayBuffer(NamedTuple):
    data: Dict[str, torch.Tensor]   # each (capacity, ...)
    counter: int                    # total stores (monotonic)

    @property
    def capacity(self) -> int:
        return next(iter(self.data.values())).shape[0]


def agent_field_specs(n_states=50, n_actions=25, n_features=6) -> Dict[str, Tuple]:
    return {
        "state": ((n_states, n_features), torch.int32),
        "action": ((n_actions, n_features), torch.int32),
        "reward": ((1,), torch.float32),
        "next_state": ((n_states, n_features), torch.int32),
        "done": ((1,), torch.int32),
    }


def expert_field_specs(n_states=50, n_actions=25, n_features=6) -> Dict[str, Tuple]:
    specs = agent_field_specs(n_states, n_actions, n_features)
    specs["mask_state"] = ((n_states,), torch.float32)
    specs["mask_next_state"] = ((n_states,), torch.float32)
    return specs


def ppo_field_specs(n_states=50, n_actions=25, n_features=6) -> Dict[str, Tuple]:
    """PPO adds the value and the per-action log-probs (ppo_train.py:71-79)."""
    specs = agent_field_specs(n_states, n_actions, n_features)
    specs["value"] = ((1,), torch.float32)
    specs["log_action"] = ((n_actions, n_features), torch.float32)
    return specs


def buffer_init(capacity: int, specs: Dict[str, Tuple], device="cuda") -> ReplayBuffer:
    data = {k: torch.zeros((capacity,) + tuple(shape), dtype=dtype, device=device)
            for k, (shape, dtype) in specs.items()}
    return ReplayBuffer(data=data, counter=0)


def buffer_store(buf: ReplayBuffer, transition: Dict[str, torch.Tensor]) -> ReplayBuffer:
    """One transition into slot counter % capacity (in place)."""
    idx = buf.counter % buf.capacity
    for k, v in transition.items():
        buf.data[k][idx] = v.to(buf.data[k].dtype)
    return buf._replace(counter=buf.counter + 1)


def buffer_store_batch(buf: ReplayBuffer, transitions: Dict[str, torch.Tensor]) -> ReplayBuffer:
    """A stacked batch (T, ...) of transitions in ring order (in place)."""
    t = next(iter(transitions.values())).shape[0]
    dev = next(iter(buf.data.values())).device
    idx = (buf.counter + torch.arange(t, device=dev)) % buf.capacity
    for k, v in transitions.items():
        buf.data[k].index_copy_(0, idx, v.to(buf.data[k].dtype))
    return buf._replace(counter=buf.counter + t)


def buffer_sample(buf: ReplayBuffer, generator: torch.Generator,
                  batch_size: int) -> Dict[str, torch.Tensor]:
    """batch_size rows drawn uniformly over the whole capacity with
    ``generator`` (on the buffer's device)."""
    idx = torch.randint(0, buf.capacity, (batch_size,), generator=generator,
                        device=generator.device)
    return {k: v[idx.to(v.device)] for k, v in buf.data.items()}


def buffer_get(buf: ReplayBuffer) -> Dict[str, torch.Tensor]:
    return dict(buf.data)


def buffer_size(buf: ReplayBuffer) -> int:
    return min(buf.counter, buf.capacity)
