"""Configuration dataclasses (own copy of the JAX package's ``config.py``).

Only what the ported paths use: the causal linear-attention transformer's
config, the generation config and the flagship ``agent_config`` preset.
Field names and defaults match the JAX package; the training-only fields
(dropout, attention chunk and backend, remat, scan unroll) come with the
training slice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class LinearTransformerConfig:
    """Causal linear-attention transformer (dqn_policy/model.py:97-161)."""

    vocab_sizes: Tuple[int, ...] = (56, 135, 18, 87, 18, 25)
    emb_sizes: Tuple[int, ...] = (128, 256, 64, 512, 128, 128)
    d_model: int = 512
    n_layer: int = 12
    n_head: int = 8
    d_inner: int = 2048
    max_len: int = 20000           # sinusoidal table size
    attn_eps: float = 1e-6         # linear-attention denominator epsilon
    with_value_head: bool = False  # PPO actor adds one

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)


def agent_config(vocab_sizes=(56, 135, 18, 87, 18, 25), **kw) -> LinearTransformerConfig:
    """dqn_policy/config.py:11-15 AgentConfig (D_MODEL 512, 12L, 8H)."""
    return LinearTransformerConfig(vocab_sizes=tuple(vocab_sizes), **kw)


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    """Generation entry (dqn_policy/testing-no-type-cp.py:33-35)."""

    n_songs: int = 5
    bar_production: int = 50
    max_tokens: int = 4096          # decode length upper bound
    token_count: Optional[int] = None  # PPO-style fixed token budget
    greedy: bool = False
    batch_size: int = 1             # songs generated simultaneously
    out_dir: str = "gen_midis"
    seed: int = 0
