"""Configuration dataclasses (own copy of the JAX package's ``config.py``).

Only what the ported paths use: the causal linear-attention transformer's
config, the generation and pretrain configs and the flagship
``agent_config`` preset.  Field names and defaults match the JAX package.
Left out: ``scan_unroll`` (the port runs its layer loop eagerly, there is
no scan to unroll) and ``PretrainConfig.prng_impl`` (a JAX PRNG choice).
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
    dropout: float = 0.1
    attn_eps: float = 1e-6         # linear-attention denominator epsilon
    attn_chunk: int = 128          # linear-attention chunk length
    attn_backend: Optional[str] = None  # 'xla' / 'pallas-qkv' / 'pallas'; None = auto/env
    remat: bool = False            # per-layer recompute (not ported: raises)
    with_value_head: bool = False  # PPO actor adds one
    dtype: str = "float32"         # compute dtype ("bfloat16": f32 master weights)

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


@dataclasses.dataclass(frozen=True)
class PretrainConfig:
    """Agent pretrain loop (dqn_policy/agent_pretrain.py:38-54,516)."""

    n_epoch: int = 4000
    batch_size: int = 4
    lr: float = 1e-4
    grad_clip: float = 3.0
    early_stop_loss: float = 0.05   # agent_pretrain.py:629-632
    ckpt_dir: str = "./ckpt"
    exp_dir: str = "./exp"
    seed: int = 0
    log_every: int = 10             # batches between host-side loss fetches
    lr_milestones: Tuple[int, ...] = ()   # MultiStepLR milestones, in epochs
    lr_gamma: float = 0.1
    zero1: bool = False             # not ported (raises)
    prefetch_depth: int = 2         # host->device input look-ahead
    grad_accum: int = 1             # micro-batches per optimizer step
    ckpt_backend: str = "pickle"    # "orbax" is not ported (raises)
    save_on_interrupt: bool = False  # SIGTERM/SIGINT: checkpoint and return
