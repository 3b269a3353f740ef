"""Configuration dataclasses (own copy of the JAX package's ``config.py``).

Only what the ported paths use: the causal linear-attention transformer's
config and its ``agent_config`` / ``actor_config`` / ``critic_config``
presets, the sliding-window (Longformer) encoder's config and its three
presets, the generation, pretrain, DQN, AIRL and PPO configs, and the mesh
layout (``MeshConfig``).  Field
names and defaults match the JAX package (``MeshConfig`` adds ``pp``, an
argument of JAX's ``make_pp_mesh``).  Left out: ``scan_unroll`` (the
port runs its layer loops eagerly, there is no scan to unroll) and
``PretrainConfig.prng_impl`` (a JAX PRNG choice).
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
    remat: bool = False            # per-layer recompute (torch.utils.checkpoint)
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


def actor_config(vocab_sizes=(49, 19, 19, 89, 67, 25), **kw) -> LinearTransformerConfig:
    """ppo_policy/config.py:39-43 ActorConfig + value head (model.py:154-158)."""
    kw.setdefault("with_value_head", True)
    return LinearTransformerConfig(vocab_sizes=tuple(vocab_sizes), **kw)


def critic_config(vocab_sizes=(49, 19, 19, 89, 67, 25), **kw) -> LinearTransformerConfig:
    """ppo_policy/config.py:45-49 CriticConfig (critic adds field value heads)."""
    return LinearTransformerConfig(vocab_sizes=tuple(vocab_sizes), **kw)


@dataclasses.dataclass(frozen=True)
class WindowTransformerConfig:
    """Longformer-style sliding-window encoder.

    Three reference variants:
      * AIRL discriminator: 10 layers, window 50, max_pos 2048, score head
        (dqn_policy/AIRL_model.py:78-99)
      * PPO reward model: 12 layers, window 512, max_pos 2048, eval heads
        (ppo_policy/model.py:400-451, ppo_policy/config.py:53-58)
      * discrim-pretrain LM: 12 layers, window 512, max_pos 4096, absolute
        positions, 7 fields (dqn_policy/discrim-pretrain.py:239-249)
    """

    vocab_sizes: Tuple[int, ...] = (56, 135, 18, 87, 18, 25)
    emb_sizes: Tuple[int, ...] = (128, 256, 64, 512, 256, 256)
    d_model: int = 512
    n_layer: int = 10
    n_head: int = 8
    d_inner: int = 1024
    dropout: float = 0.1
    max_pos: int = 2048
    attention_window: int = 50      # full window (w/2 on each side)
    position_embedding_type: str = "absolute"  # or "relative_key"
    with_score_head: bool = True    # score_classifier MLP (AIRL_model.py:91-99)
    with_eval_heads: bool = False   # per-field scalar eval heads (IRL_model.py)
    dtype: str = "float32"

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_head

    @property
    def n_fields(self) -> int:
        return len(self.vocab_sizes)


def airl_discriminator_config(vocab_sizes=(56, 135, 18, 87, 18, 25),
                              **kw) -> WindowTransformerConfig:
    """dqn_policy/AIRL_model.py:78-90 (10L, window 50).  Absolute positions:
    the reference requests ``relative_key``, which HF's
    LongformerSelfAttention never reads (see ``models/longformer.py``)."""
    kw.setdefault("n_layer", 10)
    kw.setdefault("attention_window", 50)
    kw.setdefault("max_pos", 2048)
    kw.setdefault("position_embedding_type", "absolute")
    kw.setdefault("with_score_head", True)
    return WindowTransformerConfig(vocab_sizes=tuple(vocab_sizes), **kw)


def ppo_reward_config(vocab_sizes=(49, 19, 19, 89, 67, 25), **kw) -> WindowTransformerConfig:
    """ppo_policy/model.py:400-451 reward model (12L, window 512), absolute
    positions for the same reason as ``airl_discriminator_config``."""
    kw.setdefault("n_layer", 12)
    kw.setdefault("attention_window", 512)
    kw.setdefault("max_pos", 2048)
    kw.setdefault("position_embedding_type", "absolute")
    kw.setdefault("with_score_head", False)
    kw.setdefault("with_eval_heads", True)
    return WindowTransformerConfig(vocab_sizes=tuple(vocab_sizes), **kw)


def discrim_lm_config(vocab_sizes=(56, 135, 18, 3, 87, 18, 25),
                      **kw) -> WindowTransformerConfig:
    """dqn_policy/discrim-pretrain.py:239-249 LM variant (7 fields incl type)."""
    kw.setdefault("n_layer", 12)
    kw.setdefault("attention_window", 512)
    kw.setdefault("max_pos", 4096)
    kw.setdefault("position_embedding_type", "absolute")
    kw.setdefault("with_score_head", False)
    kw.setdefault("emb_sizes", (128, 256, 64, 32, 512, 256, 128))
    return WindowTransformerConfig(vocab_sizes=tuple(vocab_sizes), **kw)


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
    zero1: bool = False             # ZeRO-1: Adam's moments sliced over the mesh's dp
    prefetch_depth: int = 2         # host->device input look-ahead
    grad_accum: int = 1             # micro-batches per optimizer step
    ckpt_backend: str = "pickle"    # "orbax" is not ported (raises, ROADMAP item 9(e))
    save_on_interrupt: bool = False  # SIGTERM/SIGINT: checkpoint and return


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    """DQN + AIRL fine-tune (dqn_policy/IRL_dqn_train.py:42-65)."""

    num_songs: int = 1500
    episodes: int = 50
    seq_len: int = 1000
    n_states: int = 50              # window / state size
    n_actions: int = 25
    n_features: int = 6
    buffer_size: int = 20000
    batch_size: int = 30
    lr: float = 0.01
    lr_milestones: Tuple[int, ...] = (20, 40)
    lr_gamma: float = 0.1
    gamma: float = 0.95             # reward discount
    target_update: int = 50
    alpha: float = 0.3              # 0.3*MSE + 0.7*CE (IRL_dqn_train.py:332-336)
    ckpt_epoch_gate: int = 410      # checkpoint gate (IRL_dqn_train.py:362)
    seed: int = 0


@dataclasses.dataclass(frozen=True)
class AIRLConfig:
    """AIRL discriminator trainer (dqn_policy/AIRL.py:51-58)."""

    lr: float = 0.001
    epochs: int = 5
    batch_size: int = 100
    lr_step: int = 10               # StepLR period, in minibatches
    lr_gamma: float = 0.1
    score_batch_size: int = 100     # buffer re-scoring batch (train-mode BN: sets the values)


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """PPO fine-tune (ppo_policy/ppo_train.py:34-57)."""

    num_songs: int = 1000
    episodes: int = 30
    n_states: int = 50
    n_actions: int = 25
    n_features: int = 6
    ppo_steps: int = 10
    ppo_clip: float = 0.2
    discount: float = 0.99
    lr: float = 0.01
    seed: int = 0
    # The reference discounts rewards in forward order (ppo_train.py:348-357);
    # the default fixes it, True reproduces it.
    compat_forward_returns: bool = False


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Mesh layout: ``dp`` ranks, each a process, times ``pp`` pipeline
    stages times ``tp``."""

    dp: int = -1    # -1: infer from the world size / (pp tp)
    tp: int = 1
    pp: int = 1

    def axis_sizes(self, n_devices: int) -> Tuple[int, int]:
        """(dp, tp) on ``n_devices`` ranks."""
        tp = max(1, self.tp)
        dp = self.dp if self.dp > 0 else max(1, n_devices // (tp * max(1, self.pp)))
        return dp, tp

    def n_ranks(self) -> int:
        """dp x pp x tp, the processes a run starts (dp given)."""
        return max(1, self.dp) * max(1, self.pp) * max(1, self.tp)
