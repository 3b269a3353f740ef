"""PPO critic: a linear-transformer trunk plus per-field scalar value heads
(counterpart of the JAX package's ``models/critic.py``).

Reference: Critic_Transformer (ppo_policy/model.py:285-394).  The value is
the mean over fields of the sequence mean of Linear(V_f -> 1) applied to
each field's logits (model.py:382-394).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..config import LinearTransformerConfig
from . import common as cm
from . import linear_transformer as lt


def init_params(cfg: LinearTransformerConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None, device="cuda") -> dict:
    """The trunk (``lt.init_params``) and ``value_heads``: one
    ``init_linear(V_f, 1)`` per field, with the JAX shapes and
    distributions (not its values)."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    params = lt.init_params(cfg, generator=generator, device=device)
    params["value_heads"] = {
        n: cm.init_linear(v, 1, generator=generator, device=device)
        for n, v in zip(cm.field_names(cfg.n_fields), cfg.vocab_sizes)}
    return params


def value_produce(params: dict, cfg: LinearTransformerConfig, x: torch.Tensor, *,
                  deterministic: bool = True, generator: Optional[torch.Generator] = None,
                  attn_backend: Optional[str] = None, dp_mesh=None) -> torch.Tensor:
    """x (B, S, n_fields) -> value (B,) (ppo_policy/model.py:345-394).
    ``dp_mesh``: x is this rank's rows, and under tp the trunk's leaves the
    rank's shards (``lt.forward_hidden``); the value heads are whole and
    read the reduced, replicated logits."""
    h = lt.forward_hidden(params, cfg, x, deterministic=deterministic, generator=generator,
                          attn_backend=attn_backend, dp_mesh=dp_mesh)
    logits = lt.forward_output(params, cfg, h, dp_mesh)
    names = cm.field_names(cfg.n_fields)
    vals = [torch.mean(cm.linear_scalar(params["value_heads"][n], lg), dim=1)
            for n, lg in zip(names, logits)]
    return sum(vals) / len(vals)
