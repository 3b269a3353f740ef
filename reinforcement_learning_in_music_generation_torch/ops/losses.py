"""Loss ops shared by pretrain and RL: the counterpart of the JAX package's
``ops/losses.py``.

Masked per-field cross-entropy as the reference computes it:
CrossEntropyLoss(reduction='none') * mask, summed and divided by mask.sum()
(dqn_policy/model.py:109, 163-167).  The CE always reduces in float32.
"""

from __future__ import annotations

from typing import Sequence

import torch


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """logits (B,S,V), targets (B,S) int, mask (B,S) {0,1} -> scalar
    sum(ce * mask) / max(sum(mask), 1)."""
    logits = logits.float()
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - gold
    mask = mask.to(ce.dtype)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def fields_cross_entropy(logits_per_field: Sequence[torch.Tensor], targets: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Per-field masked CE, stacked: targets (B,S,n_fields) -> (n_fields,)
    (dqn_policy/model.py:170-197; callers average)."""
    return torch.stack([masked_cross_entropy(lg, targets[..., i], mask)
                        for i, lg in enumerate(logits_per_field)])


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """BCE on probabilities (torch nn.BCELoss, dqn_policy/AIRL.py:43), with
    the prediction clipped to [1e-7, 1 - 1e-7] as in the JAX package."""
    pred = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -torch.mean(target * torch.log(pred) + (1.0 - target) * torch.log1p(-pred))
