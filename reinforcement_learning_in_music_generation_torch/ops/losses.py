"""Loss ops shared by pretrain and RL: the counterpart of the JAX package's
``ops/losses.py``.

Masked per-field cross-entropy as the reference computes it:
CrossEntropyLoss(reduction='none') * mask, summed and divided by mask.sum()
(dqn_policy/model.py:109, 163-167).  The CE always reduces in float32.

Under a dp mesh (``parallel/mesh.py``) the loss is JAX's over the GLOBAL
batch, sum(ce * mask) / max(sum(mask), 1) with both sums over every dp
index's rows: each rank divides its own numerator by the denominator
all-reduced over its dp group, so the losses, and their gradients, of the
ranks of a dp group sum to the global ones (the caller all-reduces both over
that group).  The ranks of a tp group hold the same rows, so the world's
sum would count each row tp times.  The mean of the ranks' own means is another loss
wherever their mask sums differ.  The denominator is data: no gradient.

Every other batch mean follows the same rule (``batch_mean``, the RL
losses): the rank's sum over the element count all-reduced over the dp
group.  It is right both where the batch is split over dp and where dp
does not divide it and every rank holds it whole (``parallel/mesh.py
shard_rows``): summed over the dp group, the ranks' shares give the global
mean.  A rank's own mean summed over dp is dp times it in both cases.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def _mask_sum(mask: torch.Tensor, mesh) -> torch.Tensor:
    """sum(mask), over every dp index's rows under a mesh."""
    den = mask.float().sum().detach()
    if mesh is not None and mesh.dp > 1:
        from ..parallel.mesh import all_reduce_
        all_reduce_(mesh, [den], axis="dp")
    return den


def batch_mean(x: torch.Tensor, mesh=None) -> torch.Tensor:
    """The mean of ``x``'s elements; under a dp ``mesh`` this rank's share
    of the global mean, sum(x) over the element count all-reduced over the
    dp group (no gradient through the count), which the caller sums over
    that group with the gradients."""
    if mesh is None or mesh.dp == 1:
        return torch.mean(x)
    from ..parallel.mesh import all_reduce_
    count = torch.full((), float(x.numel()), device=x.device)
    all_reduce_(mesh, [count], axis="dp")
    return x.sum() / count


def masked_cross_entropy(logits: torch.Tensor, targets: torch.Tensor,
                         mask: torch.Tensor, den: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (B,S,V), targets (B,S) int, mask (B,S) {0,1} -> scalar
    sum(ce * mask) / max(den, 1); ``den`` defaults to sum(mask) (the global
    one under a dp mesh: ``fields_cross_entropy``)."""
    logits = logits.float()
    gold = torch.gather(logits, -1, targets.long()[..., None])[..., 0]
    ce = torch.logsumexp(logits, dim=-1) - gold
    mask = mask.to(ce.dtype)
    if den is None:
        den = mask.sum()
    return (ce * mask).sum() / torch.clamp(den, min=1.0)


def fields_cross_entropy(logits_per_field: Sequence[torch.Tensor], targets: torch.Tensor,
                         mask: torch.Tensor, mesh=None) -> torch.Tensor:
    """Per-field masked CE, stacked: targets (B,S,n_fields) -> (n_fields,)
    (dqn_policy/model.py:170-197; callers average); under a dp ``mesh`` this
    rank's share of the global losses (one all-reduce for the fields'
    shared denominator)."""
    den = _mask_sum(mask, mesh)
    return torch.stack([masked_cross_entropy(lg, targets[..., i], mask, den=den)
                        for i, lg in enumerate(logits_per_field)])


def binary_cross_entropy(pred: torch.Tensor, target: torch.Tensor, mesh=None) -> torch.Tensor:
    """BCE on probabilities (torch nn.BCELoss, dqn_policy/AIRL.py:43), with
    the prediction clipped to [1e-7, 1 - 1e-7] as in the JAX package; the
    mean is ``batch_mean``'s under a dp ``mesh``."""
    pred = torch.clamp(pred, 1e-7, 1.0 - 1e-7)
    return -batch_mean(target * torch.log(pred) + (1.0 - target) * torch.log1p(-pred), mesh)
