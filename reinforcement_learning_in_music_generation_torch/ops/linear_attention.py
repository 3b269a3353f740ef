"""Causal linear attention, recurrent single-token form.

Counterpart of the decode half of the JAX package's
``ops/linear_attention.py`` (``feature_map``, ``init_attention_state``,
``linear_attention_step``).  The chunked causal product used by training
is not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

DEFAULT_EPS = 1e-6


def feature_map(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1 (fast_transformers' default feature map)."""
    return torch.where(x > 0, x + 1.0, torch.exp(torch.clamp(x, max=0.0)))


def init_attention_state(batch: int, n_head: int, d_head: int,
                         d_value: Optional[int] = None, dtype=torch.float32,
                         device="cuda"):
    """Zero (S, z) state for one layer: (B, H, E, F) and (B, H, E)."""
    d_value = d_value or d_head
    return (torch.zeros((batch, n_head, d_head, d_value), dtype=dtype, device=device),
            torch.zeros((batch, n_head, d_head), dtype=dtype, device=device))


def linear_attention_step(q, k, v, state, *, eps: float = DEFAULT_EPS):
    """One-token update. q/k/v: (B, H, E) raw (feature map applied here).

    Returns (out (B, H, F), new_state).  S += phi(k) v^T happens before the
    read, so position i attends to j <= i (self included)."""
    s_c, z_c = state
    pq, pk = feature_map(q), feature_map(k)
    s_c = s_c + pk[..., :, None] * v[..., None, :]
    z_c = z_c + pk
    num = torch.einsum("bhe,bhef->bhf", pq, s_c)
    den = torch.einsum("bhe,bhe->bh", pq, z_c) + eps
    return num / den[..., None], (s_c, z_c)
