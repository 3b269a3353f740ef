"""Sliding-window (Longformer-style) attention: the counterpart of the JAX
package's ``ops/window_attention.py``.

Each token attends bidirectionally within +-(window // 2) positions (HF's
one-sided window convention), with padding masked out.  Plain PyTorch
compositions in the two layouts, (B, H, S, D) and the head-minor (B, S, H,
D) that the fused-tail Longformer layer uses, each in a dense banded form
and in an O(S * window) blocked form, with the JAX dispatch between them:

  * ``window_attention`` takes the blocked form when S > block_threshold
    and S > 2 * window, else the dense form; in the blocked case it takes
    kernel E (``ops/window_attention_kernel.py window_attention_band``, the
    counterpart of ``window_attention_pallas``) when, in addition, there is
    no ``rel_emb``, window // 2 <= 256 and RLMG_WINDOW_BACKEND=pallas;
  * ``window_attention_bshe`` has the same dense / blocked rule and no
    kernel.

Masks are additive and finite (``NEG_INF`` = -1e9), as in the JAX package.
The optional ``rel_emb`` adds BERT's ``relative_key`` score term.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def _use_pallas_band() -> bool:
    """RLMG_WINDOW_BACKEND=pallas opts into kernel E for long sequences."""
    return os.environ.get("RLMG_WINDOW_BACKEND") == "pallas"


def band_mask(seq_len: int, one_sided_window: int, dtype=torch.float32,
              device="cpu") -> torch.Tensor:
    """(S, S) additive mask: 0 inside the band, NEG_INF outside."""
    pos = torch.arange(seq_len, device=device)
    inside = (pos[:, None] - pos[None, :]).abs() <= one_sided_window
    return torch.where(inside, 0.0, NEG_INF).to(dtype)


def _pad_mask(attention_mask: torch.Tensor, dtype) -> torch.Tensor:
    return torch.where(attention_mask > 0, 0.0, NEG_INF).to(dtype)


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     attention_mask: Optional[torch.Tensor], *, window: int,
                     rel_emb: Optional[torch.Tensor] = None,
                     block_threshold: int = 1024) -> torch.Tensor:
    """q, k, v (B, H, S, D); attention_mask (B, S) 1 = keep; window = full
    window (HF ``attention_window``).  Returns (B, H, S, D)."""
    s = q.shape[2]
    if s > block_threshold and s > 2 * window:
        if rel_emb is None and window // 2 <= 256 and _use_pallas_band():
            from .window_attention_kernel import window_attention_band
            return window_attention_band(q, k, v, attention_mask, window)
        return window_attention_blocked(q, k, v, attention_mask, window=window,
                                        rel_emb=rel_emb)
    return _window_attention_dense(q, k, v, attention_mask, window=window, rel_emb=rel_emb)


def _rel_positions(rel_emb: torch.Tensor, row: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """rel_emb rows for the distances row - col, clipped to +-max_rel."""
    max_rel = (rel_emb.shape[0] - 1) // 2
    return rel_emb[torch.clamp(row - col, -max_rel, max_rel) + max_rel]


def _window_attention_dense(q, k, v, attention_mask, *, window, rel_emb):
    s, d = q.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if rel_emb is not None:
        pos = torch.arange(s, device=q.device)
        rel = _rel_positions(rel_emb, pos[:, None], pos[None, :])          # (S, S, D)
        scores = scores + torch.einsum("bhqd,qkd->bhqk", q, rel) * scale
    scores = scores + band_mask(s, max(1, window // 2), scores.dtype, q.device)[None, None]
    if attention_mask is not None:
        scores = scores + _pad_mask(attention_mask, scores.dtype)[:, None, None, :]
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), v)


def _block_bands(blk: int, w: int, dtype, device):
    """(row, col, band) of one query block against its blk + 2w keys:
    query i (absolute qs + i) sees key j (absolute qs - w + j) iff
    0 <= j - i <= 2w."""
    row = torch.arange(blk, device=device)[:, None]
    col = torch.arange(blk + 2 * w, device=device)[None, :]
    inside = (col >= row) & (col <= row + 2 * w)
    return row, col, torch.where(inside, 0.0, NEG_INF).to(dtype)


def window_attention_blocked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             attention_mask: Optional[torch.Tensor], *, window: int,
                             rel_emb: Optional[torch.Tensor] = None,
                             block: int = 256) -> torch.Tensor:
    """O(S * (block + window)) memory: queries in blocks of ``block``, each
    against the keys [block start - w, block end + w) of a w-padded copy of
    k and v.  The same numbers as the dense banded form (same mask rule)."""
    b, h, s, d = q.shape
    w = max(1, window // 2)
    blk = max(block, w)
    pad_s = (-s) % blk
    scale = 1.0 / math.sqrt(d)
    qp = F.pad(q, (0, 0, 0, pad_s))
    kp = F.pad(k, (0, 0, w, w + pad_s))
    vp = F.pad(v, (0, 0, w, w + pad_s))
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    mp = F.pad(attention_mask.to(q.dtype), (w, w + pad_s))
    row, col, band = _block_bands(blk, w, q.dtype, q.device)
    kw = blk + 2 * w
    rel = None if rel_emb is None else _rel_positions(rel_emb, row + w, col)   # (blk, kw, D)
    outs = []
    for qs in range(0, s + pad_s, blk):
        qb, kb, vb = qp[:, :, qs:qs + blk], kp[:, :, qs:qs + kw], vp[:, :, qs:qs + kw]
        scores = torch.einsum("bhqd,bhkd->bhqk", qb, kb) * scale
        if rel is not None:
            scores = scores + torch.einsum("bhqd,qkd->bhqk", qb, rel) * scale
        scores = scores + band[None, None] + _pad_mask(mp[:, qs:qs + kw],
                                                       scores.dtype)[:, None, None, :]
        outs.append(torch.einsum("bhqk,bhkd->bhqd", torch.softmax(scores, dim=-1), vb))
    return torch.cat(outs, dim=2)[:, :, :s]


# -- (B, S, H, D) layout: q/k/v/att are plain reshapes of the projections --------

def window_attention_bshe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          attention_mask: Optional[torch.Tensor], *, window: int,
                          rel_emb: Optional[torch.Tensor] = None,
                          block_threshold: int = 1024, block: int = 256) -> torch.Tensor:
    """q, k, v (B, S, H, D) -> (B, S, H, D); the dense / blocked rule of
    ``window_attention`` (no kernel)."""
    s = q.shape[1]
    if s > block_threshold and s > 2 * window:
        return _window_blocked_bshe(q, k, v, attention_mask, window=window, rel_emb=rel_emb,
                                    block=block)
    return _window_dense_bshe(q, k, v, attention_mask, window=window, rel_emb=rel_emb)


def _window_dense_bshe(q, k, v, attention_mask, *, window, rel_emb):
    s, d = q.shape[1], q.shape[3]
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if rel_emb is not None:
        pos = torch.arange(s, device=q.device)
        rel = _rel_positions(rel_emb, pos[:, None], pos[None, :])
        scores = scores + torch.einsum("bqhd,qkd->bhqk", q, rel) * scale
    scores = scores + band_mask(s, max(1, window // 2), scores.dtype, q.device)[None, None]
    if attention_mask is not None:
        scores = scores + _pad_mask(attention_mask, scores.dtype)[:, None, None, :]
    return torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)


def _window_blocked_bshe(q, k, v, attention_mask, *, window, rel_emb, block=256):
    b, s, h, d = q.shape
    w = max(1, window // 2)
    blk = max(block, w)
    pad_s = (-s) % blk
    scale = 1.0 / math.sqrt(d)
    qp = F.pad(q, (0, 0, 0, 0, 0, pad_s))
    kp = F.pad(k, (0, 0, 0, 0, w, w + pad_s))
    vp = F.pad(v, (0, 0, 0, 0, w, w + pad_s))
    if attention_mask is None:
        attention_mask = torch.ones((b, s), dtype=q.dtype, device=q.device)
    mp = F.pad(attention_mask.to(q.dtype), (w, w + pad_s))
    row, col, band = _block_bands(blk, w, q.dtype, q.device)
    kw = blk + 2 * w
    rel = None if rel_emb is None else _rel_positions(rel_emb, row + w, col)
    outs = []
    for qs in range(0, s + pad_s, blk):
        qb, kb, vb = qp[:, qs:qs + blk], kp[:, qs:qs + kw], vp[:, qs:qs + kw]
        scores = torch.einsum("bqhd,bkhd->bhqk", qb, kb) * scale
        if rel is not None:
            scores = scores + torch.einsum("bqhd,qkd->bhqk", qb, rel) * scale
        scores = scores + band[None, None] + _pad_mask(mp[:, qs:qs + kw],
                                                       scores.dtype)[:, None, None, :]
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), vb))
    return torch.cat(outs, dim=1)[:, :s]
