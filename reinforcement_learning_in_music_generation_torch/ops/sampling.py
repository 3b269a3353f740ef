"""On-device temperature / nucleus sampling, plain PyTorch.

Counterpart of the JAX package's ``ops/sampling.py`` (XLA ops there, so
plain tensor code here).  Semantics of the reference's host sampler
(dqn_policy/model.py:19-55):

  * ``softmax_with_temperature``: exp(l/t)/sum(exp(l/t))
  * nucleus: renormalize by (sum + 1e-5), sort desc, keep tokens up to and
    including the first index where the cumulative sum exceeds p,
    renormalize the kept set, sample
  * no-p path: plain weighted sampling from the temperature softmax
  * greedy: argmax (first maximal index)

Randomness comes from an explicit ``torch.Generator``; every sampler also
takes the uniform draw as an argument so tests can feed JAX and the port
the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch


class FieldSampling(NamedTuple):
    temperature: float = 1.0
    top_p: Optional[float] = None


# dqn_policy/model.py:282-287 (field order: tempo chord barbeat pitch dur vel)
CP_SAMPLING: Tuple[FieldSampling, ...] = (
    FieldSampling(1.2, 0.9),    # tempo
    FieldSampling(1.0, 0.99),   # chord
    FieldSampling(1.2, None),   # barbeat
    FieldSampling(1.0, 0.9),    # pitch
    FieldSampling(2.0, 0.9),    # duration
    FieldSampling(5.0, None),   # velocity
)

GREEDY = tuple(FieldSampling() for _ in range(6))


def softmax_with_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    scaled = logits / temperature
    scaled = scaled - scaled.max(dim=-1, keepdim=True).values
    e = torch.exp(scaled)
    return e / e.sum(dim=-1, keepdim=True)


def nucleus_mask(probs: torch.Tensor, p: float) -> torch.Tensor:
    """Boolean keep-mask: keep sorted position i iff cumsum_{i-1} <= p (the
    first prob that pushes the cumulative sum over p is still kept)."""
    probs = probs / (probs.sum(dim=-1, keepdim=True) + 1e-5)
    sorted_p, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    csum = torch.cumsum(sorted_p, dim=-1)
    keep_sorted = (csum - sorted_p) <= p
    return torch.zeros_like(keep_sorted).scatter(-1, order, keep_sorted)


def _uniform(generator, shape, device, u):
    if u is not None:
        return u.to(device=device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=device)


def sample(logits: torch.Tensor, *, temperature: float = 1.0,
           top_p: Optional[float] = None, greedy: bool = False,
           generator: Optional[torch.Generator] = None,
           u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sample token ids from logits (..., V) -> (...), by one inverse-CDF
    draw in sorted space.  ``u`` (...) overrides the uniform draw."""
    if greedy:
        return torch.argmax(logits, dim=-1)
    probs = softmax_with_temperature(logits.float(), temperature)
    sp, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    if top_p is None:
        keep = torch.ones_like(sp, dtype=torch.bool)
    else:
        sp = sp / (sp.sum(dim=-1, keepdim=True) + 1e-5)
        keep = (torch.cumsum(sp, dim=-1) - sp) <= top_p
    csum = torch.cumsum(sp, dim=-1)
    s_kept = (sp * keep).sum(dim=-1, keepdim=True)
    u = _uniform(generator, probs.shape[:-1], probs.device, u)[..., None] * s_kept
    idx = (csum <= u).sum(dim=-1)
    idx = torch.minimum(idx, keep.sum(dim=-1) - 1)
    return torch.gather(order, -1, idx[..., None])[..., 0]


def sample_fields(generator: Optional[torch.Generator],
                  logits_per_field: Sequence[torch.Tensor],
                  settings: Sequence[FieldSampling] = CP_SAMPLING, *,
                  greedy: bool = False,
                  uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One compound token: per-field logits (..., V_f) -> int32 (..., nf).
    ``uniforms`` (..., nf) overrides the draws."""
    words = [
        sample(lg, temperature=st.temperature, top_p=st.top_p, greedy=greedy,
               generator=generator,
               u=None if uniforms is None else uniforms[..., f])
        for f, (lg, st) in enumerate(zip(logits_per_field, settings))
    ]
    return torch.stack(words, dim=-1).to(torch.int32)


_FUSED_CONSTS: dict = {}


def _fused_consts(vocab_sizes: Sequence[int], settings: Sequence[FieldSampling], device):
    """The fused chain's constants on ``device``, made once per (vocab,
    settings, device) and kept, so a call issues no host-to-device copy (a
    CUDA graph can capture it): the gather map packing concatenated logits
    (B, sum V_f) into a padded (nf, Vmax) grid (idx int64, valid bool), the
    temperatures and the nucleus masses (inf where a field has none)."""
    key = (tuple(vocab_sizes), tuple(settings), str(device))
    hit = _FUSED_CONSTS.get(key)
    if hit is not None:
        return hit
    nf, vmax = len(vocab_sizes), max(vocab_sizes)
    idx = torch.zeros((nf, vmax), dtype=torch.long)
    valid = torch.zeros((nf, vmax), dtype=torch.bool)
    off = 0
    for f, v in enumerate(vocab_sizes):
        idx[f, :v] = torch.arange(off, off + v)
        valid[f, :v] = True
        off += v
    temps = torch.tensor([st.temperature for st in settings], dtype=torch.float32)
    topp = torch.tensor([st.top_p if st.top_p is not None else float("inf")
                         for st in settings], dtype=torch.float32)
    hit = tuple(t.to(device) for t in (idx.reshape(-1), valid, temps, topp))
    _FUSED_CONSTS[key] = hit
    return hit


def sample_fields_fused(generator: Optional[torch.Generator],
                        logits_cat: torch.Tensor,
                        vocab_sizes: Tuple[int, ...],
                        settings: Sequence[FieldSampling] = CP_SAMPLING, *,
                        greedy: bool = False,
                        uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits_cat (B, sum V_f) -> token ids (B, nf) int32, all fields in one
    padded sort-free chain (pairwise ranks replace the nucleus sort):

      rank_i = sum_j [p_j > p_i] + [j < i][p_j == p_i]
      csum_i = sum_j p_j * [rank_j <= rank_i]

    Same distribution as ``sample``; ``uniforms`` (B, nf) overrides the
    draw.  Materializes (B, nf, Vmax, Vmax) pairwise tensors."""
    b = logits_cat.shape[0]
    nf, vmax = len(vocab_sizes), max(vocab_sizes)
    dev = logits_cat.device
    idx, valid, temps, topp = _fused_consts(vocab_sizes, settings, dev)
    padded = logits_cat.float()[:, idx].reshape(b, nf, vmax)
    padded = torch.where(valid[None], padded, float("-inf"))
    if greedy:
        return torch.argmax(padded, dim=-1).to(torch.int32)

    scaled = padded / temps[None, :, None]
    scaled = scaled - scaled.max(dim=-1, keepdim=True).values
    e = torch.where(valid[None], torch.exp(scaled), torch.zeros((), device=dev))
    sp = e / (e.sum(dim=-1, keepdim=True) * (1.0 + 1e-5))

    pi = sp[..., :, None]
    pj = sp[..., None, :]
    ar = torch.arange(vmax, device=dev)
    before = (pj > pi) | ((pj == pi) & (ar[None, :] < ar[:, None]))
    rank = before.sum(dim=-1)                                  # (B, nf, V)
    csum = torch.where(rank[..., None, :] <= rank[..., :, None], pj,
                       torch.zeros((), device=dev)).sum(dim=-1)

    keep = (csum - sp) <= topp[None, :, None]
    nkeep = (keep & valid[None]).sum(dim=-1)
    s_kept = (sp * keep).sum(dim=-1)
    if uniforms is None:
        uniforms = torch.rand((b, nf), generator=generator, device=dev)
    u = uniforms.to(device=dev, dtype=torch.float32) * s_kept
    cnt = ((csum <= u[..., None]) & valid[None]).sum(dim=-1)
    sel_rank = torch.minimum(cnt, nkeep - 1)
    sel = (rank == sel_rank[..., None]) & valid[None]
    return torch.where(sel, ar[None, None], torch.zeros((), dtype=torch.long, device=dev)
                       ).sum(dim=-1).to(torch.int32)
