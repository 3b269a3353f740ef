"""Shared functional building blocks on plain dicts of tensors.

Counterpart of the JAX package's ``models/common.py``.  Initializers mirror
torch defaults used by the reference modules: nn.Embedding ~ N(0,1);
nn.Linear ~ U(+-1/sqrt(fan_in)) for weight and bias; LayerNorm ones/zeros.
The JAX RNG stream cannot be reproduced, so parity tests convert JAX
weights (``weights.from_jax_params``) instead of re-initializing.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch

FIELDS6 = ("tempo", "chord", "barbeat", "pitch", "duration", "velocity")
FIELDS7 = ("tempo", "chord", "barbeat", "type", "pitch", "duration", "velocity")


def field_names(n: int) -> Tuple[str, ...]:
    if n == 6:
        return FIELDS6
    if n == 7:
        return FIELDS7
    return tuple(f"field{i}" for i in range(n))


def fused_head_params(heads: dict, n_fields: int):
    """Per-field heads concatenated into one (D, sum V_f) product, packed in
    ``field_names`` order."""
    names = field_names(n_fields)
    hw = torch.cat([heads[n]["w"] for n in names], dim=1)
    hb = torch.cat([heads[n]["b"] for n in names])
    return hw, hb


def _uniform(shape, bound, generator, device, dtype):
    u = torch.rand(shape, generator=generator, device=device, dtype=dtype)
    return u * (2 * bound) - bound


def init_linear(d_in: int, d_out: int, *, generator: Optional[torch.Generator],
                device, dtype=torch.float32, stack: Tuple[int, ...] = ()) -> dict:
    bound = 1.0 / math.sqrt(d_in)
    return {"w": _uniform(stack + (d_in, d_out), bound, generator, device, dtype),
            "b": _uniform(stack + (d_out,), bound, generator, device, dtype)}


def linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    return x @ p["w"] + p["b"]


def linear_scalar(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Linear(d -> 1) as multiply and sum, returning (..., ): the JAX
    package's form, kept so the sums run in the same order."""
    return torch.sum(x * p["w"][..., 0], dim=-1) + p["b"][0]


def init_embedding(vocab: int, dim: int, *, generator, device,
                   dtype=torch.float32) -> torch.Tensor:
    return torch.randn((vocab, dim), generator=generator, device=device, dtype=dtype)


def scaled_embed(table: torch.Tensor, ids: torch.Tensor, dim: Optional[int] = None
                 ) -> torch.Tensor:
    """nn.Embedding * sqrt(d) (dqn_policy/model.py:67-74); ``dim``: d where
    ``table`` holds a column shard of it.  An embedding lookup, not
    ``table[ids]``: on a card the backward of advanced indexing walks each
    run of repeated ids serially, and with vocabularies of 18-135 ids over
    16384 rows that took 5.5 ms per field per step."""
    return torch.nn.functional.embedding(ids, table) * math.sqrt(dim or table.shape[-1])


def init_layernorm(dim: int, *, device, dtype=torch.float32,
                   stack: Tuple[int, ...] = ()) -> dict:
    return {"scale": torch.ones(stack + (dim,), device=device, dtype=dtype),
            "bias": torch.zeros(stack + (dim,), device=device, dtype=dtype)}


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def sinusoidal_table(max_len: int, d_model: int, dtype=torch.float32,
                     device="cuda") -> torch.Tensor:
    """Sinusoidal positional encoding (dqn_policy/model.py:77-92), computed
    in float32 like the JAX table."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe.to(dtype)


def dropout(generator: Optional[torch.Generator], x: torch.Tensor, rate: float,
            deterministic: bool, shard: Tuple[int, int] = (0, 1),
            rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Inverted dropout, keep probability 1 - rate (JAX ``cm.dropout``).  No
    generator means no dropout.  The mask is drawn from ``generator`` (on
    x's device), so it differs from the JAX package's draw for the same
    seed.  ``shard`` = (i, n): x is the i-th of n column shards of a
    tensor; ``rows`` = (j, m): x is the j-th of m blocks of a batch on its
    leading axis (a dp rank's rows).  The whole tensor's mask is drawn and
    x keeps its columns and rows, so the draw is the one-process draw."""
    if deterministic or rate <= 0.0 or generator is None:
        return x
    i, n = shard
    j, m = rows
    lead, k = x.shape[:-1], x.shape[-1]
    if m > 1:
        lead = (lead[0] * m,) + lead[1:]
    keep = torch.rand(lead + (k * n,), generator=generator, device=x.device)
    keep = keep[..., i * k:(i + 1) * k]
    if m > 1:
        keep = keep[j * x.shape[0]:(j + 1) * x.shape[0]]
    keep = keep < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def init_field_embeddings(vocab_sizes: Sequence[int], emb_sizes: Sequence[int],
                          *, generator, device, dtype=torch.float32) -> dict:
    names = field_names(len(vocab_sizes))
    return {n: init_embedding(v, e, generator=generator, device=device, dtype=dtype)
            for n, v, e in zip(names, vocab_sizes, emb_sizes)}


def embed_fields(emb_params: dict, x: torch.Tensor, tp: int = 1) -> torch.Tensor:
    """x (..., n_fields) int -> concat of scaled per-field embeddings
    (dqn_policy/model.py:206-221); ``tp``: the tables are column shards of
    1/tp of each field's embedding (scaled by the whole width)."""
    names = field_names(x.shape[-1])
    parts = [scaled_embed(emb_params[n], x[..., i].long(), emb_params[n].shape[-1] * tp)
             for i, n in enumerate(names)]
    return torch.cat(parts, dim=-1)


def init_field_heads(d_model: int, vocab_sizes: Sequence[int], *, generator,
                     device, dtype=torch.float32) -> dict:
    names = field_names(len(vocab_sizes))
    return {n: init_linear(d_model, v, generator=generator, device=device, dtype=dtype)
            for n, v in zip(names, vocab_sizes)}


def apply_field_heads(heads: dict, h: torch.Tensor, n_fields: int) -> Tuple[torch.Tensor, ...]:
    """h (..., D) -> tuple of per-field logits (dqn_policy/model.py:241-249)."""
    return tuple(linear(heads[n], h) for n in field_names(n_fields))
