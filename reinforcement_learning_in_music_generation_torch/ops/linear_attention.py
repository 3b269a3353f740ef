"""Causal linear attention: the chunked parallel form (training) and the
recurrent single-token form (decode).

Counterpart of the JAX package's ``ops/linear_attention.py``:

    phi(x)  = elu(x) + 1
    S_i     = sum_{j<=i} phi(k_j) v_j^T          (E x F running state)
    z_i     = sum_{j<=i} phi(k_j)                (E running state)
    out_i   = (phi(q_i)^T S_i) / (phi(q_i) . z_i + eps)

``causal_linear_attention_bshe`` ((B, S, H, E) layout, ``_fwd_xla_bshe`` /
``_bwd_xla_bshe``) runs the chunked recurrence in PyTorch ops, as a
``torch.autograd.Function`` with the analytic backward (a forward pass with
prefix (S, z) for d phi(q), a reverse pass with suffix (G, gz) for d phi(k)
and dv).  ``causal_linear_attention`` ((B, H, S, E) layout) dispatches as
the JAX function does, on ``backend or default_backend()``: "pallas" (the
JAX package's Pallas causal product, ``_fwd_pallas`` / ``_bwd_pallas``)
runs kernel F (``ops/linear_attention_kernel.py causal_product``, its plain
twin on CPU tensors); anything else the chunked core on transposed views
(``_fwd_xla`` / ``_bwd_xla``).  The chunked core is also the plain version
behind kernels C (``ops/attention_block.py``) and F.  The sequence-parallel
form waits for the parallelism item of ROADMAP Queue 1.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

DEFAULT_EPS = 1e-6
_DEF_CHUNK = 128


def default_backend() -> str:
    """RLMG_ATTN_BACKEND, else "xla" (the chunked PyTorch composition)."""
    return os.environ.get("RLMG_ATTN_BACKEND") or "xla"


def feature_map(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1 (fast_transformers' default feature map)."""
    return torch.where(x > 0, x + 1.0, torch.exp(torch.clamp(x, max=0.0)))


def _lower(c: int, x: torch.Tensor) -> torch.Tensor:
    """(C, C) causal mask, 1 where row >= column."""
    return torch.tril(torch.ones((c, c), dtype=x.dtype, device=x.device))


def _pad_rows(x: torch.Tensor, dim: int, chunk: int) -> torch.Tensor:
    pad = (-x.shape[dim]) % chunk
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


# -- (B, S, H, E) layout ----------------------------------------------------

def _fwd_bshe(q, k, v, eps: float, chunk: int):
    """(B,S,H,E) x (B,S,H,F) -> out (B,S,H,F), den (B,S,H)."""
    s0 = q.shape[1]
    q, k, v = (_pad_rows(t, 1, chunk) for t in (q, k, v))
    mask = _lower(chunk, q)
    b, _, h, e = q.shape
    s_c = torch.zeros((b, h, e, v.shape[-1]), dtype=q.dtype, device=q.device)
    z_c = torch.zeros((b, h, e), dtype=q.dtype, device=q.device)
    outs, dens = [], []
    for j0 in range(0, q.shape[1], chunk):
        qb, kb, vb = q[:, j0:j0 + chunk], k[:, j0:j0 + chunk], v[:, j0:j0 + chunk]
        a = torch.einsum("bihe,bjhe->bhij", qb, kb) * mask
        num = (torch.einsum("bhij,bjhf->bihf", a, vb)
               + torch.einsum("bihe,bhef->bihf", qb, s_c))
        den = torch.einsum("bhij->bih", a) + torch.einsum("bihe,bhe->bih", qb, z_c)
        outs.append(num / (den + eps)[..., None])
        dens.append(den)
        s_c = s_c + torch.einsum("bjhe,bjhf->bhef", kb, vb)
        z_c = z_c + torch.einsum("bjhe->bhe", kb)
    return torch.cat(outs, 1)[:, :s0], torch.cat(dens, 1)[:, :s0]


def _bwd_bshe(q, k, v, out, den, g, eps: float, chunk: int):
    """Analytic backward in (B, S, H, *) layout; returns (dq, dk, dv)."""
    dnum = g / (den + eps)[..., None]
    dden = -(g * out).sum(-1) / (den + eps)
    return _bwd_core(q, k, v, dnum, dden, chunk)


def _bwd_core(q, k, v, dnum, dden, chunk: int):
    """The backward's two passes from dnum = g / (den + eps) (B, S, H, F)
    and dden = -sum(g out) / (den + eps) (B, S, H): (dq, dk, dv)."""
    s0 = q.shape[1]
    q, k, v, dnum, dden = (_pad_rows(t, 1, chunk) for t in (q, k, v, dnum, dden))
    lower = _lower(chunk, q)
    upper = lower.T
    starts = range(0, q.shape[1], chunk)
    blk = lambda x, j0: x[:, j0:j0 + chunk]
    b, _, h, e = q.shape

    s_c = torch.zeros((b, h, e, v.shape[-1]), dtype=q.dtype, device=q.device)
    z_c = torch.zeros((b, h, e), dtype=q.dtype, device=q.device)
    dqs = []
    for j0 in starts:
        qb, kb, vb, dnb, ddb = (blk(t, j0) for t in (q, k, v, dnum, dden))
        m = (torch.einsum("bihf,bjhf->bhij", dnb, vb)
             + torch.einsum("bih->bhi", ddb)[..., None]) * lower
        dq = torch.einsum("bhij,bjhe->bihe", m, kb)
        dq = dq + torch.einsum("bihf,bhef->bihe", dnb, s_c)
        dq = dq + ddb[..., None] * z_c[:, None]
        dqs.append(dq)
        s_c = s_c + torch.einsum("bjhe,bjhf->bhef", kb, vb)
        z_c = z_c + torch.einsum("bjhe->bhe", kb)

    g_c = torch.zeros_like(s_c)
    gz_c = torch.zeros_like(z_c)
    dks, dvs = [], []
    for j0 in reversed(starts):
        qb, kb, vb, dnb, ddb = (blk(t, j0) for t in (q, k, v, dnum, dden))
        n = (torch.einsum("bjhf,bihf->bhji", vb, dnb)
             + torch.einsum("bih->bhi", ddb)[:, :, None]) * upper
        dk = torch.einsum("bhji,bihe->bjhe", n, qb)
        dk = dk + torch.einsum("bjhf,bhef->bjhe", vb, g_c)
        dk = dk + gz_c[:, None]
        p = torch.einsum("bjhe,bihe->bhji", kb, qb) * upper
        dv = torch.einsum("bhji,bihf->bjhf", p, dnb)
        dv = dv + torch.einsum("bjhe,bhef->bjhf", kb, g_c)
        dks.append(dk)
        dvs.append(dv)
        g_c = g_c + torch.einsum("bihe,bihf->bhef", qb, dnb)
        gz_c = gz_c + torch.einsum("bih,bihe->bhe", ddb, qb)
    cut = lambda xs: torch.cat(xs[::-1], 1)[:, :s0]
    return torch.cat(dqs, 1)[:, :s0], cut(dks), cut(dvs)


class _ChunkedCore(torch.autograd.Function):
    """The causal product of feature-mapped q, k and v in (B, S, H, *)
    layout, with the analytic backward -> (out, den); den is not
    differentiable."""

    @staticmethod
    def forward(ctx, phi_q, phi_k, v, eps: float, chunk: int):
        out, den = _fwd_bshe(phi_q, phi_k, v, eps, chunk)
        ctx.save_for_backward(phi_q, phi_k, v, out, den)
        ctx.cfg = (eps, chunk)
        ctx.mark_non_differentiable(den)
        return out, den

    @staticmethod
    def backward(ctx, g, _g_den):
        dq, dk, dv = _bwd_bshe(*ctx.saved_tensors, g, *ctx.cfg)
        return dq, dk, dv, None, None


def causal_linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            eps: float = DEFAULT_EPS, chunk: int = _DEF_CHUNK,
                            backend: Optional[str] = None) -> torch.Tensor:
    """Causal linear attention over (B, H, S, E) -> (B, H, S, F).  Applies
    the elu+1 feature map to q and k (differentiable), then the core:
    kernel F for ``backend="pallas"`` (which takes F == E), else the chunked
    core (the (B, S, H, E) one, on transposed views)."""
    if (backend or default_backend()) == "pallas":
        from .linear_attention_kernel import causal_product    # imports this module
        return causal_product(feature_map(q), feature_map(k), v, eps, chunk)[0]
    t = lambda x: x.transpose(1, 2)
    return t(causal_linear_attention_bshe(t(q), t(k), t(v), eps=eps, chunk=chunk))


def causal_linear_attention_bshe(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                                 eps: float = DEFAULT_EPS,
                                 chunk: int = _DEF_CHUNK) -> torch.Tensor:
    """Causal linear attention over (B, S, H, E) -> (B, S, H, F): the same
    math in the head-minor layout, so (N, D)-shaped activations need no
    head transposes."""
    return _ChunkedCore.apply(feature_map(q), feature_map(k), v, eps, chunk)[0]


# -- recurrent single-token form (decode) -------------------------------------

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
