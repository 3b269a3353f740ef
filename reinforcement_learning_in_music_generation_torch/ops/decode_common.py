"""Knobs and plain helpers shared by the decode kernels.

Counterpart of the JAX package's ``ops/decode_common.py``, plus the plain
``phi``/``ln``/``gelu_exact`` that the JAX package keeps in
``decode_kernel_v3.py`` and ``gelu_tanh``, the plain form of the
``jax.nn.gelu(approximate=True)`` of ``ops/experimental/decode_kernel.py``.
CUDA has ``erff``, so the exact gelu needs no counterpart of the JAX
package's erf polynomial (``decode_kernel_v3._erf``, within 1.5e-7 of erf).
"""

from __future__ import annotations

import os

import torch

VF_PAD = 256          # per-field stride in the padded heads layout
NEG = -1e30

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}   # the kernels' two


def decode_state_dtype() -> torch.dtype:
    """Storage dtype of the recurrent decode state (the linear-attention
    (S, z) prefix sums, this architecture's KV-cache analog).

    bfloat16 by default on every fused decode path; accumulation stays f32
    in the kernels and only the stored state is rounded.  Set
    RLMG_DECODE_STATE_DTYPE=float32 for parity with the plain decode path."""
    name = os.environ.get("RLMG_DECODE_STATE_DTYPE", "bfloat16")
    if name not in _DTYPES:
        raise ValueError(f"RLMG_DECODE_STATE_DTYPE={name!r}: expected one of "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """uint32 random bits (held in an int64 tensor) -> standard Gumbel noise
    (f32).  u in (0, 1) from the top 24 bits, as the JAX helper."""
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24) + (2.0 ** -25)
    return -torch.log(-torch.log(u))


def phi(x: torch.Tensor) -> torch.Tensor:
    """elu(x) + 1."""
    return torch.where(x > 0, x + 1.0, torch.exp(torch.clamp(x, max=0.0)))


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x * 0.7071067811865476))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)``, the gelu of the per-layer v1/v2
    decode kernels (``ops/experimental/decode_kernel.py``)."""
    return x * (0.5 * (1.0 + torch.tanh(0.7978845608028654 * (x + 0.044715 * (x * x * x)))))


def ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
       eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


# -- Philox4x32-10, the counter-based generator of the v6 sampling kernel --
#
# Written in int64 tensor ops so the plain version draws the same bits as
# csrc/decode_chunk.cu.  Each 32x32-bit product is split at 16 bits so no
# intermediate leaves int64's range.

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
PHILOX_KEY1 = 0x5DEECE66
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, c: torch.Tensor):
    lo_part = c * (m & 0xFFFF)
    hi_part = c * (m >> 16)
    lo = (((hi_part & 0xFFFF) << 16) + lo_part) & _MASK32
    hi = (hi_part + (lo_part >> 16)) >> 16
    return hi, lo


def philox_bits(seed: int, c0, c1, c2, c3) -> torch.Tensor:
    """First output word of Philox4x32-10 at counter (c0, c1, c2, c3) and
    key (seed, PHILOX_KEY1).  Counters are int64 tensors (broadcastable)
    holding values in [0, 2^32)."""
    c0, c1, c2, c3 = torch.broadcast_tensors(c0, c1, c2, c3)
    k0, k1 = seed & _MASK32, PHILOX_KEY1
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0
