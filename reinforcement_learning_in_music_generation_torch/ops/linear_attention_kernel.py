"""The causal linear-attention product of feature-mapped q and k, forward and
backward ("kernel F"): the counterpart of the JAX package's
``ops/linear_attention.py`` ``_fwd_pallas`` / ``_bwd_pallas`` (Pallas bodies
``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``), the route
``causal_linear_attention(backend="pallas")`` takes.

    out_i = phi(q_i) S_i / (phi(q_i) . z_i + eps),  den_i = phi(q_i) . z_i
    S_i = sum_{j <= i} phi(k_j) v_j^T,  z_i = sum_{j <= i} phi(k_j)

Kernel F: ``csrc/causal_product.cu`` (the passes of
``csrc/linear_attention.cuh``, shared with kernel C), hand-written CUDA for
``sm_90a``, built at first use (``_build.py``) and called through ctypes.
The forward walks each (sequence, head) in 64-row tiles with (S, z) in
shared memory and writes out and den; the backward is two deterministic
passes, d phi(q) in forward order carrying (S, z) and d phi(k), dv in
reverse order carrying (G, gz), with dnum = g / (den + eps) and dden =
-sum(g out) / (den + eps) formed inside them.  Rows past S are masked by
bounds (the TPU padded to its 128-row chunk), so the kernel reads nothing
past S and allocates no padded copy; ``chunk`` is the plain twin's.

``causal_product`` takes float32 phi(q), phi(k), v (B, H, S, E) with a unit
last stride and any other strides (the model's (B, H, S, E) views of
(B, S, H, E) projections go in without copies, and out and the gradients
come back in the inputs' layout), E a multiple of 4 and at most 64.
Anything else raises, on every device.  On a CPU tensor it runs
``causal_product_plain``; on a CUDA tensor it launches the kernel (counted
in ``launches_fwd`` / ``launches_bwd``); any other device raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .linear_attention import DEFAULT_EPS, _DEF_CHUNK, _ChunkedCore

MAX_HEAD_WIDTH = 64          # csrc/linear_attention.cuh AT_MAX_E


def causal_product_plain(phi_q: torch.Tensor, phi_k: torch.Tensor, v: torch.Tensor,
                         eps: float = DEFAULT_EPS,
                         chunk: int = _DEF_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in PyTorch ops: the chunked composition
    (``_fwd_bshe`` / ``_bwd_bshe``, analytic backward) on transposed views
    -> (out (B, H, S, E), den (B, H, S)); den is not differentiable."""
    t = lambda x: x.transpose(1, 2)
    out, den = _ChunkedCore.apply(t(phi_q), t(phi_k), t(v), eps, chunk)
    return t(out), den.transpose(1, 2)


def _check(phi_q, phi_k, v) -> None:
    e = phi_q.shape[-1]
    if e % 4 or e > MAX_HEAD_WIDTH or e == 0:
        raise ValueError(f"causal_product: head width {e}; the kernel takes a multiple of 4 "
                         f"up to {MAX_HEAD_WIDTH}")
    for name, t in (("phi_q", phi_q), ("phi_k", phi_k), ("v", v)):
        if t.dtype != torch.float32:
            raise TypeError(f"causal_product {name}: {t.dtype} (the kernel takes float32)")
        if t.ndim != 4 or t.shape != phi_q.shape or t.device != phi_q.device:
            raise ValueError(f"causal_product {name}: shape {tuple(t.shape)} on {t.device}, "
                             f"expected phi_q's {tuple(phi_q.shape)} on {phi_q.device} "
                             "(the kernel takes v as wide as q and k)")
        if t.stride(-1) != 1:
            raise ValueError(f"causal_product {name}: needs a unit stride in the last "
                             f"dimension (strides {t.stride()})")


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("causal_product")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmg_causal_product_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, p]
        lib.rlmg_causal_product_fwd.restype = i
        lib.rlmg_causal_product_bwd.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.rlmg_causal_product_bwd.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _strides(*tensors) -> ctypes.Array:
    """(batch, head, row) strides of each (B, H, S, E) tensor, in elements."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"causal_product {what} kernel: "
                           f"{_lib().rlmg_error_string(rc).decode()}")


def forward_kernel(phi_q, phi_k, v, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch on checked inputs -> (out in phi_q's layout, den
    (B, H, S)).  Not counted in ``launches_fwd`` (the wrapper counts)."""
    b, h, s, e = phi_q.shape
    out = torch.empty_like(phi_q)
    den = torch.empty((b, h, s), dtype=torch.float32, device=phi_q.device)
    with torch.cuda.device(phi_q.device):
        rc = _lib().rlmg_causal_product_fwd(
            phi_q.data_ptr(), phi_k.data_ptr(), v.data_ptr(), out.data_ptr(), den.data_ptr(),
            _strides(phi_q, phi_k, v, out), b, h, s, e, eps,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "forward")
    return out, den


def backward_kernel(phi_q, phi_k, v, out, den, g,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The two backward launches (dq pass, then dk/dv pass) -> (d phi_q,
    d phi_k, dv), each in its input's layout.  Not counted in
    ``launches_bwd``."""
    b, h, s, e = phi_q.shape
    if g.stride(-1) != 1:
        g = g.contiguous()
    dq, dk, dv = torch.empty_like(phi_q), torch.empty_like(phi_k), torch.empty_like(v)
    with torch.cuda.device(phi_q.device):
        rc = _lib().rlmg_causal_product_bwd(
            phi_q.data_ptr(), phi_k.data_ptr(), v.data_ptr(), out.data_ptr(), den.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _strides(phi_q, phi_k, v, out, g, dq, dk, dv), b, h, s, e, eps,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward")
    return dq, dk, dv


class _CausalProduct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, phi_q, phi_k, v, eps: float):
        out, den = forward_kernel(phi_q, phi_k, v, eps)
        causal_product.launches_fwd += 1
        ctx.save_for_backward(phi_q, phi_k, v, out, den)
        ctx.eps = eps
        ctx.mark_non_differentiable(den)
        return out, den

    @staticmethod
    def backward(ctx, g, _g_den):
        phi_q, phi_k, v, out, den = ctx.saved_tensors
        dq, dk, dv = backward_kernel(phi_q, phi_k, v, out, den, g, ctx.eps)
        causal_product.launches_bwd += 1
        return dq, dk, dv, None


def causal_product(phi_q: torch.Tensor, phi_k: torch.Tensor, v: torch.Tensor,
                   eps: float = DEFAULT_EPS,
                   chunk: int = _DEF_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal linear attention on feature-mapped q and k (JAX ``_core`` with
    ``backend="pallas"``): phi_q, phi_k, v (B, H, S, E) -> (out (B, H, S,
    E), den (B, H, S)), out differentiable in all three inputs, den not."""
    _check(phi_q, phi_k, v)
    if phi_q.device.type == "cpu":
        return causal_product_plain(phi_q, phi_k, v, eps, chunk)
    if phi_q.device.type != "cuda":
        raise ValueError(f"causal_product: no kernel for device {phi_q.device}")
    return _CausalProduct.apply(phi_q, phi_k, v, eps)


causal_product.launches_fwd = 0
causal_product.launches_bwd = 0
