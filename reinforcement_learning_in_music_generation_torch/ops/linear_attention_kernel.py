"""The causal linear-attention product of feature-mapped q and k, forward and
backward ("kernel F"): the counterpart of the JAX package's
``ops/linear_attention.py`` ``_fwd_pallas`` / ``_bwd_pallas`` (Pallas bodies
``_fwd_kernel``, ``_bwd_dq_kernel``, ``_bwd_dkv_kernel``), the route
``causal_linear_attention(backend="pallas")`` takes.

    out_i = phi(q_i) S_i / (phi(q_i) . z_i + eps),  den_i = phi(q_i) . z_i
    S_i = sum_{j <= i} phi(k_j) v_j^T,  z_i = sum_{j <= i} phi(k_j)

Kernel F: ``csrc/causal_product.cu`` (its passes in
``csrc/causal_product.cuh``, which kernel C's attention half runs too),
hand-written CUDA for ``sm_90a``, built at first use (``_build.py``) and
called through ctypes.  Row tiles of
64 run in parallel: at S <= 64 one launch, a block a 16-row group; longer
sequences first take a state pass that writes each tile's k^T [v | 1]
(and, backward, q^T [dnum | dd]) to a scratch tensor, whose slots the
output pass sums in order (prefix (S, z) for the forward and d phi(q),
suffix (G, gz) for d phi(k), dv).  Every product runs on the tensor cores
at f32 grade (three bf16 planes an operand, six products a product), and
nothing is padded or copied; ``chunk`` is the plain twin's.  On bf16
tensors (JAX's kernel takes any dtype, computes in f32 and returns out and
den in the inputs' dtype) the tiles are widened to f32 as they are loaded,
out and den are rounded on store, and the backward forms dnum and dd in
bf16 arithmetic from the rounded out and den, as ``_bwd_pallas`` does
outside its kernels; dq, dk, dv are rounded on store.

``causal_product`` takes phi(q), phi(k), v (B, H, S, E) of one type,
float32 or bfloat16, with a unit last stride and any other strides (the
model's (B, H, S, E) views of (B, S, H, E) projections go in without
copies, and out and the gradients come back in the inputs' layout), E a
multiple of 4 and at most 64.
Anything else raises, on every device.  On a CPU tensor it runs
``causal_product_plain``; on a CUDA tensor it launches the kernel; any
other device raises.  The kernel loads 16 bytes at a time, so an input
whose (batch, head, row) strides are not multiples of 4 or whose base is
not 16-byte aligned (never the model's) goes in as a contiguous copy.

Counts: ``launches_fwd`` / ``launches_bwd`` the wrapper's eager calls,
``cuda_launches`` the CUDA launches they made (1 a call at S <= 64, else
2); a call made while a CUDA graph capture records counts nothing.
``kernel_runs`` reads the kernel's own count of the calls that ran on the
card, graph replays included.  ``product_fwd`` / ``product_bwd`` run the
same forward and backward outside autograd, for a caller with a backward
of its own (the sequence-parallel attention, which adds den's cotangent),
and count in ``launches_fwd`` / ``launches_bwd`` alike.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .linear_attention import DEFAULT_EPS, _DEF_CHUNK, _bwd_core, _fwd_bshe

MAX_HEAD_WIDTH = 64          # csrc/causal_product.cuh cpk::MAX_E


def _plain_fwd(phi_q, phi_k, v, eps: float, chunk: int):
    """``_PlainProduct``'s forward arithmetic -> (out, den) in v's type."""
    t = lambda x: x.transpose(1, 2).float()
    out, den = _fwd_bshe(t(phi_q), t(phi_k), t(v), eps, chunk)
    return out.transpose(1, 2).to(v.dtype), den.transpose(1, 2).to(v.dtype)


def _plain_bwd(phi_q, phi_k, v, out, den, g, eps: float, chunk: int):
    """``_PlainProduct``'s backward arithmetic -> (d phi_q, d phi_k, dv)."""
    g = g.to(out.dtype)
    dnum = g / (den + eps)[..., None]
    dden = -(g * out).float().sum(-1).to(out.dtype) / (den + eps)
    t = lambda x: x.transpose(1, 2).float()
    grads = _bwd_core(t(phi_q), t(phi_k), t(v), t(dnum), t(dden), chunk)
    return tuple(d.transpose(1, 2).to(x.dtype) for d, x in zip(grads, (phi_q, phi_k, v)))


class _PlainProduct(torch.autograd.Function):
    """JAX ``_fwd_pallas`` / ``_bwd_pallas``'s arithmetic in PyTorch ops, on
    (B, H, S, E) tensors of one type T (float32 or bfloat16), through the
    chunked core on transposed views.  Forward: q, k, v widened to f32,
    every product f32, out = num / (den + eps) formed in f32; out and den
    returned rounded to T.  Backward (``_bwd_pallas``): dnum = g / (den +
    eps) and dden = -sum(g out) / (den + eps) in T's arithmetic on the
    rounded out and den (the sum taken in f32, as ``jnp.sum`` takes a bf16
    sum, and rounded), widened to f32 for the two passes; dq, dk, dv
    rounded to T.  At float32 every rounding is the identity: the chunked
    core's own arithmetic."""

    @staticmethod
    def forward(ctx, phi_q, phi_k, v, eps: float, chunk: int):
        out, den = _plain_fwd(phi_q, phi_k, v, eps, chunk)
        ctx.save_for_backward(phi_q, phi_k, v, out, den)
        ctx.cfg = (eps, chunk)
        ctx.mark_non_differentiable(den)
        return out, den

    @staticmethod
    def backward(ctx, g, _g_den):
        return _plain_bwd(*ctx.saved_tensors, g, *ctx.cfg) + (None, None)


def causal_product_plain(phi_q: torch.Tensor, phi_k: torch.Tensor, v: torch.Tensor,
                         eps: float = DEFAULT_EPS,
                         chunk: int = _DEF_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in PyTorch ops (``_PlainProduct``: JAX's Pallas
    arithmetic at the inputs' type) -> (out (B, H, S, E), den (B, H, S)),
    both in the inputs' type; den is not differentiable."""
    return _PlainProduct.apply(phi_q, phi_k, v, eps, chunk)


_DTYPES = (torch.float32, torch.bfloat16)


def _check(phi_q, phi_k, v) -> None:
    e = phi_q.shape[-1]
    if e % 4 or e > MAX_HEAD_WIDTH or e == 0:
        raise ValueError(f"causal_product: head width {e}; the kernel takes a multiple of 4 "
                         f"up to {MAX_HEAD_WIDTH}")
    for name, t in (("phi_q", phi_q), ("phi_k", phi_k), ("v", v)):
        if t.dtype not in _DTYPES or t.dtype != phi_q.dtype:
            raise TypeError(f"causal_product {name}: {t.dtype} (the kernel takes float32 or "
                            f"bfloat16, phi_q's {phi_q.dtype} for all three)")
        if t.ndim != 4 or t.shape != phi_q.shape or t.device != phi_q.device:
            raise ValueError(f"causal_product {name}: shape {tuple(t.shape)} on {t.device}, "
                             f"expected phi_q's {tuple(phi_q.shape)} on {phi_q.device} "
                             "(the kernel takes v as wide as q and k)")
        if t.stride(-1) != 1:
            raise ValueError(f"causal_product {name}: needs a unit stride in the last "
                             f"dimension (strides {t.stride()})")


TILE = 64                    # csrc/causal_product.cuh cpk::T

_LIB: Optional[ctypes.CDLL] = None
_FWD = _BWD = None           # the library's entry points, bound once


def _lib() -> ctypes.CDLL:
    global _LIB, _FWD, _BWD
    if _LIB is None:
        lib = _build.load("causal_product")
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.rlmg_causal_product_fwd.argtypes = [p] * 7 + [i] * 4 + [f, i, p]
        lib.rlmg_causal_product_fwd.restype = i
        lib.rlmg_causal_product_bwd.argtypes = [p] * 11 + [i] * 4 + [f, i, p]
        lib.rlmg_causal_product_bwd.restype = i
        lib.rlmg_causal_product_scratch_floats.argtypes = [i] * 5
        lib.rlmg_causal_product_scratch_floats.restype = ll
        lib.rlmg_causal_product_runs.argtypes = [ctypes.POINTER(ll), i]
        lib.rlmg_causal_product_runs.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _FWD, _BWD = lib.rlmg_causal_product_fwd, lib.rlmg_causal_product_bwd
        _LIB = lib
    return _LIB


def _strides(*tensors) -> ctypes.Array:
    """(batch, head, row) strides of each (B, H, S, E) tensor, in elements."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _loadable(*tensors):
    """The tensors, each as it is or, where the kernel's 16-byte loads could
    not read it (the stride of a dimension longer than 1 not a multiple of
    4, or a base not 16-byte aligned), as a contiguous copy in a new
    allocation."""
    return tuple(t if t.data_ptr() % 16 == 0 and all(
        st % 4 == 0 or n == 1 for st, n in zip(t.stride()[:3], t.shape[:3]))
        else t.clone(memory_format=torch.contiguous_format) for t in tensors)


def _scratch(b: int, h: int, s: int, e: int, backward: int, device) -> Optional[torch.Tensor]:
    if s <= TILE:
        return None
    n = _lib().rlmg_causal_product_scratch_floats(b, h, s, e, backward)
    return torch.empty(n, dtype=torch.float32, device=device)


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"causal_product {what} kernel: "
                           f"{_lib().rlmg_error_string(rc).decode()}")


def kernel_runs(reset: bool = False) -> Tuple[int, int]:
    """(forward, backward) calls of kernel F that ran on the current card
    since the last reset, as the kernel counts them (eager or replayed from
    a CUDA graph); waits for the card.  ``reset`` zeroes both after the
    read."""
    runs = (ctypes.c_longlong * 2)()
    _raise_on(_lib().rlmg_causal_product_runs(runs, int(reset)), "run count")
    return runs[0], runs[1]


def forward_kernel(phi_q, phi_k, v, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward call on checked inputs -> (out in phi_q's layout, den
    (B, H, S)), both in the inputs' type.  Counts ``cuda_launches``, not
    ``launches_fwd`` (the wrapper counts its calls)."""
    phi_q, phi_k, v = _loadable(phi_q, phi_k, v)
    b, h, s, e = phi_q.shape
    dev = phi_q.device
    _lib()
    out = torch.empty_like(phi_q)
    den = torch.empty((b, h, s), dtype=phi_q.dtype, device=dev)
    scratch = _scratch(b, h, s, e, 0, dev)
    args = (phi_q.data_ptr(), phi_k.data_ptr(), v.data_ptr(), out.data_ptr(), den.data_ptr(),
            None if scratch is None else scratch.data_ptr(), _strides(phi_q, phi_k, v, out),
            b, h, s, e, eps, int(phi_q.dtype == torch.bfloat16))
    with torch.cuda.device(dev):
        rc = _FWD(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "forward")
    if not torch.cuda.is_current_stream_capturing():    # a capture records, launches nothing
        causal_product.cuda_launches += 1 + (s > TILE)
    return out, den


def backward_kernel(phi_q, phi_k, v, out, den, g,
                    eps: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward call (a state pass first past one tile) -> (d phi_q,
    d phi_k, dv), each in its input's layout and type.  Counts
    ``cuda_launches``, not ``launches_bwd``."""
    if g.stride(-1) != 1 or g.dtype != phi_q.dtype:
        g = g.to(phi_q.dtype).contiguous()
    phi_q, phi_k, v, out, g = _loadable(phi_q, phi_k, v, out, g)
    b, h, s, e = phi_q.shape
    dev = phi_q.device
    _lib()
    dq, dk, dv = torch.empty_like(phi_q), torch.empty_like(phi_k), torch.empty_like(v)
    scratch = _scratch(b, h, s, e, 1, dev)
    args = (phi_q.data_ptr(), phi_k.data_ptr(), v.data_ptr(), out.data_ptr(), den.data_ptr(),
            g.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            _strides(phi_q, phi_k, v, out, g, dq, dk, dv), b, h, s, e, eps,
            int(phi_q.dtype == torch.bfloat16))
    with torch.cuda.device(dev):
        rc = _BWD(*args, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward")
    causal_product.cuda_launches += 1 + (s > TILE)
    return dq, dk, dv


class _CausalProduct(torch.autograd.Function):

    @staticmethod
    def forward(ctx, phi_q, phi_k, v, eps: float):
        out, den = forward_kernel(phi_q, phi_k, v, eps)
        if not torch.cuda.is_current_stream_capturing():
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
causal_product.cuda_launches = 0


def product_fwd(phi_q, phi_k, v, eps: float = DEFAULT_EPS,
                chunk: int = _DEF_CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """``causal_product``'s forward outside autograd, for a caller with a
    backward of its own (``ops/linear_attention.py _CoreWithDen``, which
    needs den's cotangent): -> (out, den) in the inputs' type; the kernel on
    CUDA tensors (counted in ``launches_fwd``), the twin's arithmetic on CPU
    tensors."""
    _check(phi_q, phi_k, v)
    if phi_q.device.type == "cpu":
        return _plain_fwd(phi_q, phi_k, v, eps, chunk)
    if phi_q.device.type != "cuda":
        raise ValueError(f"causal_product: no kernel for device {phi_q.device}")
    out, den = forward_kernel(phi_q, phi_k, v, eps)
    if not torch.cuda.is_current_stream_capturing():
        causal_product.launches_fwd += 1
    return out, den


def product_bwd(phi_q, phi_k, v, out, den, g, eps: float = DEFAULT_EPS,
                chunk: int = _DEF_CHUNK) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward of ``product_fwd``'s (out, den) for out's cotangent
    ``g`` -> (d phi_q, d phi_k, dv): the kernel on CUDA tensors (counted in
    ``launches_bwd``), the twin's arithmetic on CPU tensors."""
    if phi_q.device.type == "cpu":
        return _plain_bwd(phi_q, phi_k, v, out, den, g, eps, chunk)
    if phi_q.device.type != "cuda":
        raise ValueError(f"causal_product: no kernel for device {phi_q.device}")
    grads = backward_kernel(phi_q, phi_k, v, out, den, g, eps)
    causal_product.launches_bwd += 1
    return grads
