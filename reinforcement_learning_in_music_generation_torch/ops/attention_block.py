"""qkv projection + chunked causal linear attention, the training kernel:
the counterpart of the JAX package's ``ops/attention_block.py``
(``qkv_attention_block``, Pallas bodies ``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``).

Kernel C: ``csrc/attention_block.cu`` (GEMM tiles from
``csrc/train_gemm.cuh``), hand-written CUDA for ``sm_90a``, built at first
use (``_build.py``) and called through ctypes.  The forward computes qkv =
h Wqkv + b in the kernel's own GEMM with phi = elu+1 on q and k in its
epilogue, stores ``[phi(q) | phi(k) | v]`` as the backward residual (as the
TPU kernel does), then runs the causal recurrence with one block per
(sequence, head) and the (E, E) state in shared memory.  The backward is
two passes over the same blocks, prefix (S, z) for d phi(q) and suffix
(G, gz) for d phi(k) and dv, with phi' = min(phi, 1) from the stored phi;
the final dqkv -> (dh, dW, db) products are ``torch.matmul``, as the TPU
version leaves them to XLA.  The TPU's head-pair packing (128-lane rows)
is dropped.

Bound on the H100 (source note): at the slice's shape (16384 rows, d 512)
the forward is about 25.8 GFLOP of projection and 3.2 of attention (the
causal half of each score tile), bound by f32 operations outside the
tensor cores.

``qkv_attention_block`` launches the kernel for CUDA tensors (counting
forward and backward launches apart) and runs ``qkv_attention_block_plain``
for CPU tensors; any other device raises.  It takes float32 or bfloat16,
contiguous, with the sequence length a multiple of the chunk and a head
width that is a multiple of 4 and at most 64; anything else raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .linear_attention import DEFAULT_EPS, causal_linear_attention_bshe

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_WIDTH = 64          # csrc/attention_block.cu AT_MAX_E


def qkv_attention_block_plain(h: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                              n_seq: int, n_head: int, chunk: int = 128,
                              eps: float = DEFAULT_EPS) -> torch.Tensor:
    """The same function in PyTorch ops (autograd gives the backward): the
    qkv product, then ``causal_linear_attention_bshe``."""
    n, d = h.shape
    s = n // n_seq
    if s % chunk != 0:
        raise ValueError(f"sequence length {s} not divisible by chunk {chunk}")
    q, k, v = (h @ wqkv + bqkv).split(d, dim=-1)
    shp = lambda x: x.reshape(n_seq, s, n_head, d // n_head)
    return causal_linear_attention_bshe(shp(q), shp(k), shp(v), eps=eps,
                                        chunk=chunk).reshape(n, d)


def _check(h, wqkv, bqkv, n_seq: int, n_head: int, chunk: int) -> None:
    n, d = h.shape
    if n % n_seq:
        raise ValueError(f"{n} rows do not split into {n_seq} sequences")
    if (n // n_seq) % chunk:
        raise ValueError(f"sequence length {n // n_seq} not divisible by chunk {chunk}")
    if h.dtype not in KERNEL_DTYPES:
        raise TypeError(f"h: {h.dtype} (the kernel takes float32 or bfloat16)")
    for name, t, shape in (("wqkv", wqkv, (d, 3 * d)), ("bqkv", bqkv, (3 * d,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if t.dtype != h.dtype:
            raise TypeError(f"{name}: {t.dtype}, expected {h.dtype} like h")
    for name, t in (("h", h), ("wqkv", wqkv), ("bqkv", bqkv)):
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous and on {h.device}")
    e = d // n_head
    if e * n_head != d or e % 4 or e > MAX_HEAD_WIDTH:
        raise ValueError(f"d_model {d} / n_head {n_head}: the kernel needs a head width "
                         f"that is a multiple of 4 and at most {MAX_HEAD_WIDTH}")


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("attention_block")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmg_qkv_attn_fwd.argtypes = [p, p, p, p, p, p, i, i, i, i, f, i, p]
        lib.rlmg_qkv_attn_fwd.restype = i
        lib.rlmg_qkv_attn_bwd.argtypes = [p, p, p, p, p, i, i, i, i, f, i, p]
        lib.rlmg_qkv_attn_bwd.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"attention_block {what} kernel: "
                           f"{_lib().rlmg_error_string(rc).decode()}")


def forward_kernel(h, wqkv, bqkv, n_seq: int, n_head: int, eps: float):
    """One launch of the forward kernel on checked inputs -> (att, pqkv,
    den).  Not counted in ``launches_fwd`` (the wrapper counts)."""
    n, d = h.shape
    pqkv = torch.empty((n, 3 * d), dtype=h.dtype, device=h.device)
    att = torch.empty((n, d), dtype=h.dtype, device=h.device)
    den = torch.empty((n, n_head), dtype=torch.float32, device=h.device)
    with torch.cuda.device(h.device):
        rc = _lib().rlmg_qkv_attn_fwd(h.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                                      pqkv.data_ptr(), att.data_ptr(), den.data_ptr(), n, n_seq,
                                      d, n_head, eps, int(h.dtype == torch.bfloat16),
                                      torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "forward")
    return att, pqkv, den


def backward_kernel(pqkv, g, att, den, n_seq: int, n_head: int, eps: float) -> torch.Tensor:
    """The two backward passes on the forward's residuals and the upstream
    gradient g -> dqkv (N, 3D) = [d phi(q) phi'(q) | d phi(k) phi'(k) | dv].
    Not counted in ``launches_bwd``."""
    n, d = g.shape
    dqkv = torch.empty_like(pqkv)
    with torch.cuda.device(g.device):
        rc = _lib().rlmg_qkv_attn_bwd(pqkv.data_ptr(), g.data_ptr(), att.data_ptr(),
                                      den.data_ptr(), dqkv.data_ptr(), n, n_seq, d, n_head, eps,
                                      int(g.dtype == torch.bfloat16),
                                      torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward")
    return dqkv


class _QkvAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, wqkv, bqkv, n_seq: int, n_head: int, eps: float):
        att, pqkv, den = forward_kernel(h, wqkv, bqkv, n_seq, n_head, eps)
        if not torch.cuda.is_current_stream_capturing():    # a capture records, launches nothing
            qkv_attention_block.launches_fwd += 1
        ctx.save_for_backward(h, wqkv, pqkv, att, den)
        ctx.cfg = (n_seq, n_head, eps)
        return att

    @staticmethod
    def backward(ctx, g):
        h, wqkv, pqkv, att, den = ctx.saved_tensors
        dqkv = backward_kernel(pqkv, g.to(h.dtype).contiguous(), att, den, *ctx.cfg)
        qkv_attention_block.launches_bwd += 1
        dh = dqkv @ wqkv.T
        dw = h.T @ dqkv
        return dh, dw.to(wqkv.dtype), dqkv.sum(0).to(wqkv.dtype), None, None, None


def qkv_attention_block(h: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                        n_seq: int, n_head: int, chunk: int = 128,
                        eps: float = DEFAULT_EPS) -> torch.Tensor:
    """h (N, D) row-major, N = n_seq sequences of S rows (S % chunk == 0)
    -> causal linear attention output (N, D), with the qkv projection
    (wqkv (D, 3D), bqkv (3D,)) fused into the kernel.  Differentiable in
    h, wqkv and bqkv."""
    if h.device.type == "cpu":
        return qkv_attention_block_plain(h, wqkv, bqkv, n_seq, n_head, chunk, eps)
    if h.device.type != "cuda":
        raise ValueError(f"qkv_attention_block: no kernel for device {h.device}")
    _check(h, wqkv, bqkv, n_seq, n_head, chunk)
    return _QkvAttention.apply(h, wqkv, bqkv, n_seq, n_head, eps)


qkv_attention_block.launches_fwd = 0
qkv_attention_block.launches_bwd = 0
