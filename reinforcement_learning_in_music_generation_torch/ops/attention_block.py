"""qkv projection + chunked causal linear attention, the training kernel:
the counterpart of the JAX package's ``ops/attention_block.py``
(``qkv_attention_block``, Pallas bodies ``_fwd_kernel``, ``_bwd_dq_kernel``,
``_bwd_dkv_kernel``), in JAX's arithmetic at f32 and bf16.

Kernel C: ``csrc/attention_block.cu``, hand-written CUDA for ``sm_90a``,
built at first use (``_build.py``) and called through ctypes.  The
projection (``project_kernel``) forms pqkv = [phi(q) | phi(k) | v] = h Wqkv
+ b, phi = elu + 1, on the ``wgmma`` tile of ``csrc/train_gemm_wg.cuh``
(f32 tensors: three bf16 planes an operand, six products a depth, each
summed afresh; bf16: one bf16 product with f32 sums) and stores it in h's
type as the backward's residual (as the TPU kernel does); at bf16 it also
hands the attention the unrounded f32 values, as JAX's kernel attends on
its f32 projection.  The attention (``attention_kernel``,
``backward_kernel``) runs the passes of ``csrc/causal_product.cuh``, kernel
F's, on head views of the packed rows: att in h's type and den (n_seq, H,
S) f32 forward; dqkv in h's type backward, with phi' = min(phi, 1) of the
stored phi folded into d phi(q), d phi(k) by the pass that writes them.
The final dqkv -> (dh, dW, db) products are ``torch.matmul``, as the TPU
version leaves them to XLA.  The TPU's head-pair packing (128-lane rows)
is dropped.

Bound on the H100: at the slice's shape (16384 rows, d 512) the
projection is 25.8 GFLOP (0.026 ms at the bf16 tensor-core rate, 0.157 ms
at 989/6 for the f32 grade) and the attention 3.2 GFLOP forward (the
causal half of each score tile), bound by its bytes.

``qkv_attention_block`` launches the kernel for CUDA tensors (counting
forward and backward calls apart, eager calls only; ``kernel_runs`` reads
the attention passes' own count of the calls that ran on the card, graph
replays included) and runs ``qkv_attention_block_plain`` for CPU tensors;
any other device raises.  It takes float32 or bfloat16, contiguous, with
the sequence length a multiple of the chunk, a head width that is a
multiple of 4 and at most 64, and d_model a multiple of 8; anything else
raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from . import _build
from .linear_attention import DEFAULT_EPS, _bwd_bshe, _fwd_bshe, feature_map

KERNEL_DTYPES = (torch.float32, torch.bfloat16)
MAX_HEAD_WIDTH = 64          # csrc/causal_product.cuh cpk::MAX_E
TILE = 64                    # csrc/causal_product.cuh cpk::T: no scratch at S <= TILE


def qkv_attention_block_plain(h: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor,
                              n_seq: int, n_head: int, chunk: int = 128,
                              eps: float = DEFAULT_EPS) -> torch.Tensor:
    """The same function in PyTorch ops, in JAX's arithmetic at every dtype
    (``_PlainQkvAttention``): the projection and the chunked attention in
    f32 on the unrounded phi(q), phi(k), v; the output and the residual
    rounded to h's type on store, den kept in f32; the analytic backward
    from those residuals, dqkv rounded once, dh / dW / db products in h's
    type."""
    n, d = h.shape
    if (n // n_seq) % chunk != 0:
        raise ValueError(f"sequence length {n // n_seq} not divisible by chunk {chunk}")
    return _PlainQkvAttention.apply(h, wqkv, bqkv, n_seq, n_head, chunk, eps)


class _PlainQkvAttention(torch.autograd.Function):
    """JAX ``qkv_attention_block``'s forward (``_fwd_kernel``) and custom
    VJP (``_qab_bwd``) in PyTorch ops."""

    @staticmethod
    def forward(ctx, h, wqkv, bqkv, n_seq: int, n_head: int, chunk: int, eps: float):
        n, d = h.shape
        f32 = torch.float32
        qkv = h.to(f32) @ wqkv.to(f32) + bqkv.to(f32)
        pq, pk, v = feature_map(qkv[:, :d]), feature_map(qkv[:, d:2 * d]), qkv[:, 2 * d:]
        shp = lambda x: x.reshape(n_seq, n // n_seq, n_head, d // n_head)
        out, den = _fwd_bshe(shp(pq), shp(pk), shp(v), eps, chunk)
        att = out.reshape(n, d).to(h.dtype)
        ctx.save_for_backward(h, wqkv, torch.cat([pq, pk, v], -1).to(h.dtype), att, den)
        ctx.cfg = (n_seq, n_head, chunk, eps)
        return att

    @staticmethod
    def backward(ctx, g):
        h, wqkv, pqkv, att, den = ctx.saved_tensors
        n_seq, n_head, chunk, eps = ctx.cfg
        n, d = h.shape
        shp = lambda x: x.float().reshape(n_seq, n // n_seq, n_head, d // n_head)
        pq, pk, v = pqkv.split(d, dim=-1)
        dq, dk, dv = _bwd_bshe(shp(pq), shp(pk), shp(v), shp(att), den, shp(g.to(h.dtype)), eps,
                               chunk)
        # phi'(x) = min(phi(x), 1), from the stored phi
        fold = lambda dx, p: dx.reshape(n, d) * torch.clamp(p.float(), max=1.0)
        dqkv = torch.cat([fold(dq, pq), fold(dk, pk), dv.reshape(n, d)], -1).to(h.dtype)
        dh = dqkv @ wqkv.T
        dw = h.T @ dqkv
        return dh, dw.to(wqkv.dtype), dqkv.sum(0).to(wqkv.dtype), None, None, None, None


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
    if d % 8:
        raise ValueError(f"d_model {d}: the projection's TMA rows need a multiple of 8")


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("attention_block")
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.rlmg_qkv_project.argtypes = [p] * 6 + [i] * 3 + [p]
        lib.rlmg_qkv_project.restype = i
        lib.rlmg_qkv_attn_fwd.argtypes = [p] * 4 + [i] * 4 + [f, i, p]
        lib.rlmg_qkv_attn_fwd.restype = i
        lib.rlmg_qkv_attn_bwd.argtypes = [p] * 6 + [i] * 4 + [f, i, p]
        lib.rlmg_qkv_attn_bwd.restype = i
        lib.rlmg_qkv_plane_elems.argtypes = [i] * 3
        lib.rlmg_qkv_plane_elems.restype = ll
        lib.rlmg_qkv_attn_scratch_floats.argtypes = [i] * 5
        lib.rlmg_qkv_attn_scratch_floats.restype = ll
        lib.rlmg_qkv_attn_runs.argtypes = [ctypes.POINTER(ll), i]
        lib.rlmg_qkv_attn_runs.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"attention_block {what} kernel: "
                           f"{_lib().rlmg_error_string(rc).decode()}")


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _scratch(n: int, d: int, n_seq: int, n_head: int, backward: int,
             device) -> Optional[torch.Tensor]:
    s = n // n_seq
    if s <= TILE:
        return None
    floats = _lib().rlmg_qkv_attn_scratch_floats(n_seq, n_head, s, d // n_head, backward)
    return torch.empty(floats, dtype=torch.float32, device=device)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def kernel_runs(reset: bool = False) -> Tuple[int, int]:
    """(forward, backward) attention calls of kernel C that ran on the
    current card since the last reset, as its passes count them (eager or
    replayed from a CUDA graph); waits for the card.  ``reset`` zeroes both
    after the read."""
    runs = (ctypes.c_longlong * 2)()
    _raise_on(_lib().rlmg_qkv_attn_runs(runs, int(reset)), "run count")
    return runs[0], runs[1]


def project_kernel(h, wqkv, bqkv) -> Tuple[torch.Tensor, torch.Tensor]:
    """The projection on checked inputs -> (pqkv (N, 3D) in h's type, its
    f32 values: pqkv itself at f32, a new (N, 3D) f32 tensor at bf16)."""
    n, d = h.shape
    bf16 = int(h.dtype == torch.bfloat16)
    if h.data_ptr() % 16:                 # TMA reads from a 16-byte aligned base
        h = h.clone()
    pqkv = torch.empty((n, 3 * d), dtype=h.dtype, device=h.device)
    x = torch.empty((n, 3 * d), dtype=torch.float32, device=h.device) if bf16 else pqkv
    planes = torch.empty(_lib().rlmg_qkv_plane_elems(n, d, bf16), dtype=torch.bfloat16,
                         device=h.device)
    with torch.cuda.device(h.device):
        rc = _lib().rlmg_qkv_project(h.data_ptr(), wqkv.data_ptr(), bqkv.data_ptr(),
                                     pqkv.data_ptr(), x.data_ptr() if bf16 else None,
                                     planes.data_ptr(), n, d, bf16, _stream())
    _raise_on(rc, "projection")
    return pqkv, x


def attention_kernel(x, n_seq: int, n_head: int, eps: float,
                     dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """The attention passes on the projection's f32 values x (N, 3D) ->
    (att (N, D) in ``dtype``, den (n_seq, H, S) f32)."""
    n, d = x.shape[0], x.shape[1] // 3
    att = torch.empty((n, d), dtype=dtype, device=x.device)
    den = torch.empty((n_seq, n_head, n // n_seq), dtype=torch.float32, device=x.device)
    scratch = _scratch(n, d, n_seq, n_head, 0, x.device)
    with torch.cuda.device(x.device):
        rc = _lib().rlmg_qkv_attn_fwd(x.data_ptr(), att.data_ptr(), den.data_ptr(),
                                      _ptr(scratch), n, n_seq, d, n_head, eps,
                                      int(dtype == torch.bfloat16), _stream())
    _raise_on(rc, "forward")
    return att, den


def forward_kernel(h, wqkv, bqkv, n_seq: int, n_head: int, eps: float):
    """The forward on checked inputs -> (att, pqkv, den): the projection,
    then the attention.  Not counted in ``launches_fwd`` (the wrapper
    counts)."""
    pqkv, x = project_kernel(h, wqkv, bqkv)
    att, den = attention_kernel(x, n_seq, n_head, eps, h.dtype)
    return att, pqkv, den


def backward_kernel(pqkv, g, att, den, n_seq: int, n_head: int, eps: float) -> torch.Tensor:
    """The backward passes on the forward's residuals and the upstream
    gradient g -> dqkv (N, 3D) = [d phi(q) phi'(q) | d phi(k) phi'(k) | dv]
    in pqkv's type.  Not counted in ``launches_bwd``."""
    n, d = g.shape
    dqkv = torch.empty_like(pqkv)
    scratch = _scratch(n, d, n_seq, n_head, 1, g.device)
    with torch.cuda.device(g.device):
        rc = _lib().rlmg_qkv_attn_bwd(pqkv.data_ptr(), g.data_ptr(), att.data_ptr(),
                                      den.data_ptr(), dqkv.data_ptr(), _ptr(scratch), n, n_seq,
                                      d, n_head, eps, int(g.dtype == torch.bfloat16),
                                      _stream())
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
        if not torch.cuda.is_current_stream_capturing():
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
