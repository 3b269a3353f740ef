"""The post-attention half of a training layer, fused: the counterpart of
the JAX package's ``ops/ffn_block.py`` ``attn_tail_block`` (Pallas bodies
``_tail_fwd_kernel`` and ``_tail_bwd_kernel``).

    out = LN2(h1 + drop3(W2 @ drop2(gelu(W1 @ h1 + b1)) + b2))
    h1  = LN1(h_in + drop1(Wo @ a_pre + bo))

Kernel D: ``csrc/attn_tail.cu`` (GEMM tiles and LayerNorm row kernels from
``csrc/train_gemm.cuh``), hand-written CUDA for ``sm_90a``, built at first
use (``_build.py``) and called through ctypes.  Every product, the
elementwise steps (bias, exact-erf gelu, dropout, residual) and both
LayerNorms run in the kernel's own code, forward and backward.  The
backward saves only (h_in, a_pre) and the seed and recomputes the rest, as
the TPU kernel does; weight gradients are row-split products added in a
fixed order, so they are bit-reproducible.

Dropout.  The TPU kernel drew its masks from the on-core PRNG seeded per row
tile, which the card cannot reproduce.  Here site s in {1, 2, 3} of element
(row, col) keeps the value when the top 24 bits of Philox4x32-10 at counter
(row, col, s, 0), key (seed, PHILOX_KEY1), times 2^-24 are >= p (the JAX
``_uniform_from_bits`` rule), scaled by 1/(1-p).  Rows are absolute, so a
mask does not depend on the row block; ``dropout_scale`` draws the same bits
in PyTorch (``decode_common.philox_bits``) for the plain version.
``mid_drop=False`` drops site 2 (the Longformer layer convention).

gelu is the exact erf form (``erff`` in the kernel, ``torch.erf`` in the
plain version); the JAX kernels use the A&S 7.1.26 erf polynomial, about
1e-7 away.

``attn_tail_block`` launches the kernel for CUDA tensors (counting forward
and backward launches apart) and runs ``attn_tail_block_plain`` for CPU
tensors; any other device raises.  The kernel takes contiguous float32
(bfloat16 is not ported yet: ROADMAP) with widths that are multiples of 4
and d_model <= 1024.  ``ffn_block`` (the post-LN1 half alone) is not
ported yet (ROADMAP Queue 2).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from . import _build
from .decode_common import gelu_exact, ln, philox_bits

MAX_D = 1024            # csrc/train_gemm.cuh LN_MAX_D

Seed = Union[int, torch.Tensor]


def dropout_scale(seed: int, site: int, row0: int, n_rows: int, n_cols: int, p: float,
                  device) -> torch.Tensor:
    """(n_rows, n_cols) float32 dropout multipliers (0 or 1/(1-p)) of
    ``site`` for the absolute rows row0 .. row0+n_rows-1: the kernel's
    Philox keep rule."""
    rows = torch.arange(row0, row0 + n_rows, dtype=torch.int64, device=device)[:, None]
    cols = torch.arange(n_cols, dtype=torch.int64, device=device)[None, :]
    bits = philox_bits(int(seed), rows, cols,
                       torch.full((), site, dtype=torch.int64, device=device),
                       torch.zeros((), dtype=torch.int64, device=device))
    u = (bits >> 8).to(torch.float32) * (2.0 ** -24)
    return (u >= p).to(torch.float32) * (1.0 / (1.0 - p))


def attn_tail_block_plain(h_in, a_pre, wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b,
                          seed: Seed, p: float, mid_drop: bool = True) -> torch.Tensor:
    """The same function in PyTorch ops (autograd gives the backward), over
    all rows at once, with the kernel's dropout masks."""
    n, d = h_in.shape
    di = w1.shape[1]
    p = float(p or 0.0)
    mask = lambda site, cols: dropout_scale(seed, site, 0, n, cols, p, h_in.device)
    a = a_pre @ wow + wob
    if p > 0.0:
        a = a * mask(1, d)
    h1 = ln(h_in + a, ln1s, ln1b)
    g = gelu_exact(h1 @ w1 + b1)
    if p > 0.0 and mid_drop:
        g = g * mask(2, di)
    x2 = g @ w2 + b2
    if p > 0.0:
        x2 = x2 * mask(3, d)
    return ln(h1 + x2, ln2s, ln2b)


def _check(h_in, a_pre, ws) -> None:
    n, d = h_in.shape
    di = ws[4].shape[1]
    if h_in.dtype == torch.bfloat16:
        raise NotImplementedError("attn_tail_block: the bfloat16 kernel is not ported yet "
                                  "(ROADMAP Queue 2); the CUDA kernel takes float32")
    expect = [(d, d), (d,), (d,), (d,), (d, di), (di,), (di, d), (d,), (d,), (d,)]
    names = ("wo_w", "wo_b", "ln1_scale", "ln1_bias", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b",
             "ln2_scale", "ln2_bias")
    for name, t in (("h_in", h_in), ("a_pre", a_pre)) + tuple(zip(names, ws)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: {t.dtype} (the kernel takes float32)")
        if t.device != h_in.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous and on {h_in.device}")
    if tuple(a_pre.shape) != (n, d):
        raise ValueError(f"a_pre: shape {tuple(a_pre.shape)}, expected {(n, d)}")
    for name, t, shape in zip(names, ws, expect):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if d % 4 or di % 4 or d > MAX_D:
        raise ValueError(f"d_model {d}, d_inner {di}: the kernel needs multiples of 4 "
                         f"and d_model <= {MAX_D}")


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("attn_tail")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmg_tail_scratch_floats.argtypes = [i, i, i, i]
        lib.rlmg_tail_scratch_floats.restype = ctypes.c_longlong
        lib.rlmg_attn_tail_fwd.argtypes = [p, p, p, p, p, p, f, f, i, i, i, i, p]
        lib.rlmg_attn_tail_fwd.restype = i
        lib.rlmg_attn_tail_bwd.argtypes = [p, p, p, p, p, p, p, f, f, i, i, i, i, p]
        lib.rlmg_attn_tail_bwd.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"attn_tail {what} kernel: {_lib().rlmg_error_string(rc).decode()}")


def forward_kernel(h_in, a_pre, ws, seed: torch.Tensor, p: float,
                   mid_drop: bool) -> torch.Tensor:
    """One forward launch on checked inputs (``ws``: the ten parameters in
    signature order; ``seed``: an int32 tensor on the card) -> out (N, D).
    Not counted in ``launches_fwd`` (the wrapper counts)."""
    n, d = h_in.shape
    di = ws[4].shape[1]
    lib = _lib()
    out = torch.empty_like(h_in)
    scratch = torch.empty(lib.rlmg_tail_scratch_floats(n, d, di, 0), dtype=torch.float32,
                          device=h_in.device)
    with torch.cuda.device(h_in.device):
        rc = lib.rlmg_attn_tail_fwd(h_in.data_ptr(), a_pre.data_ptr(), _ptrs(ws),
                                    out.data_ptr(), scratch.data_ptr(), seed.data_ptr(), p,
                                    1.0 / (1.0 - p), int(mid_drop), n, d, di,
                                    torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "forward")
    return out


def backward_kernel(h_in, a_pre, ws, dout, seed: torch.Tensor, p: float,
                    mid_drop: bool) -> list:
    """One backward launch (recomputing the forward from h_in, a_pre and
    the seed) -> the twelve gradients [dh_in, da_pre, d ws...].  Not
    counted in ``launches_bwd``."""
    n, d = h_in.shape
    di = ws[4].shape[1]
    lib = _lib()
    grads = [torch.empty_like(h_in), torch.empty_like(a_pre)] + [torch.empty_like(w)
                                                                  for w in ws]
    scratch = torch.empty(lib.rlmg_tail_scratch_floats(n, d, di, 1), dtype=torch.float32,
                          device=h_in.device)
    with torch.cuda.device(h_in.device):
        rc = lib.rlmg_attn_tail_bwd(h_in.data_ptr(), a_pre.data_ptr(), _ptrs(ws),
                                    dout.data_ptr(), _ptrs(grads), scratch.data_ptr(),
                                    seed.data_ptr(), p, 1.0 / (1.0 - p), int(mid_drop), n, d,
                                    di, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward")
    return grads


class _AttnTail(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_in, a_pre, wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b, seed,
                p: float, mid_drop: bool):
        ws = [wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b]
        out = forward_kernel(h_in, a_pre, ws, seed, p, mid_drop)
        attn_tail_block.launches_fwd += 1
        ctx.save_for_backward(h_in, a_pre, *ws, seed)
        ctx.cfg = (p, mid_drop)
        return out

    @staticmethod
    def backward(ctx, dout):
        h_in, a_pre, *ws, seed = ctx.saved_tensors
        grads = backward_kernel(h_in, a_pre, ws, dout.contiguous(), seed, *ctx.cfg)
        attn_tail_block.launches_bwd += 1
        return (*grads, None, None, None)


def attn_tail_block(h_in, a_pre, wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b,
                    seed: Seed, p: float, mid_drop: bool = True) -> torch.Tensor:
    """(h_in, a_pre) (N, D) -> LN2(h1 + FFN-tail(h1)), h1 = LN1(h_in +
    drop(Wo @ a_pre + bo)), fully fused.  ``seed``: an int or an int32
    tensor (a tensor on the card is read by the kernel without a host
    sync); ``p`` the dropout rate (0: no dropout).  The TPU kernel's row
    block has no counterpart: the masks do not depend on a tiling.
    Differentiable in the two inputs and the ten parameters."""
    if h_in.device.type == "cpu":
        return attn_tail_block_plain(h_in, a_pre, wow, wob, ln1s, ln1b, w1, b1, w2, b2,
                                     ln2s, ln2b, seed, p, mid_drop)
    if h_in.device.type != "cuda":
        raise ValueError(f"attn_tail_block: no kernel for device {h_in.device}")
    ws = [wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b]
    _check(h_in, a_pre, ws)
    p = float(p or 0.0)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    seed = torch.as_tensor(seed, dtype=torch.int32).to(h_in.device).reshape(())
    return _AttnTail.apply(h_in, a_pre, *ws, seed, p, bool(mid_drop))


attn_tail_block.launches_fwd = 0
attn_tail_block.launches_bwd = 0
