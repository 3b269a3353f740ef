"""Band (sliding-window) softmax attention, forward and backward, as one
kernel: the counterpart of the JAX package's
``ops/window_attention_kernel.py window_attention_pallas`` (Pallas bodies
``_fwd_kernel``, ``_dq_kernel``, ``_dkv_kernel``).

Each query i sees the keys j with |i - j| <= w = max(1, window // 2) that
the padding mask keeps.  Kernel E: ``csrc/window_attention.cu``,
hand-written CUDA for ``sm_90a``, built at first use (``_build.py``) and
called through ctypes.  The forward is flash attention restricted to the
band: one block of 4 warps per (batch x head, 64 query rows) walks the key
tiles of 64 that the band touches, with an online softmax in f32, and
writes out and each row's max score m and log l (LSE = m + log l).  The
backward is deterministic (no atomics): D = rowsum(dO * O); a dk/dv pass
over key tiles walks the mirrored band of query tiles, recomputes
P = exp((S - m) - log l) and writes each tile's dS to a scratch slot; a dq
pass over query tiles sums dS k over its key tiles in order.  Five tile
products, where the TPU's dq pass recomputed S and dP.  (The TPU kernel
recomputes exp(S - LSE), which in f32 loses log l in a row whose band
holds only masked keys, where m = -1e9.)  Every tile product runs on the
tensor cores at f32 grade, as JAX's kernel computes in f32 (:42-50, :56,
:80-81): each f32 tile is split once, in shared memory, into three bf16
planes, and each product is ``mma.sync``'s six plane products, each depth
of 16 summed afresh in f32; P and dS are split in registers.  The TPU's
256-row blocks with three clamped neighbours are not copied: the tile loop
covers any window.

Masks.  A key outside the band [i - w, i + w] ∩ [0, S) is not part of row
i's softmax at all; a key inside it that the padding mask drops takes the
finite score -1e9, as in the JAX kernel.  So every row is finite: a row
whose band holds no kept key (a padded row at the end of a song) is the
uniform average of its band.  The JAX kernels give such rows other finite
values (they spread the -1e9 rows over their blocks); callers use only
rows that see a kept key, and there the two agree.  Masked scores are
constants, so they pass no gradient to q or k.

``window_attention_band`` takes contiguous-in-the-last-dimension q, k, v
(B, H, S, D) of one type, float32 or bfloat16, with any strides that are
multiples of 4 (the Longformer passes transposed views of (B, S, H, D)
projections, so no copy), D a multiple of 4 and at most 64, and a (B, S)
mask (None = keep all).  Anything else raises, on every device.  On a CPU tensor it runs
``window_attention_band_plain``; on a CUDA tensor it launches the kernels
(counted in ``launches_fwd`` / ``launches_bwd``); any other device raises.

bfloat16 (JAX's kernel takes any dtype, computes in f32 and stores out and
the gradients in the inputs' dtype, lse in f32): the kernel copies each
tile into one bf16 plane (a bf16 value is exact in f32 and its own hi
plane) and takes one ``mma.sync`` a product where both operands are bf16,
three where one is (P and dS are f32): the f32 route's bits on the widened
tensors.  out, dq, dk and dv are rounded on store; D = rowsum(dO * O)
reads the stored, rounded out, as JAX's backward does.  The twin on bf16
tensors is ``_PlainBandBf16``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

NEG_INF = -1e9
MAX_HEAD_WIDTH = 64          # csrc/window_attention.cu WA_MAX_E


def pick_blocks(s: int, window: int) -> Tuple[int, int]:
    """(block_fwd_dq, block_kv) of the JAX kernel for a sequence length:
    the smallest multiple of 8 covering the one-sided window, at least 256.
    The CUDA kernel walks tiles of 64 and needs no block; the plain twin
    uses the first value as its query block."""
    w = max(1, window // 2)
    blk = max(256, ((w + 7) // 8) * 8)
    return blk, blk


def window_attention_band_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                mask: Optional[torch.Tensor],
                                window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in PyTorch ops: (out (B, H, S, D) in q's type,
    lse (B, H, S)).  On float32 tensors ``band_plain`` (autograd gives the
    backward); on bfloat16 ones JAX's arithmetic at bf16 (``_PlainBandBf16``)."""
    if q.dtype == torch.bfloat16:
        return _PlainBandBf16.apply(q, k, v, mask, window)
    return band_plain(q, k, v, mask, window)


class _PlainBandBf16(torch.autograd.Function):
    """``window_attention_pallas``'s arithmetic on bf16 q, k, v: widened to
    f32, scores, softmax and P v in f32, out rounded to bf16 on store, lse
    f32 (``_wa_fwd``); the backward's dr = sum(g out) taken in f32 from the
    stored, rounded out (``_wa_bwd`` :257), dS = P (dP - dr), and dq, dk, dv
    in f32, rounded on store.  The f32 backward comes from autograd of
    ``band_plain``, whose softmax gradient uses dr = g . out_f32; the
    cotangent c = g . (out_f32 - out) given to lse (d lse / d scores = P)
    turns its dS into P (dP - g . out)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, window: int):
        out, lse = band_plain(q.float(), k.float(), v.float(), mask, window)
        out = out.to(q.dtype)
        ctx.save_for_backward(q, k, v, out)
        ctx.mask, ctx.window = mask, window
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g, _g_lse):
        q, k, v, out = ctx.saved_tensors
        g = g.float()
        with torch.enable_grad():
            ins = [t.detach().float().requires_grad_(True) for t in (q, k, v)]
            out32, lse = band_plain(*ins, ctx.mask, ctx.window)
            c = (g * (out32.detach() - out.float())).sum(-1)
            grads = torch.autograd.grad((out32, lse), ins, (g, c))
        return tuple(d.to(t.dtype) for d, t in zip(grads, (q, k, v))) + (None, None)


def band_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: Optional[torch.Tensor],
               window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Band attention in PyTorch ops at the inputs' type (autograd gives
    the backward): (out (B, H, S, D), lse (B, H, S)).  Blocked over the
    queries, so memory stays O(S * window): each block of ``pick_blocks``
    rows sees its keys from a w-padded copy of k and v."""
    b, h, s, d = q.shape
    w = max(1, window // 2)
    blk = min(pick_blocks(s, window)[0], s)
    pad_s = (-s) % blk
    kw = blk + 2 * w
    scale = 1.0 / math.sqrt(d)
    qp = F.pad(q, (0, 0, 0, pad_s))
    kp = F.pad(k, (0, 0, w, w + pad_s))
    vp = F.pad(v, (0, 0, w, w + pad_s))
    keep = torch.ones((b, s), device=q.device) if mask is None else mask
    mp = F.pad(keep.to(torch.float32), (w, w + pad_s)) > 0
    row = torch.arange(blk, device=q.device)[:, None]
    col = torch.arange(kw, device=q.device)[None, :]
    outs, lses = [], []
    for qs in range(0, s + pad_s, blk):
        key = qs - w + col                                   # absolute key positions
        band = (col >= row) & (col <= row + 2 * w) & (key >= 0) & (key < s)
        band = band | (qs + row >= s)                        # past-the-end rows: any finite row
        scores = torch.einsum("bhqd,bhkd->bhqk", qp[:, :, qs:qs + blk],
                              kp[:, :, qs:qs + kw]) * scale
        scores = torch.where(mp[:, None, None, qs:qs + kw], scores, NEG_INF)
        scores = scores.masked_fill(~band, float("-inf"))
        # softmax subtracts the row max first: exact in a row of -1e9 scores,
        # where exp(scores - logsumexp) would lose log l
        p = torch.softmax(scores, dim=-1)
        lse = torch.logsumexp(scores, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, vp[:, :, qs:qs + kw]))
        lses.append(lse)
    return torch.cat(outs, dim=2)[:, :, :s], torch.cat(lses, dim=2)[:, :, :s]


def _kernel_ready(t: torch.Tensor) -> bool:
    """Layout the kernel reads: unit stride in D, 16-byte rows and base."""
    return (t.stride(-1) == 1 and all(st % 4 == 0 for st in t.stride()[:3])
            and t.data_ptr() % 16 == 0)


def _check(q, k, v, mask, window) -> None:
    d = q.shape[-1]
    if d % 4 or d > MAX_HEAD_WIDTH or d == 0:
        raise ValueError(f"window_attention_band: head width {d}; the kernel takes a multiple "
                         f"of 4 up to {MAX_HEAD_WIDTH}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != q.dtype:
            raise TypeError(f"window_attention_band {name}: {t.dtype} (the kernel takes "
                            f"float32 or bfloat16, q's {q.dtype} for all three)")
        if t.ndim != 4 or t.shape != q.shape or t.device != q.device:
            raise ValueError(f"window_attention_band {name}: shape {tuple(t.shape)} on "
                             f"{t.device}, expected q's {tuple(q.shape)} on {q.device}")
        if not _kernel_ready(t):
            raise ValueError(f"window_attention_band {name}: needs unit stride in the last "
                             f"dimension, other strides multiples of 4 and a 16-byte aligned "
                             f"start (strides {t.stride()})")
    b, _, s, _ = q.shape
    if mask is not None and (tuple(mask.shape) != (b, s) or mask.device != q.device):
        raise ValueError(f"window_attention_band mask: shape {tuple(mask.shape)} on "
                         f"{mask.device}, expected {(b, s)} on {q.device}")
    if not isinstance(window, int) or window < 0:
        raise ValueError(f"window_attention_band: window {window!r} is not an int >= 0")


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("window_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmg_window_attn_fwd.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, f, i, p]
        lib.rlmg_window_attn_fwd.restype = i
        lib.rlmg_window_attn_bwd.argtypes = [p] * 13 + [i, i, i, i, i, f, i, p]
        lib.rlmg_window_attn_bwd.restype = i
        lib.rlmg_window_attn_scratch_floats.argtypes = [i, i, i, i]
        lib.rlmg_window_attn_scratch_floats.restype = ctypes.c_longlong
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _strides(*tensors) -> ctypes.Array:
    """(batch, head, row) strides of each (B, H, S, D) tensor, in elements."""
    vals = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _raise_on(rc: int, what: str) -> None:
    if rc:
        raise RuntimeError(f"window_attention {what} kernel: "
                           f"{_lib().rlmg_error_string(rc).decode()}")


def _mask_f32(mask: Optional[torch.Tensor], q: torch.Tensor) -> torch.Tensor:
    b, _, s, _ = q.shape
    if mask is None:
        return torch.ones((b, s), dtype=torch.float32, device=q.device)
    return mask.to(torch.float32).contiguous()


def forward_kernel(q, k, v, mask32, window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """One forward launch on checked inputs (``mask32``: (B, S) float32,
    contiguous) -> (out in q's layout and type, stats (2, B, H, S) f32:
    each row's max score m and log l; the row's LSE is ``stats.sum(0)``).
    Not counted in ``launches_fwd`` (the wrapper counts)."""
    b, h, s, d = q.shape
    lib = _lib()
    out = torch.empty_like(q)
    stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
    w = max(1, window // 2)
    with torch.cuda.device(q.device):
        rc = lib.rlmg_window_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      mask32.data_ptr(), out.data_ptr(), stats.data_ptr(),
                                      _strides(q, k, v, out), b, h, s, d, w, 1.0 / math.sqrt(d),
                                      int(q.dtype == torch.bfloat16),
                                      torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "forward")
    return out, stats


def backward_kernel(q, k, v, mask32, out, stats, dout,
                    window: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The three backward launches (D = rowsum(dO * O), the dk/dv pass,
    then the dq pass) -> (dq, dk, dv), each in its input's layout and
    type.  Not counted in ``launches_bwd``."""
    b, h, s, d = q.shape
    if not _kernel_ready(dout) or dout.dtype != q.dtype:
        dout = dout.to(q.dtype).contiguous()
    lib = _lib()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rowdot = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    w = max(1, window // 2)
    dss = torch.empty(lib.rlmg_window_attn_scratch_floats(b, h, s, w), dtype=torch.float32,
                      device=q.device)
    with torch.cuda.device(q.device):
        rc = lib.rlmg_window_attn_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                      mask32.data_ptr(), out.data_ptr(), dout.data_ptr(),
                                      stats.data_ptr(), rowdot.data_ptr(), dss.data_ptr(),
                                      dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                                      _strides(q, k, v, out, dout, dq, dk, dv), b, h, s, d, w,
                                      1.0 / math.sqrt(d), int(q.dtype == torch.bfloat16),
                                      torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "backward")
    return dq, dk, dv


class _WindowBand(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask32, window: int):
        out, stats = forward_kernel(q, k, v, mask32, window)
        if not torch.cuda.is_current_stream_capturing():    # a capture records, launches nothing
            window_attention_band.launches_fwd += 1
        ctx.save_for_backward(q, k, v, mask32, out, stats)
        ctx.window = window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask32, out, stats = ctx.saved_tensors
        dq, dk, dv = backward_kernel(q, k, v, mask32, out, stats, dout, ctx.window)
        window_attention_band.launches_bwd += 1
        return dq, dk, dv, None, None


def window_attention_band(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask: Optional[torch.Tensor], window: int) -> torch.Tensor:
    """Band softmax attention (JAX ``window_attention_pallas``): q, k, v
    (B, H, S, D), mask (B, S) 1 = keep (None = keep all), window = full
    window (one-sided w = window // 2) -> out (B, H, S, D), differentiable
    in q, k and v."""
    _check(q, k, v, mask, window)
    if q.device.type == "cpu":
        return window_attention_band_plain(q, k, v, mask, window)[0]
    if q.device.type != "cuda":
        raise ValueError(f"window_attention_band: no kernel for device {q.device}")
    return _WindowBand.apply(q, k, v, _mask_f32(mask, q), window)


window_attention_band.launches_fwd = 0
window_attention_band.launches_bwd = 0
