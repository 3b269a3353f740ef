"""T decode tokens per call with on-card sampling: the counterpart of the
JAX package's ``ops/decode_kernel_v6.py`` (``fused_decode_v6``, its Pallas
body ``_v6_kernel``).

Kernel: ``csrc/decode_chunk.cu``, hand-written CUDA for ``sm_90a``, two
routes chosen by the weights' type.

* bf16 weights (``generate``'s default): the tensor-core route of
  ``csrc/decode_chunk_tc.cuh``.  JAX's v6 casts each product's input
  activations to the weights' type and sums in f32 (:255 qkv, :286 Wo,
  :292 and :296 the FFN, :331 the heads); here those products are
  ``mma.sync`` bf16 -> f32 tiles that stream the weights over K-split
  blocks, the bias / phi / gelu / residual / LN work sits in the passes
  around them, and the state pass reads and writes S and z once a token in
  16-byte pieces, one block per (song, head) (head widths 16, 32, 64 and
  128; a plainer pass takes the others).  One token's 7 L + 3 kernels are
  captured as a CUDA graph, one a shape, that reads the call's position,
  seed and sampling settings from a block on the card; a call launches one
  small kernel and the graph T times.
* f32 weights: per token an embed kernel, the layer stack of
  ``decode_kernel_v4`` (``csrc/decode_layers.cuh``, SIMT f32 products) and
  a heads + sample kernel, one block per (song, field).  v6's casts are
  no-ops there.

The TPU kernel's transposed layout (batch on the 128 lanes) was a fix for
the TPU's vector unit; here tensors are batch-major and the state keeps
the ``DecodeState`` layout.  Random bits come from Philox4x32-10 keyed by
(seed, absolute position, field, vocab index, song), so a chunk split into
two calls emits the same tokens (chunk invariance, the JAX contract
:33-43).  ``fused_decode_v6_plain``, the plain twin, has v6's arithmetic
(each product's input rounded to the weights' type, f32 sums) and draws
the same bits in torch integer ops (``decode_common.philox_bits``).  JAX's
v8, v7 and v5 round at the same five points, so it is also the twin of the
port's v5 and, with the folded embedding rounded to the weights' type as
JAX's v8 and v7 store it, of v8 and v7
(``experimental/decode_kernel_v8.latency_decode_plain``).

Bound on the H100 (details in the source): with bf16 weights at B=128 the
products (1.29 TFLOP a 128-token call) take 1.30 ms at 989 TFLOP/s, but the
bf16 state (102 MB) cannot stay on the card's chip, so streaming it every
token sets a floor near 10.8 ms a call; with f32 weights the f32 FMAs bind.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..models import common as cm
from ..models import linear_transformer as lt
from . import _build
from .decode_common import NEG, VF_PAD, gumbel_from_bits, ln, philox_bits
from .decode_kernel_v4 import _check_inputs, fused_stack_step_plain, layer_weights
from .linear_attention import DEFAULT_EPS

NUCLEUS_ITERS = 24


class V6Params(NamedTuple):
    """Batch-major counterpart of the JAX ``V6Params``."""
    layers: dict             # make_decode_params leaves, weights dtype
    m: torch.Tensor          # (sum V_f, D) f32: scaled embeddings @ in_linear rows
    field_off: Tuple[int, ...]  # first row of each field in m
    b_in: torch.Tensor       # (D,) f32 in_linear bias
    pe: torch.Tensor         # (max_len, D) f32 sinusoidal table
    head_w: torch.Tensor     # (D, NF*VF_PAD) weights dtype, zero in the padding
    head_b: torch.Tensor     # (NF*VF_PAD,) f32, NEG in the padding
    fls: torch.Tensor        # (D,) f32 final LN scale
    flb: torch.Tensor        # (D,) f32 final LN bias


def make_v6_params(params: dict, cfg, pe_table: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None) -> V6Params:
    """Fold the embeddings through in_linear (JAX make_v6_params :119-128)
    and pad the six heads to VF_PAD columns each.  ``dtype``: the layer and
    head weights' type (default: the params' own)."""
    f32 = torch.float32
    win = params["in_linear"]["w"]
    dtype = dtype or win.dtype
    dev = win.device
    names = cm.field_names(cfg.n_fields)
    rows, offs, col = [], [], 0
    for n, de in zip(names, cfg.emb_sizes):
        offs.append(sum(r.shape[0] for r in rows))
        tbl = params["emb"][n].to(f32) * math.sqrt(de)
        rows.append(tbl @ win[col:col + de].to(f32))
        col += de
    d = cfg.d_model
    head_w = torch.zeros((d, cfg.n_fields * VF_PAD), dtype=f32, device=dev)
    head_b = torch.full((cfg.n_fields * VF_PAD,), NEG, dtype=f32, device=dev)
    for f, (n, v) in enumerate(zip(names, cfg.vocab_sizes)):
        head_w[:, f * VF_PAD:f * VF_PAD + v] = params["heads"][n]["w"].to(f32)
        head_b[f * VF_PAD:f * VF_PAD + v] = params["heads"][n]["b"].to(f32)
    if pe_table is None:
        pe_table = cm.sinusoidal_table(cfg.max_len, d, f32, dev)
    return V6Params(
        layers=lt.make_decode_params(params, cfg, dtype),
        m=torch.cat(rows).contiguous(), field_off=tuple(offs),
        b_in=params["in_linear"]["b"].to(f32).contiguous(),
        pe=pe_table.to(f32).contiguous(),
        head_w=head_w.to(dtype).contiguous(), head_b=head_b,
        fls=params["final_ln"]["scale"].to(f32).contiguous(),
        flb=params["final_ln"]["bias"].to(f32).contiguous())


# -- plain pieces (JAX nucleus_keep_sub :169, argmax_first_sub :187) --------

def nucleus_keep(p: torch.Tensor, top_p: torch.Tensor,
                 iters: int = NUCLEUS_ITERS) -> torch.Tensor:
    """Sort-free nucleus keep-mask over the last axis: bisect for the
    largest threshold whose kept mass still exceeds top_p."""
    lo = torch.zeros_like(p[..., :1])
    hi = torch.ones_like(p[..., :1])
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        mass = torch.where(p > mid, p, torch.zeros((), device=p.device)).sum(-1, keepdim=True)
        pred = mass > top_p
        lo, hi = torch.where(pred, mid, lo), torch.where(pred, hi, mid)
    return p > lo


def argmax_first(score: torch.Tensor) -> torch.Tensor:
    """First maximal index over the last axis."""
    n = score.shape[-1]
    iota = torch.arange(n, device=score.device)
    hit = score == score.max(dim=-1, keepdim=True).values
    return torch.where(hit, iota, n).min(dim=-1).values


def embed_plain(v6p: V6Params, tok: torch.Tensor, pos: int) -> torch.Tensor:
    """h (B, D) f32 = sum_f m[off_f + tok_f] + b_in + pe[pos], summed in
    field order as the kernel does."""
    acc = torch.zeros((tok.shape[0], v6p.m.shape[1]), dtype=torch.float32,
                      device=tok.device)
    for f, off in enumerate(v6p.field_off):
        acc = acc + v6p.m[off + tok[:, f].long()]
    return (acc + v6p.b_in) + v6p.pe[pos]


def heads_sample_plain(v6p: V6Params, h: torch.Tensor, *, seed: int, pos: int,
                       temps: Sequence[float], topps: Sequence[float],
                       greedy: bool = False, round_to: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Final LN, padded heads, temperature, nucleus, Gumbel-max on h (B, D)
    -> tokens (B, NF) int32.  Bits: Philox at (pos, field, vocab id, song).
    ``round_to``: round the head product's input to this dtype first (v6)."""
    b, nf, dev = h.shape[0], len(temps), h.device
    hf = ln(h.float(), v6p.fls, v6p.flb)
    if round_to is not None:
        hf = hf.to(round_to).float()
    logits = hf @ v6p.head_w.float() + v6p.head_b
    tinv = torch.tensor([1.0 / t for t in temps], dtype=torch.float32, device=dev)
    x = logits.reshape(b, nf, VF_PAD) * tinv[None, :, None]
    if greedy:
        return argmax_first(x).to(torch.int32)
    ex = torch.exp(x - x.max(dim=-1, keepdim=True).values)
    p = ex / (ex.sum(dim=-1, keepdim=True) * (1.0 + 1e-5))
    topp = torch.tensor(list(topps), dtype=torch.float32, device=dev)[None, :, None]
    keep = nucleus_keep(p, topp)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=dev)
    bits = philox_bits(seed, torch.tensor(pos, dtype=torch.int64, device=dev),
                       ar(nf)[None, :, None], ar(VF_PAD)[None, None, :],
                       ar(b)[:, None, None])
    score = torch.where(keep, x + gumbel_from_bits(bits),
                        torch.tensor(NEG, device=dev))
    return argmax_first(score).to(torch.int32)


def _chunk_plain(v6p: V6Params, tok0, s, z, t0: int, seed: int, *, n_head: int,
                 max_tokens: int, temps, topps, greedy: bool, eps: float,
                 round_to: Optional[torch.dtype]):
    out = torch.empty((max_tokens,) + tuple(tok0.shape), dtype=torch.int32,
                      device=tok0.device)
    tok = tok0
    for t in range(max_tokens):
        h = embed_plain(v6p, tok, t0 + t)
        h, s, z = fused_stack_step_plain(v6p.layers, h, s, z, n_head=n_head, eps=eps,
                                         round_to=round_to)
        tok = heads_sample_plain(v6p, h, seed=seed, pos=t0 + t, temps=temps,
                                 topps=topps, greedy=greedy, round_to=round_to)
        out[t] = tok
    return out, s, z


def fused_decode_v6_plain(v6p: V6Params, tok0, s, z, t0: int, seed: int, *,
                          n_head: int, max_tokens: int, temps, topps,
                          greedy: bool = False, eps: float = DEFAULT_EPS):
    """The kernel's computation in PyTorch, token by token, with v6's
    arithmetic: each product's input activations rounded to the weights'
    dtype, f32 sums (with f32 weights the rounding is a no-op: v4's
    arithmetic, f32 activations)."""
    return _chunk_plain(v6p, tok0, s, z, t0, seed, n_head=n_head, max_tokens=max_tokens,
                        temps=temps, topps=topps, greedy=greedy, eps=eps,
                        round_to=v6p.head_w.dtype)


# -- the kernel ---------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_chunk")
        p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
        lib.rlmg_stack_scratch_floats.argtypes = [i, i, i]
        lib.rlmg_stack_scratch_floats.restype = ctypes.c_longlong
        lib.rlmg_decode_chunk.argtypes = [p] * 17 + [i, i, u, i, i, i, i, i, i, i, f, i, p]
        lib.rlmg_decode_chunk.restype = i
        lib.rlmg_tc_workspace_bytes.argtypes = [i, i, i, i]
        lib.rlmg_tc_workspace_bytes.restype = ctypes.c_longlong
        lib.rlmg_decode_chunk_tc.argtypes = ([p] * 16 + [i, i, u, i, i, i, i, i, i, i, f, i]
                                             + [p, p])
        lib.rlmg_decode_chunk_tc.restype = i
        lib.rlmg_heads_sample.argtypes = [p] * 8 + [i, i, i, i, u, i, i, p]
        lib.rlmg_heads_sample.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _field_arrays(nf: int, temps, topps, field_off=None):
    if not (len(temps) == len(topps) == nf) or nf > 8:
        raise ValueError(f"temps/topps: need {nf} (<= 8) values each")
    floats = ctypes.c_float * nf
    off = (ctypes.c_int * nf)(*field_off) if field_off is not None else None
    return floats(*[1.0 / t for t in temps]), floats(*topps), off


def _check_v6(v6p: V6Params, h_like: torch.Tensor, nf: int) -> None:
    d = v6p.fls.shape[0]
    for name in ("m", "b_in", "pe", "head_b", "fls", "flb"):
        t = getattr(v6p, name)
        if t.dtype != torch.float32 or t.device != h_like.device or not t.is_contiguous():
            raise ValueError(f"v6 params {name}: expected contiguous float32 on {h_like.device}")
    hw = v6p.head_w
    if (tuple(hw.shape) != (d, nf * VF_PAD) or hw.device != h_like.device
            or not hw.is_contiguous() or hw.dtype != v6p.layers["qkv_w"].dtype):
        raise ValueError(f"v6 params head_w: expected contiguous ({d}, {nf * VF_PAD}) "
                         "in the layer weights' dtype")


def _cuda_or_raise(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")


def tc_shape_error(d: int, n_head: int, di: int) -> Optional[str]:
    """Why the tensor-core route does not take this shape, or None
    (``csrc/decode_chunk_tc.cuh tc_shape_ok``)."""
    e = d // n_head
    if e * n_head != d or e > 128:
        return f"head width {d}/{n_head}: the state pass takes whole widths up to 128"
    if d % 8 or di % 8 or d > 2048:
        return f"d_model {d}, d_inner {di}: need multiples of 8, d_model <= 2048"
    return None


def fused_decode_v6(v6p: V6Params, tok0: torch.Tensor, s: torch.Tensor,
                    z: torch.Tensor, t0: int, seed: int, *, n_head: int,
                    max_tokens: int, vocab_sizes: Sequence[int],
                    temps: Sequence[float], topps: Sequence[float],
                    greedy: bool = False, eps: float = DEFAULT_EPS):
    """Decode ``max_tokens`` tokens (the JAX contract :370-379): tok0
    (B, NF) int32 is the next token TO BE FED, at position t0; s/z is the
    state before it and is UPDATED IN PLACE.  Returns (tokens (T, B, NF)
    int32, s, z); s/z then reflect tok0 and the first T-1 emitted tokens
    (the last one is the next call's tok0).  ``topps``: inf keeps every
    token.  tok0 must hold valid ids.

    CUDA tensors go to the kernel: bf16 weights to the tensor-core route
    (``tc_shape_error`` says which shapes it takes; others raise), f32
    weights to the SIMT route.  ``launches`` counts the calls of either;
    the tensor-core route's also ``tc_calls``, ``cuda_launches`` (one
    kernel and T graph launches a call), ``positions`` (tokens decoded),
    ``graph_kernels`` (kernels in a token's graph), ``captures`` (token
    graphs instantiated: one a shape) and ``updates`` (the shape's graph
    brought to a call's new pointers in place); ``reset_counts`` zeroes
    them.  The seed, position and sampling settings reach the graph through
    a block on the card, so a new request with the same pointers launches
    it as it is.  CPU tensors go to
    ``fused_decode_v6_plain``."""
    nf = len(vocab_sizes)
    if tuple(tok0.shape[1:]) != (nf,) or tok0.dtype != torch.int32:
        raise ValueError(f"tok0: expected int32 (B, {nf}), got {tok0.dtype} {tuple(tok0.shape)}")
    if t0 < 0 or t0 + max_tokens > v6p.pe.shape[0]:
        raise ValueError(f"positions {t0}..{t0 + max_tokens - 1} outside the pe table "
                         f"({v6p.pe.shape[0]} rows)")
    if tok0.device.type == "cpu":
        return fused_decode_v6_plain(v6p, tok0, s, z, t0, seed, n_head=n_head,
                                     max_tokens=max_tokens, temps=temps, topps=topps,
                                     greedy=greedy, eps=eps)
    _cuda_or_raise(tok0, "fused_decode_v6")
    b = tok0.shape[0]
    d = v6p.fls.shape[0]
    ws = layer_weights(v6p.layers)
    h = torch.empty((b, d), dtype=torch.float32, device=tok0.device)
    L, b, d, H, di = _check_inputs(ws, h, s, z, n_head)
    _check_v6(v6p, h, nf)
    if max_tokens < 1:
        raise ValueError(f"max_tokens: {max_tokens} (at least 1)")
    tok0 = tok0.contiguous()
    tinv, topp, off = _field_arrays(nf, temps, topps, v6p.field_off)
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
    common = (v6p.m.data_ptr(), v6p.b_in.data_ptr(), v6p.pe.data_ptr(), ptrs,
              v6p.head_w.data_ptr(), v6p.head_b.data_ptr(), v6p.fls.data_ptr(),
              v6p.flb.data_ptr(), off, tinv, topp, s.data_ptr(), z.data_ptr())
    s_bf16 = int(s.dtype == torch.bfloat16)
    with torch.cuda.device(tok0.device):
        stream = torch.cuda.current_stream().cuda_stream
        if ws[0].dtype == torch.bfloat16:
            why = tc_shape_error(d, H, di)
            if why is not None:
                raise ValueError(f"fused_decode_v6 (bf16 weights): {why}")
            # rows for 128 tokens at least, so that the chunks of a request
            # ask the allocator for one size and the graph's pointers repeat
            tok = torch.empty((max(max_tokens, 128) + 1, b, nf), dtype=torch.int32,
                              device=tok0.device)
            work = torch.empty(lib.rlmg_tc_workspace_bytes(b, d, di, nf), dtype=torch.uint8,
                               device=tok0.device)
            info = (ctypes.c_int * 3)()
            rc = lib.rlmg_decode_chunk_tc(
                tok0.data_ptr(), tok.data_ptr(), *common, work.data_ptr(), max_tokens, t0,
                seed & 0xFFFFFFFF, int(greedy), L, b, d, H, di, nf, eps, s_bf16, stream, info)
            if rc:
                raise RuntimeError(f"decode_chunk kernel: {lib.rlmg_error_string(rc).decode()}")
            tokens = tok[1:max_tokens + 1].clone()
            f = fused_decode_v6
            f.tc_calls += 1
            f.cuda_launches += info[0]
            f.positions += max_tokens
            f.graph_kernels = info[1]
            f.updates += info[2] == 1
            f.captures += info[2] == 2
        else:
            tokens = torch.empty((max_tokens, b, nf), dtype=torch.int32, device=tok0.device)
            scratch = torch.empty(lib.rlmg_stack_scratch_floats(b, d, di),
                                  dtype=torch.float32, device=tok0.device)
            rc = lib.rlmg_decode_chunk(
                tok0.data_ptr(), tokens.data_ptr(), *common, h.data_ptr(), scratch.data_ptr(),
                max_tokens, t0, seed & 0xFFFFFFFF, int(greedy), L, b, d, H, di, nf, eps,
                s_bf16, stream)
            if rc:
                raise RuntimeError(f"decode_chunk kernel: {lib.rlmg_error_string(rc).decode()}")
    fused_decode_v6.launches += 1
    return tokens, s, z


def reset_counts() -> None:
    """Zero ``fused_decode_v6``'s counters."""
    f = fused_decode_v6
    f.launches = f.tc_calls = f.cuda_launches = f.positions = 0
    f.graph_kernels = f.captures = f.updates = 0


reset_counts()


def heads_sample(v6p: V6Params, h: torch.Tensor, *, seed: int, pos: int,
                 temps: Sequence[float], topps: Sequence[float],
                 greedy: bool = False) -> torch.Tensor:
    """The SIMT heads + sample pass alone (the f32 route's, and v8's and
    v7's), on h (B, D) f32 (before the final LN) -> tokens (B, NF) int32,
    for holding it against ``heads_sample_plain``.  CPU tensors take the
    plain version."""
    if h.device.type == "cpu":
        return heads_sample_plain(v6p, h, seed=seed, pos=pos, temps=temps,
                                  topps=topps, greedy=greedy)
    _cuda_or_raise(h, "heads_sample")
    nf = len(temps)
    if h.dtype != torch.float32 or not h.is_contiguous() or h.dim() != 2:
        raise TypeError("h: expected a contiguous float32 (B, D) tensor")
    _check_v6(v6p, h, nf)
    b, d = h.shape
    if d != v6p.fls.shape[0] or d > 2048:
        raise ValueError(f"h: width {d}, params {v6p.fls.shape[0]} (at most 2048)")
    tinv, topp, _ = _field_arrays(nf, temps, topps)
    lib = _lib()
    with torch.cuda.device(h.device):
        out = torch.empty((b, nf), dtype=torch.int32, device=h.device)
        rc = lib.rlmg_heads_sample(
            h.data_ptr(), v6p.head_w.data_ptr(), v6p.head_b.data_ptr(),
            v6p.fls.data_ptr(), v6p.flb.data_ptr(), tinv, topp, out.data_ptr(),
            b, d, nf, pos, seed & 0xFFFFFFFF, int(greedy),
            int(v6p.head_w.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"heads_sample kernel: {lib.rlmg_error_string(rc).decode()}")
    heads_sample.launches += 1
    return out


heads_sample.launches = 0
