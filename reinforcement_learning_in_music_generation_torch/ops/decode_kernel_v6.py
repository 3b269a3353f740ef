"""T decode tokens per call with on-card sampling: the counterpart of the
JAX package's ``ops/decode_kernel_v6.py`` (``fused_decode_v6``, its Pallas
body ``_v6_kernel``).

Kernel: ``csrc/decode_chunk.cu`` + ``csrc/decode_chunk_tc.cuh``,
hand-written CUDA for ``sm_90a``: every product on the tensor cores
(``mma.sync`` bf16 -> f32 tiles that stream the weights over K-split
blocks), the bias / phi / gelu / residual / LN work in the passes around
them, and the state pass reading and writing S and z once a token in
16-byte pieces, one block per (song, head) (head widths 16, 32, 64 and
128; a plainer pass takes the others).  One token's 7 L + 3 kernels are
captured as a CUDA graph, one a shape and weight type, that reads the
call's position, seed and sampling settings from a block on the card; a
call launches one small kernel and the graph T times.  JAX's v6 casts each
product's input activations to the weights' type and sums in f32 (:255
qkv, :286 Wo, :292 and :296 the FFN, :331 the heads):

* bf16 weights (``generate``'s default): one bf16 product a product, the
  activations rounded to bf16 by the passes that write them;
* f32 weights: the cast is a no-op, so the products are taken at f32
  grade: each operand as three bf16 planes (x = hi + mid + lo) and six
  bf16 products a product, each depth of 16 summed afresh in f32.  The
  weights' planes are packed once by ``make_v6_params`` (``weight_planes``,
  rows padded to a multiple of 8 with zeros), so any d_model and d_inner
  go in; the activations' planes are written by the passes.

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
token sets a floor near 10.8 ms a call; with f32 weights the products take
7.8 ms at 989/6 TFLOP/s and streaming the f32 weights and the state every
token about 13.7 ms.
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
    # f32 weights on a card: the products' weights (qkv, wo, f1, f2, heads)
    # as weight_planes, the tensor-core route's operands; else None
    planes: Optional[Tuple[torch.Tensor, ...]] = None


PLANE_WEIGHTS = (0, 2, 6, 8)   # qkv_w, wo_w, f1_w, f2_w in layer_weights order


def weight_planes(w: torch.Tensor) -> torch.Tensor:
    """An f32 (..., K, N) weight as three bf16 planes (3, ..., K, N8), N8 =
    N rounded up to a multiple of 8 (zeros in the padding): hi = bf16(w),
    mid = bf16(w - hi), lo = bf16(w - hi - mid), each rounded to nearest
    even and each remainder exact in f32, so hi + mid + lo holds w's 24
    bits (csrc/decode_chunk_tc.cuh's arithmetic for f32 weights)."""
    if w.dtype != torch.float32:
        raise TypeError(f"weight_planes: {w.dtype} (takes float32)")
    n = w.shape[-1]
    w = torch.nn.functional.pad(w, (0, (-n) % 8))
    hi = w.to(torch.bfloat16)
    r = w - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo]).contiguous()


def make_v6_params(params: dict, cfg, pe_table: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None) -> V6Params:
    """Fold the embeddings through in_linear (JAX make_v6_params :119-128)
    and pad the six heads to VF_PAD columns each.  ``dtype``: the layer and
    head weights' type (default: the params' own).  With f32 weights on a
    card it also packs the products' weights into their bf16 planes
    (``planes``), which the kernel reads: 1.5 times the f32 matrices'
    bytes."""
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
    layers = lt.make_decode_params(params, cfg, dtype)
    head_w = head_w.to(dtype).contiguous()
    planes = None
    if dtype == f32 and dev.type == "cuda":
        ws = layer_weights(layers)
        planes = tuple(weight_planes(t) for t in [ws[i] for i in PLANE_WEIGHTS] + [head_w])
    return V6Params(
        layers=layers,
        m=torch.cat(rows).contiguous(), field_off=tuple(offs),
        b_in=params["in_linear"]["b"].to(f32).contiguous(),
        pe=pe_table.to(f32).contiguous(),
        head_w=head_w, head_b=head_b,
        fls=params["final_ln"]["scale"].to(f32).contiguous(),
        flb=params["final_ln"]["bias"].to(f32).contiguous(), planes=planes)


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
        lib.rlmg_tc_workspace_bytes.argtypes = [i, i, i, i, i]
        lib.rlmg_tc_workspace_bytes.restype = ctypes.c_longlong
        lib.rlmg_decode_chunk_tc.argtypes = ([p] * 17 + [i, i, u, i, i, i, i, i, i, i, f, i, i]
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


def tc_shape_error(d: int, n_head: int, di: int, f32_weights: bool = False) -> Optional[str]:
    """Why the kernel does not take this shape, or None
    (``csrc/decode_chunk_tc.cuh tc_shape_ok``): head widths up to 128 and
    d_model up to 2048; bf16 weights are read in place in 16-byte pieces,
    so d_model and d_inner must be multiples of 8 (f32 weights reach it as
    padded planes)."""
    e = d // n_head
    if e * n_head != d or e > 128:
        return f"head width {d}/{n_head}: the state pass takes whole widths up to 128"
    if d > 2048:
        return f"d_model {d}: at most 2048"
    if not f32_weights and (d % 8 or di % 8):
        return f"d_model {d}, d_inner {di}: bf16 weights need multiples of 8"
    return None


def _check_planes(v6p: V6Params, ws, dev) -> None:
    """The f32 weights' planes: present, on the card, the packed shapes of
    the products' weights."""
    if v6p.planes is None:
        raise ValueError("fused_decode_v6 (f32 weights): the params carry no weight planes; "
                         "make them with make_v6_params on the card")
    mats = [ws[i] for i in PLANE_WEIGHTS] + [v6p.head_w]
    for t, w in zip(v6p.planes, mats):
        n = w.shape[-1]
        shape = (3,) + tuple(w.shape[:-1]) + (n + (-n) % 8,)
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"fused_decode_v6 (f32 weights): planes {tuple(t.shape)} "
                             f"{t.dtype} on {t.device}, expected contiguous bfloat16 {shape} "
                             f"on {dev} (weight_planes)")


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

    CUDA tensors go to the kernel, bf16 and f32 weights alike
    (``tc_shape_error`` says which shapes it takes; others raise; f32
    weights need the planes ``make_v6_params`` packs on the card).
    ``launches`` and ``tc_calls`` count the calls, ``cuda_launches`` the
    CUDA launches (one kernel and T graph launches a call), ``positions``
    the tokens decoded, ``graph_kernels`` the kernels in a token's graph,
    ``captures`` the token graphs instantiated (one a shape and weight
    type) and ``updates`` the shape's graph brought to a call's new
    pointers in place; ``reset_counts`` zeroes them.  The seed, position
    and sampling settings reach the graph through a block on the card, so a
    new request with the same pointers launches it as it is.  CPU tensors
    go to ``fused_decode_v6_plain``."""
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
    w_f32 = ws[0].dtype == torch.float32
    why = tc_shape_error(d, H, di, w_f32)
    if why is not None:
        raise ValueError(f"fused_decode_v6 ({'f32' if w_f32 else 'bf16'} weights): {why}")
    planes = None
    if w_f32:
        _check_planes(v6p, ws, tok0.device)
        planes = (ctypes.c_void_p * (3 * len(v6p.planes)))(
            *[t[i].data_ptr() for t in v6p.planes for i in range(3)])
    tok0 = tok0.contiguous()
    tinv, topp, off = _field_arrays(nf, temps, topps, v6p.field_off)
    lib = _lib()
    ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
    with torch.cuda.device(tok0.device):
        stream = torch.cuda.current_stream().cuda_stream
        # rows for 128 tokens at least, so that the chunks of a request ask
        # the allocator for one size and the graph's pointers repeat
        tok = torch.empty((max(max_tokens, 128) + 1, b, nf), dtype=torch.int32,
                          device=tok0.device)
        work = torch.empty(lib.rlmg_tc_workspace_bytes(b, d, di, nf, int(w_f32)),
                           dtype=torch.uint8, device=tok0.device)
        info = (ctypes.c_int * 3)()
        rc = lib.rlmg_decode_chunk_tc(
            tok0.data_ptr(), tok.data_ptr(), v6p.m.data_ptr(), v6p.b_in.data_ptr(),
            v6p.pe.data_ptr(), ptrs, v6p.head_w.data_ptr(), planes, v6p.head_b.data_ptr(),
            v6p.fls.data_ptr(), v6p.flb.data_ptr(), off, tinv, topp, s.data_ptr(),
            z.data_ptr(), work.data_ptr(), max_tokens, t0, seed & 0xFFFFFFFF, int(greedy), L,
            b, d, H, di, nf, eps, int(s.dtype == torch.bfloat16), int(w_f32), stream, info)
    if rc:
        raise RuntimeError(f"decode_chunk kernel: {lib.rlmg_error_string(rc).decode()}")
    tokens = tok[1:max_tokens + 1].clone()
    f = fused_decode_v6
    f.launches += 1
    f.tc_calls += 1
    f.cuda_launches += info[0]
    f.positions += max_tokens
    f.graph_kernels = info[1]
    f.updates += info[2] == 1
    f.captures += info[2] == 2
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
    """The SIMT heads + sample pass alone (v8's and v7's), on h (B, D) f32
    (before the final LN) -> tokens (B, NF) int32, for holding it against
    ``heads_sample_plain``.  CPU tensors take the plain version."""
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
