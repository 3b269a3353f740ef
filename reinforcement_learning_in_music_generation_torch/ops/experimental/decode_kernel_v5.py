"""T decode tokens of any batch in one launch, batch-major state: the
counterpart of the JAX package's ``ops/experimental/decode_kernel_v5.py``
(``fused_decode_v5``, its Pallas body ``_v5_kernel``, grid (T,)).

Kernel: ``csrc/latency_decode.cu`` (``decode_v5_kernel``), hand-written CUDA
for ``sm_90a``: one cooperative launch of one block per SM decodes all T
tokens.  Per token the embedding rows, per layer the qkv product, the state
items (one a (song, head): S and z read and written once, 16-byte copies),
the Wo product, the LN1 rows, the two FFN products and the LN2 rows (the
final LN after the last layer), then the heads product and the sampling,
a grid barrier after each (7 L + 3 a token).  Every product (qkv, Wo, FFN1,
FFN2, heads) is one batch product on ``mma.sync``: items of (16, 32 or 64
songs, 64 columns) over the whole K, or over 2 or 4 depth slices where the
tiles alone would leave most SMs idle (small batches; the reading phase
adds the slices in order), their operand tiles staged by cp.async, each
product's input stored once as bf16 planes by the phase that forms it.  The f32 state stays in device memory in v5's layout, S (L,
B, E, H E) and z (L, B, H E).  ``bb`` (8, 16 or 32, dividing B) names the
TPU kernel's state block and is checked as JAX checks it; the arithmetic
does not depend on it (a ``bb`` that does not divide B raises
``ValueError``, as does a shape the kernel does not take; a cooperative
launch the card refuses raises RuntimeError).

The weights are kernel B's and v8's (``make_v5_params`` is
``make_resident_params``: the folded embedding M kept f32, as the JAX
function keeps ``memb``; the padded heads; the layer stack; with f32
weights on a card also the products' weights as three bf16 planes,
``V6Params.planes``, built once there), and the sampling is theirs: a
24-step bisection nucleus and Gumbel-max with Philox4x32-10 bits at counter
(t, field, vocab index, song), t the token's index in the call.  The TPU's
``prng_random_bits`` stream is not reproduced; JAX's v5 differs from its
XLA sampler in the same way.  As JAX's v5, the kernel rounds each product's
input activations to the weights' type (qkv, Wo, FFN1, FFN2, heads; JAX
:276, :329, :335, :338, :382: one bf16 plane) and sums in f32; with f32
weights the products run at f32 grade (both operands as three bf16 planes,
six products a depth of 16); M stays f32.

Plain twin: ``fused_decode_v5_plain``, kernel B's plain chunk in v6's
arithmetic (``decode_kernel_v6.fused_decode_v6_plain``, the same five
roundings, M in f32) on the unpacked state, with ``pe_rows`` as its
positional table and 0 as its first position.

``RLMG_V5_ABLATE`` (the kernel only, for attributing its time; the output
is garbage under it, as in JAX :65-69): ``state`` streams each layer's
state through and skips everything else of the layer, ``attn`` keeps the
products and streams the state through without its update and read.
``RLMG_V5_NOALIAS``, a TPU buffer-aliasing switch, has no counterpart: the
state is always updated in place.
"""

from __future__ import annotations

import ctypes
import os
from typing import Sequence, Tuple

import torch

from ..decode_kernel_v4 import _check_inputs, layer_weights
from ..decode_kernel_v6 import (PLANE_WEIGHTS, V6Params, _check_v6, _cuda_or_raise,
                                _field_arrays, argmax_first, fused_decode_v6_plain,
                                nucleus_keep)
from ..linear_attention import DEFAULT_EPS
from .decode_kernel_v8 import TILE, _lib, make_resident_params

# The JAX names of the shared sampling pieces (JAX :80, :110).
nucleus_keep_by_threshold = nucleus_keep
__all__ = ["V5Params", "make_v5_params", "nucleus_keep_by_threshold", "argmax_first",
           "pack_state", "unpack_state", "fused_decode_v5", "fused_decode_v5_plain", "plan"]

BB_CHOICES = (8, 16, 32)
_ABLATE = {"": 0, "state": 1, "attn": 2}

# The JAX V5Params' contents in the port's batch-major layout (kernel B's).
V5Params = V6Params


def make_v5_params(params: dict, cfg, dtype: torch.dtype = torch.bfloat16) -> V5Params:
    """The weights of JAX ``make_v5_params`` (:165-190): ``make_resident_params``
    with the layer and head matrices in ``dtype``; M stays f32.  With f32
    weights on a card it also holds the products' bf16 planes (``planes``),
    which the kernel reads."""
    return make_resident_params(params, cfg, dtype=dtype)


def pack_state(s: torch.Tensor, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """DecodeState (L, B, H, E, E), (L, B, H, E) -> v5 (L, B, E, H E),
    (L, B, H E): new contiguous tensors (the kernel updates them in place)."""
    L, b, h, e, _ = s.shape
    return (s.permute(0, 1, 3, 2, 4).reshape(L, b, e, h * e).contiguous(),
            z.reshape(L, b, h * e).clone())


def unpack_state(s5: torch.Tensor, z5: torch.Tensor, n_head: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v5 (L, B, E, H E), (L, B, H E) -> DecodeState (L, B, H, E, E),
    (L, B, H, E) (views)."""
    L, b, e, d = s5.shape
    return (s5.reshape(L, b, e, n_head, e).permute(0, 1, 3, 2, 4),
            z5.reshape(L, b, n_head, e))


def fused_decode_v5_plain(v5p: V5Params, tok0: torch.Tensor, s5: torch.Tensor,
                          z5: torch.Tensor, pe_rows: torch.Tensor, seed: int, *, n_head: int,
                          max_tokens: int, temps: Sequence[float], topps: Sequence[float],
                          greedy: bool = False, eps: float = DEFAULT_EPS):
    """The kernel's computation in PyTorch: ``fused_decode_v6_plain`` (JAX
    v5's arithmetic: each product's input activations rounded to the
    weights' dtype, f32 sums, the folded embedding M in f32) on the
    unpacked state, pe row and Philox position t for the t-th fed token.
    s5, z5 are updated in place."""
    s, z = unpack_state(s5, z5, n_head)
    s, z = s.contiguous(), z.contiguous()
    toks, s, z = fused_decode_v6_plain(v5p._replace(pe=pe_rows.float()), tok0, s, z, 0, seed,
                                       n_head=n_head, max_tokens=max_tokens, temps=temps,
                                       topps=topps, greedy=greedy, eps=eps)
    ps, pz = pack_state(s, z)
    s5.copy_(ps)
    z5.copy_(pz)
    return toks, s5, z5


def _ablate() -> int:
    name = os.environ.get("RLMG_V5_ABLATE", "")
    if name not in _ABLATE:
        raise ValueError(f"RLMG_V5_ABLATE={name!r}: expected 'state', 'attn' or unset")
    return _ABLATE[name]


PLAN_KEYS = ("rows", "stages", "state_warps", "slices_q", "slices_o", "slices_f1",
             "slices_f2", "slices_heads", "smem_bytes", "state_column_splits")


def plan(b: int, d: int, n_head: int, di: int, nf: int, bf16_weights: bool) -> dict:
    """The kernel's launch plan for this shape on the current card
    (``PLAN_KEYS``: rows of the product tiles, stages in flight, the warps
    a block gives the state items, each product's depth slices, shared
    bytes a block, the column splits of a state item); raises
    ``ValueError`` for a shape the kernel does not take."""
    lib = _lib()
    out = (ctypes.c_int * len(PLAN_KEYS))()
    rc = lib.rlmg_v5_plan(b, d, n_head, di, nf, int(bf16_weights), out)
    if rc:
        raise ValueError(f"fused_decode_v5: B={b}, d_model {d}, {n_head} heads, d_inner {di}, "
                         f"{nf} fields: the kernel takes head widths 4-128 (powers of two), "
                         f"d_model <= 1024 and d_model, d_inner multiples of {TILE} "
                         f"({lib.rlmg_error_string(rc).decode()})")
    return dict(zip(PLAN_KEYS, out))


def _product_weights(v5p: V5Params, ws) -> Tuple[list, list]:
    """Plane 0 of each product's weight (Wqkv, Wo, W1, W2, heads) and the
    elements between its planes: the bf16 leaves themselves, or the f32
    weights' three planes (``V6Params.planes``)."""
    mats = [ws[i] for i in PLANE_WEIGHTS] + [v5p.head_w]
    if ws[0].dtype == torch.bfloat16:
        return mats, [0] * len(mats)
    if v5p.planes is None:
        raise ValueError("fused_decode_v5: f32 weights need their bf16 planes "
                         "(make_v5_params on the card builds them)")
    for m, pl in zip(mats, v5p.planes):
        if (pl.dtype != torch.bfloat16 or tuple(pl.shape) != (3,) + tuple(m.shape)
                or not pl.is_contiguous() or pl.device != m.device):
            raise ValueError(f"fused_decode_v5: weight planes {tuple(pl.shape)} {pl.dtype}; "
                             f"expected contiguous bfloat16 (3, {tuple(m.shape)}) on {m.device}")
    return list(v5p.planes), [m.numel() for m in mats]


def fused_decode_v5(v5p: V5Params, tok0: torch.Tensor, s5: torch.Tensor, z5: torch.Tensor,
                    pe_rows: torch.Tensor, seed: int, *, n_head: int, max_tokens: int,
                    bb: int = 8, vocab_sizes: Sequence[int], temps: Sequence[float],
                    topps: Sequence[float], greedy: bool = False, eps: float = DEFAULT_EPS):
    """Decode ``max_tokens`` tokens in one launch (the JAX contract
    :417-424): tok0 (B, NF) int32 is the next token TO BE FED; s5 (L, B, E,
    H E) and z5 (L, B, H E), float32, are the packed state before it and are
    UPDATED IN PLACE; pe_rows (T, D) float32 are the positional rows of the
    T fed tokens.  Returns (tokens (T, B, NF) int32, s5, z5); the last token
    is emitted but not fed.  ``topps``: inf keeps every token.

    CUDA tensors go to the kernel (``launches`` counts the calls, one CUDA
    launch each; ``positions`` the token positions decoded); CPU tensors to
    ``fused_decode_v5_plain``; any other device raises."""
    nf = len(vocab_sizes)
    if tok0.dim() != 2 or tok0.shape[1] != nf or tok0.dtype != torch.int32:
        raise ValueError(f"tok0: expected int32 (B, {nf}), got {tok0.dtype} "
                         f"{tuple(tok0.shape)}")
    b = tok0.shape[0]
    if bb not in BB_CHOICES or b % bb:
        raise ValueError(f"fused_decode_v5: bb={bb} must be one of {BB_CHOICES} and divide "
                         f"the batch {b}")
    if pe_rows.dim() != 2 or pe_rows.shape[0] < max_tokens:
        raise ValueError(f"pe_rows {tuple(pe_rows.shape)}: need ({max_tokens}, D)")
    if tok0.device.type == "cpu":
        return fused_decode_v5_plain(v5p, tok0, s5, z5, pe_rows, seed, n_head=n_head,
                                     max_tokens=max_tokens, temps=temps, topps=topps,
                                     greedy=greedy, eps=eps)
    _cuda_or_raise(tok0, "fused_decode_v5")
    ablate = _ablate()
    d = v5p.fls.shape[0]
    L, e = s5.shape[0], d // n_head
    for name, t, shape in (("s5", s5, (L, b, e, d)), ("z5", z5, (L, b, d)),
                           ("pe_rows", pe_rows, (pe_rows.shape[0], d))):
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous()
                or t.device != tok0.device):
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}; expected a contiguous "
                             f"float32 {shape} on {tok0.device}")
    ws = layer_weights(v5p.layers)
    h_like = torch.empty((b, d), dtype=torch.float32, device=tok0.device)
    # the layer weights' checks; the state's shape was checked above
    L, b, d, H, di = _check_inputs(ws, h_like, s5.view(L, b, n_head, e, e),
                                   z5.view(L, b, n_head, e), n_head)
    _check_v6(v5p, h_like, nf)
    bf16 = ws[0].dtype == torch.bfloat16
    plan(b, d, H, di, nf, bf16)                      # raises for a shape it does not take
    mats, strides = _product_weights(v5p, ws)
    tinv, topp, off = _field_arrays(nf, temps, topps, v5p.field_off)
    lib = _lib()
    with torch.cuda.device(tok0.device):
        tok0 = tok0.contiguous()
        tokens = torch.empty((max_tokens, b, nf), dtype=torch.int32, device=tok0.device)
        scratch = torch.empty(lib.rlmg_v5_scratch_floats(b, d, H, di, nf, int(bf16)),
                              dtype=torch.float32, device=tok0.device)
        ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
        wp = (ctypes.c_void_p * len(mats))(*[t.data_ptr() for t in mats])
        wpl = (ctypes.c_longlong * len(strides))(*strides)
        rc = lib.rlmg_decode_v5(
            tok0.data_ptr(), tokens.data_ptr(), v5p.m.data_ptr(), v5p.b_in.data_ptr(),
            pe_rows.data_ptr(), ptrs, wp, wpl, v5p.head_b.data_ptr(), v5p.fls.data_ptr(),
            v5p.flb.data_ptr(), off, tinv, topp, s5.data_ptr(), z5.data_ptr(),
            scratch.data_ptr(), max_tokens, seed & 0xFFFFFFFF, int(greedy), L, b, d, H, di, nf,
            bb, eps, int(bf16), ablate, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"decode_v5 kernel: {lib.rlmg_error_string(rc).decode()}")
    fused_decode_v5.launches += 1
    fused_decode_v5.positions += max_tokens
    return tokens, s5, z5


fused_decode_v5.launches = fused_decode_v5.positions = 0
