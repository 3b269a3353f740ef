"""Latency-mode decode, one launch per chunk: the counterpart of the JAX
package's ``ops/experimental/decode_kernel_v8.py`` (``fused_decode_v8``,
its Pallas body ``_v8_kernel``).

Kernel: ``csrc/latency_decode.cu``, hand-written CUDA for ``sm_90a``.  One
persistent cooperative launch of one block per SM decodes the whole chunk,
4 grid-wide barriers a layer and 2 a token more (``barriers_per_token``;
the kernels count those they pass, ``barriers_passed``):
per layer the qkv product (each block forms the layer input, the embedding
or LN2, itself), the state update and the head's share of Wo per (song,
head) slice, added across heads behind a counter per song, FFN1 (each block
forms LN1 itself) and FFN2; then the heads product and the sampling.  Every
block streams the weight tiles of its coming items through a ring of 8 KB
shared-memory slots filled by TMA copies, so the weights are in flight
across the barriers; with bf16 weights the qkv, FFN and heads products
are ``mma.sync`` bf16 -> f32 (f32 weights keep f32 FMAs), and each
slice's Wo share stays an f32 FMA loop (a head's Wo rows read once for
each of the B songs).  Each block keeps its (layer,
song, head) slices of the state in shared memory for the whole chunk, the
counterpart of v8's VMEM-resident state.  The TPU kernel's head-pair
packing and its batch padding to 8 rows are TPU layout details and are not
ported: the state keeps the ``DecodeState`` layout, s (L,B,H,E,E) and z
(L,B,H,E), as kernels A and B do.

Arithmetic and plain twin: ``latency_decode_plain``, shared with
``decode_kernel_v7``.  JAX's v8 rounds each product's input activations to
the weights' type (qkv, Wo, FFN1, FFN2, heads; f32 sums) and stores the
folded embedding ``memb`` in that type; the kernel does both, and the twin
is kernel B's plain chunk in v6's arithmetic (``fused_decode_v6_plain``,
the same five roundings) on the embedding rows rounded to the weights'
type.  Sampling is kernel B's (Philox counter: position, field, vocab
index, song), so a chunk split in two calls emits the same tokens.  With
f32 weights every rounding is a no-op.

The wrapper refuses (``ValueError``) a batch above ``MAX_BATCH``, a
d_model above ``MAX_D``, and a resident state that leaves no room for two
ring slots in a block's shared memory (an f32 state at large B), as the
JAX wrapper refuses one beyond its VMEM budget (``decode_kernel_v8.py:346``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from ..decode_kernel_v4 import _check_inputs, layer_weights
from ..decode_kernel_v6 import (V6Params, _check_v6, _cuda_or_raise, _field_arrays,
                                fused_decode_v6_plain, make_v6_params)
from ..linear_attention import DEFAULT_EPS

MAX_BATCH = 16          # csrc/latency_decode.cu LT_MAX_B
TILE = 64               # d_model, d_inner multiples of it (v5's stages of 64 depths)
MAX_D = 1024            # LP_MAX_D: v8 and v7 hold two rows of d_model a warp in registers

# The resident layout of the JAX ResidentParams, batch-major: the folded
# embedding, the padded heads and the final LN of make_v6_params, and the
# stacked layer weights of lt.make_decode_params (its ``layers``).
ResidentParams = V6Params


def make_resident_params(params: dict, cfg, pe_table: Optional[torch.Tensor] = None,
                         dtype: Optional[torch.dtype] = None) -> ResidentParams:
    """The JAX ``make_resident_params`` (:84-137) in the port's layout:
    ``make_v6_params`` (the fold, the heads, the layer stack).  ``dtype``:
    the layer and head weights' type (default: the params' own)."""
    return make_v6_params(params, cfg, pe_table, dtype)


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("latency_decode")
        p, i, u, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float, \
            ctypes.c_longlong
        lib.rlmg_latency_scratch_floats.argtypes = [i, i, i, i]
        lib.rlmg_latency_scratch_floats.restype = ll
        lib.rlmg_latency_smem_bytes.argtypes = [i] * 8
        lib.rlmg_latency_smem_bytes.restype = ll
        lib.rlmg_latency_barriers_per_token.argtypes = [i]
        lib.rlmg_latency_barriers_per_token.restype = i
        lib.rlmg_latency_barriers_passed.argtypes = [i]
        lib.rlmg_latency_barriers_passed.restype = ll
        lib.rlmg_latency_card.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.rlmg_latency_card.restype = i
        lib.rlmg_latency_decode.argtypes = ([i] + [p] * 16 + [i, i, u, i, i, i, i, i, i, i, f,
                                                             i, i, p, p])
        lib.rlmg_latency_decode.restype = i
        lib.rlmg_decode_v5.argtypes = [p] * 17 + [i, u] + [i] * 8 + [f, i, i, p]
        lib.rlmg_decode_v5.restype = i
        lib.rlmg_v5_scratch_floats.argtypes = [i] * 6
        lib.rlmg_v5_scratch_floats.restype = ll
        lib.rlmg_v5_plan.argtypes = [i] * 6 + [ctypes.POINTER(i)]
        lib.rlmg_v5_plan.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def card_limits() -> tuple:
    """(SM count, shared bytes one block may opt in to) of the current card."""
    lib = _lib()
    n_sm, smem = ctypes.c_int(), ctypes.c_int()
    rc = lib.rlmg_latency_card(ctypes.byref(n_sm), ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"latency_decode: {lib.rlmg_error_string(rc).decode()}")
    return n_sm.value, smem.value


def latency_decode_plain(rp: ResidentParams, tok0, s, z, t0: int, seed: int, *,
                         n_head: int, max_tokens: int, temps, topps,
                         greedy: bool = False, eps: float = DEFAULT_EPS):
    """The plain twin of v8 and v7: JAX v8's arithmetic in PyTorch, token
    by token.  ``fused_decode_v6_plain`` (each product's input activations
    rounded to the weights' dtype, f32 sums) on the folded embedding rows
    rounded to the weights' dtype, as JAX ``make_resident_params`` stores
    ``memb`` (:137).  With f32 weights both roundings are no-ops."""
    m = rp.m.to(rp.head_w.dtype).float()
    return fused_decode_v6_plain(rp._replace(m=m), tok0, s, z, t0, seed, n_head=n_head,
                                 max_tokens=max_tokens, temps=temps, topps=topps,
                                 greedy=greedy, eps=eps)


def barriers_per_token(n_layer: int) -> int:
    """Grid-wide barriers a token of v8 and v7 passes by design (v7's
    launch boundaries included): 4 a layer, then the heads and the
    sampling."""
    return _lib().rlmg_latency_barriers_per_token(n_layer)


def barriers_passed(reset: bool = False) -> int:
    """Grid-wide barriers the v8 and v7 kernels passed on the current card
    since the last reset, as the kernels count them (each grid.sync and
    each launch's start); waits for the card.  ``reset`` zeroes the count
    after reading it."""
    n = _lib().rlmg_latency_barriers_passed(int(reset))
    if n < 0:
        raise RuntimeError(f"latency_decode: {_lib().rlmg_error_string(-n).decode()}")
    return n


def check_tok0(rp: ResidentParams, tok0: torch.Tensor, t0: int, max_tokens: int,
               nf: int) -> None:
    if tok0.dim() != 2 or tok0.shape[1] != nf or tok0.dtype != torch.int32:
        raise ValueError(f"tok0: expected int32 (B, {nf}), got {tok0.dtype} "
                         f"{tuple(tok0.shape)}")
    if t0 < 0 or t0 + max_tokens > rp.pe.shape[0]:
        raise ValueError(f"positions {t0}..{t0 + max_tokens - 1} outside the pe table "
                         f"({rp.pe.shape[0]} rows)")


def run_kernel(version: int, rp: ResidentParams, tok0: torch.Tensor, s: torch.Tensor,
               z: torch.Tensor, t0: int, seed: int, *, n_head: int, max_tokens: int,
               vocab_sizes: Sequence[int], temps: Sequence[float], topps: Sequence[float],
               greedy: bool, eps: float) -> Tuple[torch.Tensor, Tuple[int, int, int]]:
    """One call of ``csrc/latency_decode.cu`` (``version`` 7 or 8) on CUDA
    tensors; s, z are updated in place.  Returns (tokens (T, B, NF) int32,
    (CUDA kernels launched, ring slots a block, v7's graph: 0 launched as it
    was, 1 updated, 2 instantiated))."""
    nf = len(vocab_sizes)
    name = f"fused_decode_v{version}"
    _cuda_or_raise(tok0, name)
    b = tok0.shape[0]
    d = rp.fls.shape[0]
    ws = layer_weights(rp.layers)
    h_like = torch.empty((b, d), dtype=torch.float32, device=tok0.device)
    L, b, d, H, di = _check_inputs(ws, h_like, s, z, n_head)
    _check_v6(rp, h_like, nf)
    if b > MAX_BATCH:
        raise ValueError(f"{name}: batch {b} is beyond the kernel's design (at most "
                         f"{MAX_BATCH} songs); the chunked path (decode_kernel_v6) or the "
                         "per-step path serves larger batches")
    if d % TILE or di % TILE or d > MAX_D:
        raise ValueError(f"{name}: d_model {d} and d_inner {di} must be multiples of {TILE}, "
                         f"d_model at most {MAX_D}")
    tinv, topp, off = _field_arrays(nf, temps, topps, rp.field_off)
    lib = _lib()
    s_bf16 = int(s.dtype == torch.bfloat16)
    with torch.cuda.device(tok0.device):
        n_sm, max_smem = card_limits()
        need = lib.rlmg_latency_smem_bytes(version, L, b, d, H, s_bf16, n_sm, max_smem)
        if need > max_smem:
            raise ValueError(
                f"{name}: the resident {str(s.dtype)[6:]} state at B={b} needs {need} bytes "
                f"of shared memory in each of the {n_sm} blocks (two 8 KB weight slots "
                f"included), above the card's {max_smem}-byte limit a block; use a bfloat16 "
                "state (RLMG_DECODE_STATE_DTYPE) or fewer songs")
        tok0 = tok0.contiguous()
        tokens = torch.empty((max_tokens, b, nf), dtype=torch.int32, device=tok0.device)
        scratch = torch.empty(lib.rlmg_latency_scratch_floats(b, d, H, di),
                              dtype=torch.float32, device=tok0.device)
        ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
        info = (ctypes.c_int * 3)()
        rc = lib.rlmg_latency_decode(
            version, tok0.data_ptr(), tokens.data_ptr(), rp.m.data_ptr(), rp.b_in.data_ptr(),
            rp.pe.data_ptr(), ptrs, rp.head_w.data_ptr(), rp.head_b.data_ptr(),
            rp.fls.data_ptr(), rp.flb.data_ptr(), off, tinv, topp, s.data_ptr(),
            z.data_ptr(), scratch.data_ptr(), max_tokens, t0, seed & 0xFFFFFFFF, int(greedy),
            L, b, d, H, di, nf, eps, int(ws[0].dtype == torch.bfloat16), s_bf16,
            torch.cuda.current_stream().cuda_stream, info)
    if rc:
        raise RuntimeError(f"latency_decode kernel (v{version}): "
                           f"{lib.rlmg_error_string(rc).decode()}")
    return tokens, (info[0], info[1], info[2])


def count(wrapper, info: Tuple[int, int, int], max_tokens: int) -> None:
    """A wrapper's counters after a kernel call: ``launches`` its calls,
    ``cuda_launches`` the CUDA kernels they launched, ``positions`` the
    token positions they decoded (one token of each of the B songs),
    ``slots`` the weight-ring slots a block had in the last call, and
    (v7) ``captures`` / ``updates`` the calls that instantiated or updated
    the shape's token graph."""
    wrapper.launches += 1
    wrapper.cuda_launches += info[0]
    wrapper.positions += max_tokens
    wrapper.slots = info[1]
    wrapper.updates += info[2] == 1
    wrapper.captures += info[2] == 2


def reset(wrapper) -> None:
    wrapper.launches = wrapper.cuda_launches = wrapper.positions = wrapper.slots = 0
    wrapper.captures = wrapper.updates = 0


def fused_decode_v8(rp: ResidentParams, tok0: torch.Tensor, s: torch.Tensor,
                    z: torch.Tensor, t0: int, seed: int, *, n_head: int, max_tokens: int,
                    vocab_sizes: Sequence[int], temps: Sequence[float],
                    topps: Sequence[float], greedy: bool = False,
                    eps: float = DEFAULT_EPS):
    """Decode ``max_tokens`` tokens in one launch (the JAX contract
    :322-330): tok0 (B, NF) int32 is the next token TO BE FED, at position
    t0; s/z is the state before it and is UPDATED IN PLACE.  Returns
    (tokens (T, B, NF) int32, s, z), the last token emitted but not fed
    (the next call's tok0).  ``topps``: inf keeps every token.

    CUDA tensors go to the kernel (``launches`` counts the calls, one
    launch each; see ``count``); CPU tensors to the plain twin
    ``latency_decode_plain``; any other device raises."""
    nf = len(vocab_sizes)
    check_tok0(rp, tok0, t0, max_tokens, nf)
    if tok0.device.type == "cpu":
        return latency_decode_plain(rp, tok0, s, z, t0, seed, n_head=n_head,
                                    max_tokens=max_tokens, temps=temps, topps=topps,
                                    greedy=greedy, eps=eps)
    tokens, info = run_kernel(8, rp, tok0, s, z, t0, seed, n_head=n_head,
                              max_tokens=max_tokens, vocab_sizes=vocab_sizes, temps=temps,
                              topps=topps, greedy=greedy, eps=eps)
    count(fused_decode_v8, info, max_tokens)
    return tokens, s, z


reset(fused_decode_v8)
