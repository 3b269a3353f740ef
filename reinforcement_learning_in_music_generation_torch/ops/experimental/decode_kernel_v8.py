"""Latency-mode decode, one launch per chunk: the counterpart of the JAX
package's ``ops/experimental/decode_kernel_v8.py`` (``fused_decode_v8``,
its Pallas body ``_v8_kernel``).

Kernel: ``csrc/latency_decode.cu``, hand-written CUDA for ``sm_90a``.  One
persistent cooperative launch decodes the whole chunk: one block per SM,
the phases of each token (embedding, per layer the qkv product, the state
update and Wo product per (song, head), LN1, the two FFN products, LN2,
then the heads + sample pass) separated by grid-wide barriers.  Each block
keeps its (layer, song, head) slices of the state in shared memory for the
whole chunk, the counterpart of v8's VMEM-resident state; the weights
stream from device memory every token (75.5 MB in bf16 do not fit the
card's 50 MB L2).  The TPU kernel's head-pair packing and its batch padding
to 8 rows are TPU layout details and are not ported: the state keeps the
``DecodeState`` layout, s (L,B,H,E,E) and z (L,B,H,E), as kernels A and B
do.

Plain twin: ``decode_kernel_v6.chunk_decode_v4_plain``.  The kernel
computes kernel B's function with kernel B's sampling (the same Philox
counter: position, field, vocab index, song) in v4's arithmetic (f32
activations, the weights cast up), so kernel B's plain chunk in that
arithmetic is this kernel's plain version too, and ``decode_kernel_v7``
shares it.  (JAX's v8 casts the activations to bf16 before each product,
as v6 does; moving onto v6's arithmetic is this kernel's redesign.)

The wrapper refuses (``ValueError``) a batch above ``MAX_BATCH`` and one
whose resident state does not fit the card's shared memory (an f32 state
at large B), as the JAX wrapper refuses one beyond its VMEM budget
(``decode_kernel_v8.py:346``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from .. import _build
from ..decode_kernel_v4 import _check_inputs, layer_weights
from ..decode_kernel_v6 import (V6Params, _check_v6, _cuda_or_raise, _field_arrays,
                                chunk_decode_v4_plain, make_v6_params)
from ..linear_attention import DEFAULT_EPS

MAX_BATCH = 16          # csrc/latency_decode.cu LT_MAX_B
TILE = 64               # product items are 64 x 64 tiles: d_model, d_inner multiples of it

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
        lib.rlmg_latency_smem_bytes.argtypes = [i] * 7
        lib.rlmg_latency_smem_bytes.restype = ll
        lib.rlmg_latency_card.argtypes = [ctypes.POINTER(i), ctypes.POINTER(i)]
        lib.rlmg_latency_card.restype = i
        lib.rlmg_latency_decode.argtypes = ([i] + [p] * 16 + [i, i, u, i, i, i, i, i, i, i, f,
                                                             i, i, p, ctypes.POINTER(i)])
        lib.rlmg_latency_decode.restype = i
        lib.rlmg_decode_v5.argtypes = [p] * 16 + [i, u] + [i] * 8 + [f, i, i, p]
        lib.rlmg_decode_v5.restype = i
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
               greedy: bool, eps: float) -> Tuple[torch.Tensor, int]:
    """One call of ``csrc/latency_decode.cu`` (``version`` 7 or 8) on CUDA
    tensors; s, z are updated in place.  Returns (tokens (T, B, NF) int32,
    the number of CUDA launches the call issued)."""
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
    if d % TILE or di % TILE:
        raise ValueError(f"{name}: d_model {d} and d_inner {di} must be multiples of {TILE}")
    tinv, topp, off = _field_arrays(nf, temps, topps, rp.field_off)
    lib = _lib()
    s_bf16 = int(s.dtype == torch.bfloat16)
    with torch.cuda.device(tok0.device):
        n_sm, max_smem = card_limits()
        need = lib.rlmg_latency_smem_bytes(version, L, b, d, H, s_bf16, n_sm)
        if need > max_smem:
            raise ValueError(
                f"{name}: the resident {str(s.dtype)[6:]} state at B={b} needs {need} bytes "
                f"of shared memory in each of the {n_sm} blocks, above the card's "
                f"{max_smem}-byte limit a block; use a bfloat16 state "
                "(RLMG_DECODE_STATE_DTYPE) or fewer songs")
        tok0 = tok0.contiguous()
        tokens = torch.empty((max_tokens, b, nf), dtype=torch.int32, device=tok0.device)
        scratch = torch.empty(lib.rlmg_latency_scratch_floats(b, d, H, di),
                              dtype=torch.float32, device=tok0.device)
        ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
        launched = ctypes.c_int()
        rc = lib.rlmg_latency_decode(
            version, tok0.data_ptr(), tokens.data_ptr(), rp.m.data_ptr(), rp.b_in.data_ptr(),
            rp.pe.data_ptr(), ptrs, rp.head_w.data_ptr(), rp.head_b.data_ptr(),
            rp.fls.data_ptr(), rp.flb.data_ptr(), off, tinv, topp, s.data_ptr(),
            z.data_ptr(), scratch.data_ptr(), max_tokens, t0, seed & 0xFFFFFFFF, int(greedy),
            L, b, d, H, di, nf, eps, int(ws[0].dtype == torch.bfloat16), s_bf16,
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    if rc:
        raise RuntimeError(f"latency_decode kernel (v{version}): "
                           f"{lib.rlmg_error_string(rc).decode()}")
    return tokens, launched.value


def count(wrapper, cuda_launches: int, max_tokens: int) -> None:
    """A wrapper's counters after a kernel call: ``launches`` its calls,
    ``cuda_launches`` the CUDA launches they issued, ``positions`` the
    token positions they decoded (one token of each of the B songs)."""
    wrapper.launches += 1
    wrapper.cuda_launches += cuda_launches
    wrapper.positions += max_tokens


def reset(wrapper) -> None:
    wrapper.launches = wrapper.cuda_launches = wrapper.positions = 0


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
    ``chunk_decode_v4_plain``; any other device raises."""
    nf = len(vocab_sizes)
    check_tok0(rp, tok0, t0, max_tokens, nf)
    if tok0.device.type == "cpu":
        return chunk_decode_v4_plain(rp, tok0, s, z, t0, seed, n_head=n_head,
                                     max_tokens=max_tokens, temps=temps, topps=topps,
                                     greedy=greedy, eps=eps)
    tokens, n = run_kernel(8, rp, tok0, s, z, t0, seed, n_head=n_head, max_tokens=max_tokens,
                           vocab_sizes=vocab_sizes, temps=temps, topps=topps, greedy=greedy,
                           eps=eps)
    count(fused_decode_v8, n, max_tokens)
    return tokens, s, z


reset(fused_decode_v8)
