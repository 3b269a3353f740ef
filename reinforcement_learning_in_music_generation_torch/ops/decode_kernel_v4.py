"""One decode token through every layer: the counterpart of the JAX
package's ``ops/decode_kernel_v4.py`` (``fused_stack_step_v4``, its Pallas
body ``_pair_kernel``).

Kernel: ``csrc/decode_step.cu`` (the token kernel in
``csrc/decode_stack_tc.cuh``, shared with v3), hand-written CUDA for
``sm_90a``, built at first use (``_build.py``) and called through ctypes.
One cooperative launch a token runs every layer: qkv with phi on q and k,
the state update S += phi(k) v^T, z += phi(k) and the read num / (phi(q).z
+ eps), Wo, LN1 of (h + att Wo) + bo, the exact-erf gelu FFN and LN2, with
four grid barriers a layer.  Every product runs on the tensor cores at f32
grade: the f32 activations split into three bf16 planes, times the bf16
weights (three products) or the f32 weights split the same way (six), each
depth of 16 summed afresh in f32.  The TPU kernel packed two heads per
program to fill 128-lane rows; that packing is dropped and the state keeps
the ``DecodeState`` layout s (L,B,H,E,E), z (L,B,H,E).

Bound on the H100 (details in the source): per token the weights are read
once (75.5 MB in bf16, 151 MB in f32 at the flagship width) and the state
read and written once, so the per-step path's batches are bytes-bound.

``fused_stack_step`` launches the kernel for CUDA tensors and runs
``fused_stack_step_plain``, the same arithmetic in PyTorch, for CPU
tensors.  Both update s and z in place.  The kernel reads its weights
packed into the mma fragment order (``pack_fragments``) from a
``StackWorkspace``, which also holds the output and scratch buffers.  A
caller that steps many tokens with one weights object and batch builds it
once (``workspace``) and passes it to every call: a call then allocates
nothing and syncs nothing, so it can be captured in a CUDA graph.  The
kernel counts its own runs (``kernel_runs``), a graph's replays included.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..models import common as cm
from ..models.linear_transformer import DecodeState, embed_input, init_decode_state
from . import _build
from .decode_common import decode_state_dtype, gelu_exact, ln, phi
from .linear_attention import DEFAULT_EPS

# Order of the layer tensors (the JAX kernel's operands), as key paths into
# make_decode_params' dict: qkv weight and bias, Wo and its bias, LN1,
# FFN1, FFN2, LN2.
LAYER_KEYS = (("qkv_w",), ("qkv_b",), ("wo", "w"), ("wo", "b"),
              ("ln1", "scale"), ("ln1", "bias"), ("ffn1", "w"), ("ffn1", "b"),
              ("ffn2", "w"), ("ffn2", "b"), ("ln2", "scale"), ("ln2", "bias"))
# LAYER_KEYS indices of the four matrices and of the eight vectors, in the
# kernel's order (csrc/decode_stack_tc.cuh StackTcArgs w and v)
MATRICES = (0, 2, 6, 8)
VECTORS = (1, 3, 4, 5, 7, 9, 10, 11)

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def layer_weights(dparams: dict) -> List[torch.Tensor]:
    """The stacked (L, ...) layer tensors of ``make_decode_params``, in
    LAYER_KEYS order."""
    out = []
    for path in LAYER_KEYS:
        t = dparams
        for k in path:
            t = t[k]
        out.append(t)
    return out


def _check_weights(ws: List[torch.Tensor]) -> Tuple[int, int, int]:
    """The layer tensors' shapes, dtype, device and contiguity; returns (L,
    D, DI)."""
    L, d = ws[0].shape[:2]
    di = ws[6].shape[-1]
    expect = [(L, d, 3 * d), (L, 3 * d), (L, d, d), (L, d), (L, d), (L, d),
              (L, d, di), (L, di), (L, di, d), (L, d), (L, d), (L, d)]
    for (path, t, shp) in zip(LAYER_KEYS, ws, expect):
        if tuple(t.shape) != shp:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, expected {shp}")
        if t.dtype != ws[0].dtype or t.device != ws[0].device or not t.is_contiguous():
            raise ValueError(f"{'/'.join(path)}: every layer weight must be one dtype, "
                             f"contiguous, on {ws[0].device}")
    if ws[0].dtype not in _KERNEL_DTYPES:
        raise TypeError(f"weights: {ws[0].dtype} (kernel takes float32 or bfloat16)")
    return L, d, di


def _check_state(h0, s, z, n_head: int, L: int) -> None:
    """h0 a contiguous float32 (B, D) tensor; s (L,B,H,E,E) and z (L,B,H,E)
    of one kernel dtype, contiguous, on h0's device."""
    if h0.dtype != torch.float32 or h0.dim() != 2 or not h0.is_contiguous():
        raise TypeError("h0: expected a contiguous float32 (B, D) tensor")
    b, d = h0.shape
    e = d // n_head
    if tuple(s.shape) != (L, b, n_head, e, e) or tuple(z.shape) != (L, b, n_head, e):
        raise ValueError(f"state: s {tuple(s.shape)}, z {tuple(z.shape)}; expected "
                         f"({L}, {b}, {n_head}, {e}, {e}) and ({L}, {b}, {n_head}, {e})")
    if s.dtype != z.dtype or s.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"state: s {s.dtype}, z {z.dtype} (one of float32, bfloat16)")
    for name, t in (("s", s), ("z", z)):
        if t.device != h0.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous and on {h0.device}")


def _check_inputs(ws: List[torch.Tensor], h0, s, z, n_head: int) -> Tuple[int, ...]:
    """Device, dtype, shape and contiguity checks of the layer-stack kernels
    that share the ``DecodeState`` layout (B, v5, v8, v7); returns (L, B, D,
    H, DI)."""
    L, d, di = _check_weights(ws)
    if ws[0].device != h0.device:
        raise ValueError(f"weights on {ws[0].device}, h0 on {h0.device}")
    _check_state(h0, s, z, n_head, L)
    b, e = h0.shape[0], d // n_head
    if h0.shape[1] != d or e * n_head != d or e > 128 or 256 % e or d > 2048:
        raise ValueError(f"d_model {d} / n_head {n_head}: kernel needs a head width "
                         "dividing 256 (at most 128) and d_model <= 2048")
    return L, b, d, n_head, di


def check_shape(shape_ok, d: int, n_head: int, di: int, name: str) -> None:
    """Raises unless the token kernel takes (d_model, n_head, d_inner), as
    ``shape_ok``, its library's check (csrc/decode_stack_tc.cuh
    ``stack_tc_shape_ok``), says."""
    if not shape_ok(d, n_head, di):
        raise ValueError(f"{name}: d_model {d} / n_head {n_head} / d_inner {di}: the kernel "
                         "needs n_head dividing d_model, d_model and d_inner multiples of 8, "
                         "d_model <= 1024 and 16 rows of d_inner in a block's shared memory")


def _check_call(work: "StackWorkspace", h0, s, z, n_head: int) -> None:
    """h0 and the state against the workspace: device, dtype, shape,
    contiguity, alignment."""
    b, d, dev = work.b, work.d, work.h_out.device
    if tuple(h0.shape) != (b, d) or h0.device != dev or h0.data_ptr() % 16:
        raise TypeError(f"h0: expected a 16-byte aligned ({b}, {d}) tensor on {dev} (the "
                        "workspace's batch and width)")
    _check_state(h0, s, z, n_head, work.L)
    check_shape(_lib().rlmg_stack_tc_shape_ok, d, n_head, work.di, "fused_stack_step")


def pack_fragments(w: torch.Tensor) -> torch.Tensor:
    """Stacked (L, K, N) weights in the token kernel's mma fragment order:
    K padded with zeros to a multiple of 32, then (L, N/8, K/32, 32 lanes, 8
    values).  Lane l = 4 g + t of the 8-column tile j and the 32 depths c
    holds, for depth steps s = 0, 1 (k0 = 32 c + 16 s, n = 8 j + g), W[k0 +
    2t], W[k0 + 2t + 1], W[k0 + 2t + 8], W[k0 + 2t + 9] at column n: the B
    fragments of two mma.m16n8k16 products."""
    L, K, N = w.shape
    if N % 8:
        raise ValueError(f"pack_fragments: {N} columns, not a multiple of 8")
    kp = (K + 31) // 32 * 32
    if kp != K:
        w = torch.nn.functional.pad(w, (0, 0, 0, kp - K))
    return (w.reshape(L, kp // 32, 2, 2, 4, 2, N // 8, 8)
            .permute(0, 6, 1, 7, 4, 2, 3, 5).reshape(L, N // 8, kp // 32, 32, 8))


class StackWorkspace(NamedTuple):
    """What the token kernel keeps across calls for one weights object and
    batch: the packed matrices and a copy of the vectors (none of the
    caller's tensors), the output h, the f32 scratch and the row tiles'
    counters, their pointers for the C call, and the shapes it serves."""
    mats: Tuple[torch.Tensor, ...]
    vecs: Tuple[torch.Tensor, ...]
    h_out: torch.Tensor
    scratch: torch.Tensor
    cnt: torch.Tensor
    wptr: ctypes.Array
    vptr: ctypes.Array
    L: int
    b: int
    d: int
    di: int


def stack_workspace(mats: Sequence[torch.Tensor], vecs: Sequence[torch.Tensor], b: int,
                    lib_prefix: str, lib: ctypes.CDLL) -> StackWorkspace:
    """The token kernel's workspace at batch b for the four (L, K, N)
    matrices (Wqkv, Wo, W1, W2; packed here) and the eight stacked vectors
    (copied), in the kernel's order.  ``lib``: the library that launches it,
    whose ``<lib_prefix>_shape_ok`` and ``<lib_prefix>_scratch_floats`` give
    the shapes it takes and the scratch it needs."""
    L, d, di = mats[2].shape
    check_shape(getattr(lib, f"{lib_prefix}_shape_ok"), d, 1, di, "workspace")
    dev = mats[0].device
    packed = tuple(pack_fragments(m) for m in mats)
    vecs = tuple(v.contiguous().clone() for v in vecs)
    h_out = torch.empty((b, d), dtype=torch.float32, device=dev)
    scratch = torch.empty(getattr(lib, f"{lib_prefix}_scratch_floats")(b, d, di),
                          dtype=torch.float32, device=dev)
    cnt = torch.zeros((b + 15) // 16, dtype=torch.int32, device=dev)
    return StackWorkspace(packed, vecs, h_out, scratch, cnt,
                          (ctypes.c_void_p * 4)(*[t.data_ptr() for t in packed]),
                          (ctypes.c_void_p * 8)(*[t.data_ptr() for t in vecs]), L, b, d, di)


def workspace(dparams: dict, b: int) -> StackWorkspace:
    """Kernel A's workspace for ``dparams`` (``make_decode_params``) at
    batch b, on their device: build it once and pass it to each
    ``fused_stack_step`` call with these weights and batch.  It holds its
    own copy of the weights, so it keeps none of dparams alive; an update of
    dparams needs a new workspace."""
    ws = layer_weights(dparams)
    _check_weights(ws)
    return stack_workspace([ws[i] for i in MATRICES], [ws[i] for i in VECTORS], b,
                           "rlmg_stack_tc", _lib())


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_step")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmg_stack_tc_step.argtypes = [p] * 8 + [i] * 5 + [f, i, i, p, ctypes.POINTER(i)]
        lib.rlmg_stack_tc_step.restype = i
        lib.rlmg_stack_tc_shape_ok.argtypes = [i] * 3
        lib.rlmg_stack_tc_shape_ok.restype = i
        lib.rlmg_stack_tc_scratch_floats.argtypes = [i] * 3
        lib.rlmg_stack_tc_scratch_floats.restype = ctypes.c_longlong
        lib.rlmg_stack_tc_runs.argtypes = [i]
        lib.rlmg_stack_tc_runs.restype = ctypes.c_longlong
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel_runs(reset: bool = False) -> int:
    """Runs of kernel A on the current card since the last reset, as the
    kernel counts them (a launch that ran to its end, eager or replayed from
    a CUDA graph); waits for the card.  ``reset`` zeroes the count after
    reading it."""
    n = _lib().rlmg_stack_tc_runs(int(reset))
    if n < 0:
        raise RuntimeError(f"decode_step: {_lib().rlmg_error_string(-n).decode()}")
    return n


def fused_stack_step(dparams: Optional[dict], h0: torch.Tensor, s: torch.Tensor,
                     z: torch.Tensor, *, n_head: int, eps: float = DEFAULT_EPS,
                     work: Optional[StackWorkspace] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All layers, one token.  h0 (B, D) float32; s (L,B,H,E,E), z (L,B,H,E)
    in float32 or bfloat16, UPDATED IN PLACE.  Returns (h_out f32, s, z).

    CUDA tensors go to the kernel, with the weights of ``work`` (then
    dparams is not read and may be None; h_out is work's buffer, which the
    next call with it overwrites) or of a workspace built from dparams for
    this call.  ``launches`` counts the calls that launched, ``cuda_launches``
    the CUDA launches they issued; a call inside a CUDA graph capture records
    the launch and counts nothing (``kernel_runs`` counts the replays).  CPU
    tensors go to ``fused_stack_step_plain``."""
    if h0.device.type == "cpu":
        return fused_stack_step_plain(dparams, h0, s, z, n_head=n_head, eps=eps)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_stack_step: no kernel for device {h0.device}")
    if work is None:
        work = workspace(dparams, h0.shape[0])
    _check_call(work, h0, s, z, n_head)
    lib = _lib()
    with torch.cuda.device(h0.device):
        launched = ctypes.c_int()
        rc = lib.rlmg_stack_tc_step(
            work.wptr, work.vptr, s.data_ptr(), z.data_ptr(), h0.data_ptr(),
            work.h_out.data_ptr(), work.scratch.data_ptr(), work.cnt.data_ptr(),
            work.L, work.b, work.d, n_head, work.di, eps,
            int(work.mats[0].dtype == torch.bfloat16), int(s.dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    if rc:
        raise RuntimeError(f"decode_step kernel: {lib.rlmg_error_string(rc).decode()}")
    if not torch.cuda.is_current_stream_capturing():    # a capture records, launches nothing
        fused_stack_step.launches += 1
        fused_stack_step.cuda_launches += launched.value
    return work.h_out, s, z


fused_stack_step.launches = fused_stack_step.cuda_launches = 0


def ln1_input(h: torch.Tensor, ao: torch.Tensor, bo: torch.Tensor) -> torch.Tensor:
    """LN1's input as the JAX kernel sums it, ``hf + ao_scr[...] +
    wob_ref[0, 0]`` (JAX ``decode_kernel_v4.py`` :101): (h + att Wo) + bo."""
    return (h + ao) + bo


def fused_stack_step_plain(dparams: dict, h0: torch.Tensor, s: torch.Tensor,
                           z: torch.Tensor, *, n_head: int,
                           eps: float = DEFAULT_EPS, round_to: Optional[torch.dtype] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch: f32 activations, weights read in
    their stored dtype, the state accumulated in f32 and rounded only when
    stored (in place); the read uses the unrounded f32 sums; LN1 of (h + att
    Wo) + bo (``ln1_input``).  ``round_to``: round each product's input
    activations to this dtype first (JAX v6's ``.astype(w.dtype)``; a no-op
    for float32), the sums stay f32."""
    ws = [t.float() for t in layer_weights(dparams)]
    r = (lambda x: x) if round_to is None else (lambda x: x.to(round_to).float())
    qkv_w, qkv_b, wo_w, wo_b, l1s, l1b, f1w, f1b, f2w, f2b, l2s, l2b = ws
    h = h0.float()
    b, d = h.shape
    e = d // n_head
    for l in range(s.shape[0]):
        qkv = r(h) @ qkv_w[l] + qkv_b[l]
        q = phi(qkv[:, :d]).reshape(b, n_head, e)
        k = phi(qkv[:, d:2 * d]).reshape(b, n_head, e)
        v = qkv[:, 2 * d:].reshape(b, n_head, e)
        s_new = s[l].float() + k[..., :, None] * v[..., None, :]
        z_new = z[l].float() + k
        s[l].copy_(s_new)
        z[l].copy_(z_new)
        num = torch.einsum("bhe,bhef->bhf", q, s_new)
        den = (q * z_new).sum(-1) + eps
        att = (num / den[..., None]).reshape(b, d)
        h1 = ln(ln1_input(h, r(att) @ wo_w[l], wo_b[l]), l1s[l], l1b[l])
        y = gelu_exact(r(h1) @ f1w[l] + f1b[l])
        h = ln(h1 + (r(y) @ f2w[l] + f2b[l]), l2s[l], l2b[l])
    return h, s, z


def init_state(cfg, batch: int, dtype: Optional[torch.dtype] = None,
               device="cuda") -> DecodeState:
    """Zero decode state in the storage dtype of the fused paths
    (``decode_state_dtype()``, bfloat16 unless RLMG_DECODE_STATE_DTYPE)."""
    return init_decode_state(cfg, batch, dtype or decode_state_dtype(), device)


def decode_step_v4(params: dict, dparams: dict, cfg, token: torch.Tensor,
                   state: DecodeState, *, pe_table: Optional[torch.Tensor] = None,
                   work: Optional[StackWorkspace] = None
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """``lt.decode_step`` with the layer stack in the kernel: the embedding,
    in_linear, pe add and final LN stay plain, as in the JAX function.
    ``work``: dparams' workspace at this batch (``workspace``), for a caller
    that steps many tokens."""
    h = embed_input(params, cfg, token, state.step, pe_table)
    h_out, s, z = fused_stack_step(dparams, h.float(), state.s, state.z,
                                   n_head=cfg.n_head, eps=cfg.attn_eps, work=work)
    h_out = cm.layernorm(params["final_ln"], h_out.to(h.dtype))
    return h_out, DecodeState(s, z, state.step + 1)
