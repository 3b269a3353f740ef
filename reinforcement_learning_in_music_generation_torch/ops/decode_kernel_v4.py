"""One decode token through every layer: the counterpart of the JAX
package's ``ops/decode_kernel_v4.py`` (``fused_stack_step_v4``, its Pallas
body ``_pair_kernel``).

Kernel: ``csrc/decode_step.cu`` (layer kernels in ``csrc/decode_layers.cuh``),
hand-written CUDA for ``sm_90a``, built at first use (``_build.py``) and
called through ctypes.  Per layer it computes qkv with phi on q and k, the
state update S += phi(k) v^T, z += phi(k) and the read num / (phi(q).z +
eps), Wo, LN1, the exact-erf gelu FFN and LN2; every product is a tiled
GEMM in the kernel, none goes to cuBLAS.  The TPU kernel packed two heads
per program to fill 128-lane rows; that packing is dropped and the state
keeps the ``DecodeState`` layout s (L,B,H,E,E), z (L,B,H,E).

Bound on the H100 (details in the source): per token the weights are read
once (151 MB in f32 at the flagship width) and the state read and written
once, so small batches are bytes-bound; at B=128 with f32 weights the f32
FMAs bind.

``fused_stack_step`` launches the kernel for CUDA tensors and runs
``fused_stack_step_plain``, the same arithmetic in PyTorch, for CPU
tensors.  Both update s and z in place.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from ..models import common as cm
from ..models.linear_transformer import DecodeState, embed_input, init_decode_state
from . import _build
from .decode_common import decode_state_dtype, gelu_exact, ln, phi
from .linear_attention import DEFAULT_EPS

# Order of the weight pointers the kernel takes (decode_layers.cuh W_QKV..LN2_B),
# as key paths into make_decode_params' dict.
LAYER_KEYS = (("qkv_w",), ("qkv_b",), ("wo", "w"), ("wo", "b"),
              ("ln1", "scale"), ("ln1", "bias"), ("ffn1", "w"), ("ffn1", "b"),
              ("ffn2", "w"), ("ffn2", "b"), ("ln2", "scale"), ("ln2", "bias"))

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def layer_weights(dparams: dict) -> List[torch.Tensor]:
    """The stacked (L, ...) layer tensors of ``make_decode_params``, in
    kernel order."""
    out = []
    for path in LAYER_KEYS:
        t = dparams
        for k in path:
            t = t[k]
        out.append(t)
    return out


def _check_inputs(ws: List[torch.Tensor], h0, s, z, n_head: int) -> Tuple[int, ...]:
    """Device, dtype, shape and contiguity checks; returns (L, B, D, H, DI)."""
    b, d = h0.shape
    L, di = ws[6].shape[0], ws[6].shape[-1]
    e = d // n_head
    expect = [(L, d, 3 * d), (L, 3 * d), (L, d, d), (L, d), (L, d), (L, d),
              (L, d, di), (L, di), (L, di, d), (L, d), (L, d), (L, d)]
    for (path, t, shp) in zip(LAYER_KEYS, ws, expect):
        if tuple(t.shape) != shp:
            raise ValueError(f"{'/'.join(path)}: shape {tuple(t.shape)}, expected {shp}")
        if t.dtype != ws[0].dtype or t.device != h0.device or not t.is_contiguous():
            raise ValueError(f"{'/'.join(path)}: every layer weight must be one dtype, "
                             f"contiguous, on {h0.device}")
    if ws[0].dtype not in _KERNEL_DTYPES:
        raise TypeError(f"weights: {ws[0].dtype} (kernel takes float32 or bfloat16)")
    if h0.dtype != torch.float32 or not h0.is_contiguous():
        raise TypeError("h0: expected a contiguous float32 (B, D) tensor")
    if tuple(s.shape) != (L, b, n_head, e, e) or tuple(z.shape) != (L, b, n_head, e):
        raise ValueError(f"state: s {tuple(s.shape)}, z {tuple(z.shape)}; expected "
                         f"({L}, {b}, {n_head}, {e}, {e}) and ({L}, {b}, {n_head}, {e})")
    if s.dtype != z.dtype or s.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"state: s {s.dtype}, z {z.dtype} (one of float32, bfloat16)")
    for name, t in (("s", s), ("z", z)):
        if t.device != h0.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous and on {h0.device}")
    if e * n_head != d or e > 128 or 256 % e or d > 2048:
        raise ValueError(f"d_model {d} / n_head {n_head}: kernel needs a head width "
                         "dividing 256 (at most 128) and d_model <= 2048")
    return L, b, d, n_head, di


_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_step")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmg_stack_scratch_floats.argtypes = [i, i, i]
        lib.rlmg_stack_scratch_floats.restype = ctypes.c_longlong
        lib.rlmg_decode_stack_step.argtypes = [p, p, p, p, p, i, i, i, i, i, f, i, i, p]
        lib.rlmg_decode_stack_step.restype = i
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def fused_stack_step(dparams: dict, h0: torch.Tensor, s: torch.Tensor,
                     z: torch.Tensor, *, n_head: int, eps: float = DEFAULT_EPS
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """All layers, one token.  h0 (B, D) float32; s (L,B,H,E,E), z (L,B,H,E)
    in float32 or bfloat16, UPDATED IN PLACE.  Returns (h_out f32, s, z).

    CUDA tensors go to the kernel (``launches`` counts the calls); CPU
    tensors to ``fused_stack_step_plain``."""
    if h0.device.type == "cpu":
        return fused_stack_step_plain(dparams, h0, s, z, n_head=n_head, eps=eps)
    if h0.device.type != "cuda":
        raise ValueError(f"fused_stack_step: no kernel for device {h0.device}")
    ws = layer_weights(dparams)
    L, b, d, H, di = _check_inputs(ws, h0, s, z, n_head)
    lib = _lib()
    with torch.cuda.device(h0.device):
        h = h0.clone()                       # the kernel overwrites its input
        scratch = torch.empty(lib.rlmg_stack_scratch_floats(b, d, di),
                              dtype=torch.float32, device=h0.device)
        ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
        rc = lib.rlmg_decode_stack_step(
            h.data_ptr(), ptrs, s.data_ptr(), z.data_ptr(), scratch.data_ptr(),
            L, b, d, H, di, eps, int(ws[0].dtype == torch.bfloat16),
            int(s.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"decode_step kernel: {lib.rlmg_error_string(rc).decode()}")
    fused_stack_step.launches += 1
    return h, s, z


fused_stack_step.launches = 0


def fused_stack_step_plain(dparams: dict, h0: torch.Tensor, s: torch.Tensor,
                           z: torch.Tensor, *, n_head: int,
                           eps: float = DEFAULT_EPS, round_to: Optional[torch.dtype] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch: f32 activations, weights read in
    their stored dtype, the state accumulated in f32 and rounded only when
    stored (in place); the read uses the unrounded f32 sums.  ``round_to``:
    round each product's input activations to this dtype first (JAX v6's
    ``.astype(w.dtype)``; a no-op for float32), the sums stay f32."""
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
        h1 = ln(h + (r(att) @ wo_w[l] + wo_b[l]), l1s[l], l1b[l])
        y = gelu_exact(r(h1) @ f1w[l] + f1b[l])
        h = ln(h1 + (r(y) @ f2w[l] + f2b[l]), l2s[l], l2b[l])
    return h, s, z


def init_state(cfg, batch: int, dtype: Optional[torch.dtype] = None,
               device="cuda") -> DecodeState:
    """Zero decode state in the storage dtype of the fused paths
    (``decode_state_dtype()``, bfloat16 unless RLMG_DECODE_STATE_DTYPE)."""
    return init_decode_state(cfg, batch, dtype or decode_state_dtype(), device)


def decode_step_v4(params: dict, dparams: dict, cfg, token: torch.Tensor,
                   state: DecodeState, *, pe_table: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """``lt.decode_step`` with the layer stack in the kernel: the embedding,
    in_linear, pe add and final LN stay plain, as in the JAX function."""
    h = embed_input(params, cfg, token, state.step, pe_table)
    h_out, s, z = fused_stack_step(dparams, h.float(), state.s, state.z,
                                   n_head=cfg.n_head, eps=cfg.attn_eps)
    h_out = cm.layernorm(params["final_ln"], h_out.to(h.dtype))
    return h_out, DecodeState(s, z, state.step + 1)
