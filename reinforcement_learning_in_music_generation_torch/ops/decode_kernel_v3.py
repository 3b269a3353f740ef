"""One decode token through every layer on the augmented state: the
counterpart of the JAX package's ``ops/decode_kernel_v3.py``
(``fused_stack_step``, its Pallas body ``_step_kernel``).

The augmented state keeps z as the last column of S: (L, H, B, E, E + 1)
f32, always f32 whatever ``RLMG_DECODE_STATE_DTYPE`` says (JAX
``init_aug_state``).  ``generate/sampler.py generate_tokens(fused=True)``
decodes through it when the head count is odd, as the JAX sampler does;
even head counts take the per-step kernel A (``decode_kernel_v4``).

Kernel: ``csrc/decode_aug.cu`` (``rlmg_v3_tc_step``), hand-written CUDA for
``sm_90a``: kernel A's token kernel (``csrc/decode_stack_tc.cuh``) on the
augmented state, one cooperative launch a token.  Per layer: the qkv
product over the head-major weight (its columns [q_h k_h v_h] head by head,
phi on q and k), the state items (a block per song, head and 64 state
columns: S += phi(k) [v, 1], att = num[:E] / (num[E] + eps); any head
width), the Wo product with LN1 of (h + att Wo) + bo, the exact-erf gelu
FFN and LN2; every product on the tensor cores at f32 grade (the f32
activations in three bf16 planes), four grid barriers a layer.  The TPU
kernel's grid over batch blocks (a VMEM budget) has no counterpart: every
song runs at once.  v2 (``ops/experimental/decode_kernel.py``) runs the same
token kernel for one layer with the tanh gelu; v1 keeps ``run_aug``'s
passes.

Bound on the H100: per token the weights are read once (75.5 MB in bf16 at
the flagship width) and the f32 state read and written once (1.6 MB a song
each way at 12 layers and 8 heads of 64): at B <= 128 in bf16 the bytes
bind.

``fused_stack_step`` launches the kernel for CUDA tensors and runs
``fused_stack_step_plain``, the same arithmetic in PyTorch, for CPU
tensors; any other device raises.  Both update the state in place.  As for
kernel A, a caller that steps many tokens builds the kernel's workspace
once (``workspace``) and passes it to every call; the kernel counts its own
runs (``kernel_runs``).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..models import common as cm
from ..models.linear_transformer import DecodeState, embed_input
from . import _build
from . import decode_kernel_v4 as dk4
from .decode_common import gelu_exact, ln, phi
from .linear_attention import DEFAULT_EPS

# The kernel's weight order (csrc/decode_layers.cuh W_QKV..LN2_B).
V3_KEYS = ("qkvw", "qkvb", "wow", "wob", "ln1s", "ln1b", "f1w", "f1b", "f2w", "f2b",
           "ln2s", "ln2b")
_MATRICES = (0, 2, 6, 8)            # indices of the weight matrices in that order
_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def make_v3_params(params: dict, cfg, dtype: torch.dtype = torch.bfloat16) -> dict:
    """The stacked layer weights in the kernel's head-major layout (JAX
    :133-170): qkvw (L, H, D, 3E), qkvb (L, H, 1, 3E) f32, wow (L, H, E, D),
    wob / ln / f*b (L, 1, ...) f32, f1w (L, D, DI), f2w (L, DI, D).  The
    matrices in ``dtype``."""
    lp = params["layers"]
    L, d, _ = lp["wq"]["w"].shape
    H = cfg.n_head
    e = d // H
    f32 = torch.float32

    def split_cols(w):   # (L, D, D) -> (L, H, D, E)
        return w.reshape(L, d, H, e).permute(0, 2, 1, 3)

    qkvw = torch.cat([split_cols(lp["wq"]["w"]), split_cols(lp["wk"]["w"]),
                      split_cols(lp["wv"]["w"])], dim=-1)
    qkvb = torch.cat([lp["wq"]["b"].reshape(L, H, e), lp["wk"]["b"].reshape(L, H, e),
                      lp["wv"]["b"].reshape(L, H, e)], dim=-1)

    def vec(t):
        return t.to(f32)[:, None, :].contiguous()

    return {
        "qkvw": qkvw.to(dtype).contiguous(),
        "qkvb": qkvb[:, :, None, :].to(f32).contiguous(),
        "wow": lp["wo"]["w"].reshape(L, H, e, d).to(dtype).contiguous(),
        "wob": vec(lp["wo"]["b"]),
        "ln1s": vec(lp["ln1"]["scale"]), "ln1b": vec(lp["ln1"]["bias"]),
        "ln2s": vec(lp["ln2"]["scale"]), "ln2b": vec(lp["ln2"]["bias"]),
        "f1w": lp["ffn1"]["w"].to(dtype).contiguous(), "f1b": vec(lp["ffn1"]["b"]),
        "f2w": lp["ffn2"]["w"].to(dtype).contiguous(), "f2b": vec(lp["ffn2"]["b"]),
    }


def init_aug_state(cfg, batch: int, device="cuda") -> torch.Tensor:
    """Zero (L, H, B, E, E + 1) f32 augmented state (JAX :273)."""
    e = cfg.d_head
    return torch.zeros((cfg.n_layer, cfg.n_head, batch, e, e + 1), dtype=torch.float32,
                       device=device)


# -- the kernel (shared with ops/experimental/decode_kernel.py) ---------------

_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load("decode_aug")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rlmg_aug_scratch_floats.argtypes = [i] * 3
        lib.rlmg_aug_scratch_floats.restype = ctypes.c_longlong
        lib.rlmg_decode_aug.argtypes = [p] * 5 + [i] * 5 + [f, i, p, ctypes.POINTER(i)]
        lib.rlmg_decode_aug.restype = i
        lib.rlmg_v2_pack.argtypes = [p, i, p, p, p] + [i] * 5 + [p]
        lib.rlmg_v2_pack.restype = i
        lib.rlmg_v2_tc_step.argtypes = [p] * 7 + [i] * 4 + [f, i, p, ctypes.POINTER(i)]
        lib.rlmg_v2_tc_step.restype = i
        lib.rlmg_v2_tc_runs.argtypes = [i]
        lib.rlmg_v2_tc_runs.restype = ctypes.c_longlong
        lib.rlmg_v3_tc_step.argtypes = [p] * 7 + [i] * 5 + [f, i, p, ctypes.POINTER(i)]
        lib.rlmg_v3_tc_step.restype = i
        lib.rlmg_v3_tc_shape_ok.argtypes = [i] * 3
        lib.rlmg_v3_tc_shape_ok.restype = i
        lib.rlmg_v3_tc_scratch_floats.argtypes = [i] * 3
        lib.rlmg_v3_tc_scratch_floats.restype = ctypes.c_longlong
        lib.rlmg_v3_tc_runs.argtypes = [i]
        lib.rlmg_v3_tc_runs.restype = ctypes.c_longlong
        lib.rlmg_error_string.argtypes = [i]
        lib.rlmg_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _check_v3_state(h0: torch.Tensor, s_aug: torch.Tensor, n_head: int,
                    name: str) -> Tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks of h0 and the augmented
    state; returns (B, D, L)."""
    if h0.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {h0.device}")
    if (h0.dim() != 2 or h0.dtype != torch.float32 or not h0.is_contiguous()
            or h0.data_ptr() % 16):
        raise TypeError(f"{name}: h0 must be a contiguous, 16-byte aligned float32 (B, D) "
                        "tensor")
    b, d = h0.shape
    if n_head < 1 or d % n_head:
        raise ValueError(f"{name}: d_model {d} is not a multiple of n_head {n_head}")
    e = d // n_head
    if (s_aug.dim() != 5 or tuple(s_aug.shape[1:]) != (n_head, b, e, e + 1)
            or s_aug.dtype != torch.float32 or not s_aug.is_contiguous()
            or s_aug.device != h0.device):
        raise ValueError(f"{name}: state {tuple(s_aug.shape)} {s_aug.dtype}; expected a "
                         f"contiguous float32 (L, {n_head}, {b}, {e}, {e + 1}) on {h0.device}")
    return b, d, s_aug.shape[0]


def _check_v3_weights(ws: Sequence[torch.Tensor], L: int, d: int, device,
                      name: str) -> int:
    """The 12 weights in the kernel's order, stacked over L: the matrices one
    dtype (f32 or bf16), the vectors f32, each contiguous on ``device``.
    Returns DI."""
    di = ws[7].numel() // L
    per_layer = (3 * d * d, 3 * d, d * d, d, d, d, d * di, di, di * d, d, d, d)
    wdt = ws[0].dtype
    if wdt not in _KERNEL_DTYPES:
        raise TypeError(f"{name}: weights {wdt} (the kernel takes float32 or bfloat16)")
    for idx, (t, n) in enumerate(zip(ws, per_layer)):
        want = wdt if idx in _MATRICES else torch.float32
        if (t.numel() != L * n or t.dtype != want or t.device != device
                or not t.is_contiguous()):
            raise ValueError(f"{name}: weight {V3_KEYS[idx]} {tuple(t.shape)} {t.dtype}: "
                             f"expected {L * n} contiguous {want} values on {device}")
    return di


def _check_v3_inputs(ws: Sequence[torch.Tensor], h0: torch.Tensor, s_aug: torch.Tensor,
                     n_head: int, name: str) -> Tuple[int, int, int, int]:
    """``_check_v3_state`` and ``_check_v3_weights``; returns (B, D, L, DI)."""
    b, d, L = _check_v3_state(h0, s_aug, n_head, name)
    return b, d, L, _check_v3_weights(ws, L, d, h0.device, name)


def run_aug(ws: Sequence[torch.Tensor], h0: torch.Tensor, s_aug: torch.Tensor, *,
            n_head: int, eps: float, name: str) -> Tuple[torch.Tensor, int]:
    """One call of ``csrc/decode_aug.cu``'s per-layer passes (the v1 kernel:
    the (D, 3D) [q | k | v] weight, LN1 of h + (att Wo + bo), the tanh gelu)
    on CUDA tensors: the L layers of ``s_aug`` (L, H, B, E, E + 1) f32,
    updated in place.  ws: the 12 weights in the kernel's order, stacked
    over L (or one layer's, L = 1); the matrices one dtype (f32 or bf16),
    the vectors f32.  Returns (h (B, D) f32, the number of CUDA launches
    issued)."""
    b, d, L, di = _check_v3_inputs(ws, h0, s_aug, n_head, name)
    wdt = ws[0].dtype
    if d > 2048:
        raise ValueError(f"{name}: d_model {d} above the kernel's 2048")
    lib = _lib()
    with torch.cuda.device(h0.device):
        h = h0.clone()                       # the kernel overwrites its input
        scratch = torch.empty(lib.rlmg_aug_scratch_floats(b, d, di), dtype=torch.float32,
                              device=h0.device)
        done = torch.zeros(n_head * b, dtype=torch.int32, device=h0.device)
        ptrs = (ctypes.c_void_p * len(ws))(*[t.data_ptr() for t in ws])
        launched = ctypes.c_int()
        rc = lib.rlmg_decode_aug(
            h.data_ptr(), ptrs, s_aug.data_ptr(), scratch.data_ptr(), done.data_ptr(),
            L, b, d, n_head, di, eps, int(wdt == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream, ctypes.byref(launched))
    if rc:
        raise RuntimeError(f"{name} kernel: {lib.rlmg_error_string(rc).decode()}")
    return h, launched.value


def aug_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        s_aug: torch.Tensor, eps: float) -> torch.Tensor:
    """The state pass in PyTorch: q, k, v (H, B, E) with phi applied to q
    and k; s_aug (H, B, E, E + 1) f32 gets S += k [v, 1] in place.  Returns
    att (H, B, E) = num[:E] / (num[E] + eps), num = q . S_new."""
    e = q.shape[-1]
    va = torch.cat([v, torch.ones_like(v[..., :1])], dim=-1)
    s_new = s_aug + k[..., :, None] * va[..., None, :]
    s_aug.copy_(s_new)
    num = torch.einsum("hbe,hbef->hbf", q, s_new)
    return num[..., :e] / (num[..., e:] + eps)


def fused_stack_step_plain(v3p: dict, h0: torch.Tensor, s_aug: torch.Tensor, *,
                           n_head: int, eps: float = DEFAULT_EPS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's arithmetic in PyTorch: f32 activations, weights read in
    their stored dtype, the f32 state updated in place; LN1 of (h + sum_h
    att_h Wo_h) + bo, the exact gelu."""
    w = {k: v3p[k].float() for k in V3_KEYS}
    h = h0.float()
    e = h.shape[1] // n_head
    for l in range(s_aug.shape[0]):
        qkv = torch.einsum("bd,hdf->hbf", h, w["qkvw"][l]) + w["qkvb"][l]     # (H, B, 3E)
        att = aug_attention_plain(phi(qkv[..., :e]), phi(qkv[..., e:2 * e]), qkv[..., 2 * e:],
                                  s_aug[l], eps)
        ao = torch.einsum("hbe,hed->bd", att, w["wow"][l])
        h1 = ln((h + ao) + w["wob"][l, 0], w["ln1s"][l, 0], w["ln1b"][l, 0])
        y = gelu_exact(h1 @ w["f1w"][l] + w["f1b"][l, 0]) @ w["f2w"][l] + w["f2b"][l, 0]
        h = ln(h1 + y, w["ln2s"][l, 0], w["ln2b"][l, 0])
    return h, s_aug


def workspace(v3p: dict, b: int) -> dk4.StackWorkspace:
    """The token kernel's workspace for ``v3p`` at batch b
    (``decode_kernel_v4.stack_workspace``): the four (L, K, N) matrices, the
    qkv weight's columns head-major ([q_h k_h v_h] head by head), and the
    eight f32 vectors, copied.  Build it once and pass it to each
    ``fused_stack_step`` call with these weights and batch."""
    L, _, d, _ = v3p["qkvw"].shape
    _check_v3_weights([v3p[k] for k in V3_KEYS], L, d, v3p["qkvw"].device, "workspace (v3)")
    qkvw = v3p["qkvw"].permute(0, 2, 1, 3).reshape(L, d, 3 * d)
    mats = [qkvw, v3p["wow"].reshape(L, d, d), v3p["f1w"], v3p["f2w"]]
    vecs = [v3p[k].reshape(L, -1) for k in ("qkvb", "wob", "ln1s", "ln1b", "f1b", "f2b",
                                             "ln2s", "ln2b")]
    return dk4.stack_workspace(mats, vecs, b, "rlmg_v3_tc", _lib())


def kernel_runs(reset: bool = False) -> int:
    """Runs of v3's kernel on the current card since the last reset, as the
    kernel counts them (a launch that ran to its end, eager or replayed from
    a CUDA graph); waits for the card.  ``reset`` zeroes the count after
    reading it."""
    n = _lib().rlmg_v3_tc_runs(int(reset))
    if n < 0:
        raise RuntimeError(f"decode_aug: {_lib().rlmg_error_string(-n).decode()}")
    return n


def fused_stack_step(v3p: Optional[dict], h0: torch.Tensor, s_aug: torch.Tensor, *,
                     n_head: int, eps: float = DEFAULT_EPS,
                     work: Optional[dk4.StackWorkspace] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All layers, one token.  h0 (B, D) float32 after the embedding; s_aug
    (L, H, B, E, E + 1) float32, UPDATED IN PLACE.  Returns (h_out f32,
    s_aug).

    CUDA tensors go to the kernel, with the weights of ``work`` (then v3p is
    not read and may be None; h_out is work's buffer, which the next call
    with it overwrites) or of a workspace built from v3p for this call.
    ``launches`` counts the calls that launched, ``cuda_launches`` the CUDA
    launches they issued; a call inside a CUDA graph capture records the
    launch and counts nothing (``kernel_runs`` counts the replays).  CPU
    tensors go to ``fused_stack_step_plain``; any other device raises."""
    if h0.device.type == "cpu":
        return fused_stack_step_plain(v3p, h0, s_aug, n_head=n_head, eps=eps)
    name = "fused_stack_step (v3)"
    b, d, L = _check_v3_state(h0, s_aug, n_head, name)
    if work is None:
        work = workspace(v3p, b)
    if (L, b, d) != (work.L, work.b, work.d) or work.h_out.device != h0.device:
        raise ValueError(f"{name}: h0 ({b}, {d}) and state of {L} layers on {h0.device}; the "
                         f"workspace serves ({work.b}, {work.d}) and {work.L} layers on "
                         f"{work.h_out.device}")
    lib = _lib()
    dk4.check_shape(lib.rlmg_v3_tc_shape_ok, d, n_head, work.di, name)
    with torch.cuda.device(h0.device):
        launched = ctypes.c_int()
        rc = lib.rlmg_v3_tc_step(
            work.wptr, work.vptr, s_aug.data_ptr(), h0.data_ptr(), work.h_out.data_ptr(),
            work.scratch.data_ptr(), work.cnt.data_ptr(), L, b, d, n_head, work.di, eps,
            int(work.mats[0].dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
    if rc:
        raise RuntimeError(f"{name} kernel: {lib.rlmg_error_string(rc).decode()}")
    if not torch.cuda.is_current_stream_capturing():    # a capture records, launches nothing
        fused_stack_step.launches += 1
        fused_stack_step.cuda_launches += launched.value
    return work.h_out, s_aug


fused_stack_step.launches = fused_stack_step.cuda_launches = 0


def decode_step_v3(params: dict, v3p: dict, cfg, token: torch.Tensor, state: DecodeState, *,
                   pe_table: Optional[torch.Tensor] = None,
                   work: Optional[dk4.StackWorkspace] = None
                   ) -> Tuple[torch.Tensor, DecodeState]:
    """``lt.decode_step`` with the layer stack in the kernel (JAX :251-270).
    ``state.s`` is the augmented (L, H, B, E, E + 1) state (``state.z`` is
    unused); the embedding, in_linear, pe add and final LN stay plain.
    ``work``: v3p's workspace at this batch (``workspace``), for a caller
    that steps many tokens."""
    h = embed_input(params, cfg, token, state.step, pe_table)
    h_out, s = fused_stack_step(v3p, h.float(), state.s, n_head=cfg.n_head, eps=cfg.attn_eps,
                                work=work)
    h_out = cm.layernorm(params["final_ln"], h_out.to(h.dtype))
    return h_out, DecodeState(s, state.z, state.step + 1)
