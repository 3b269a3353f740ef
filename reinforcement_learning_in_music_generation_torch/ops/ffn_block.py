"""The post-attention half of a training layer, fused: the counterparts of
the JAX package's ``ops/ffn_block.py`` ``attn_tail_block`` (Pallas bodies
``_tail_fwd_kernel`` and ``_tail_bwd_kernel``) and ``ffn_block`` (``_fwd_kernel``
and ``_bwd_kernel``).

    attn_tail_block:  out = LN2(h1 + FFN(h1)),  h1 = LN1(h_in + drop1(Wo @ a_pre + bo))
    ffn_block:        out = LN2(h + FFN(h))
    FFN(x) = drop3(W2 @ drop2(gelu(W1 @ x + b1)) + b2)

Kernel D: ``csrc/attn_tail.cu``; kernel G: ``csrc/ffn_block.cu``, which is
kernel D without the Wo + LN1 head (the FFN half of both is
``csrc/ffn_tail.cuh``; tensor-core product tiles and LayerNorm row kernels
from ``csrc/train_gemm_tc.cuh``).  Hand-written CUDA for ``sm_90a``, built
at first use (``_build.py``) and called through ctypes.  Every product (on
the tensor cores), the elementwise steps (bias, exact-erf gelu, dropout,
residual) and the LayerNorms run in the kernels' own code, forward and
backward.  The backward saves only the inputs ((h_in, a_pre) for D, h for
G) and the seed and recomputes the rest, as the TPU kernels do; weight
gradients are row-split products added in a fixed order, so they are
bit-reproducible.

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

Arithmetic.  f32 inputs: each product's operands split into three bf16
planes (the 24 bits of an f32 value), six bf16 products, each depth's sum
added in f32 (f32-grade results on the tensor cores).  bf16 inputs (one
type for the inputs and every parameter): JAX's arithmetic, each
product's operands rounded to bf16 and summed in f32 (the weight-gradient
products too, as the TPU's MXU rounds them), everything else in f32; the
output and the gradients come back in the inputs' type.  The plain
versions compute the same (``_product``).

``attn_tail_block`` and ``ffn_block`` launch their kernel for CUDA tensors
(counting forward and backward calls apart, and in ``cuda_launches`` the
CUDA launches the calls issued, none while a CUDA graph capture records;
kernel G's forward also counts its own runs on the card, graph replays
included, read by ``ffn_kernel_runs``)
and run their plain version
(``attn_tail_block_plain``, ``ffn_block_plain``) for CPU tensors; any other
device raises.  The kernels take contiguous float32 or bfloat16 with widths
that are multiples of 8 (16-byte copies of the products' bf16 operands) and
d_model <= 1024, at any row count: the TPU kernels' row block (and its zero
padding) has no counterpart.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Union

import torch

from . import _build
from .decode_common import gelu_exact, ln, philox_bits

MAX_D = 1024            # csrc/train_gemm_tc.cuh LN_MAX_D

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


def _rounded(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to bf16 (to nearest even) and read back: a
    product's operand as the bf16 kernels feed it to the tensor cores."""
    return x.to(torch.bfloat16).float()


class _RoundedProduct(torch.autograd.Function):
    """a @ b of f32 tensors with both operands rounded to bf16 and the sum
    taken in f32: JAX's ``dot(x.astype(bf16), w, preferred_element_type=f32)``.
    The backward's products round their operands too (da = R(g) @ R(b)^T,
    db = R(a)^T @ R(g)): JAX rounds g where it casts it (``dx2``, ``dx1``,
    ``da``) and the TPU's MXU rounds the f32 operands of its dW products
    (``ops/ffn_block.py`` :157-158, :378-379 of the JAX package)."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = _rounded(a), _rounded(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = _rounded(g)
        return rg @ rb.T, ra.T @ rg


def _product(dtype: torch.dtype):
    """The kernels' product for inputs of ``dtype``: f32 products in f32,
    bf16 ones on rounded operands with f32 sums."""
    return _RoundedProduct.apply if dtype == torch.bfloat16 else torch.matmul


def _ffn_plain(h, w1, b1, w2, b2, ln_s, ln_b, seed: Seed, p: float, mid_drop: bool,
               mm) -> torch.Tensor:
    """LN2(h + FFN(h)) in PyTorch ops on f32 ``h``, with the kernels' masks
    of sites 2 and 3 (site 2 only with ``mid_drop``) and their products
    ``mm``; everything else in f32 (the parameters are read up)."""
    n, d = h.shape
    g = gelu_exact(mm(h, w1.float()) + b1.float())
    if p > 0.0 and mid_drop:
        g = g * dropout_scale(seed, 2, 0, n, w1.shape[1], p, h.device)
    x2 = mm(g, w2.float()) + b2.float()
    if p > 0.0:
        x2 = x2 * dropout_scale(seed, 3, 0, n, d, p, h.device)
    return ln(h + x2, ln_s.float(), ln_b.float())


def attn_tail_block_plain(h_in, a_pre, wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b,
                          seed: Seed, p: float, mid_drop: bool = True) -> torch.Tensor:
    """The same function in PyTorch ops (autograd gives the backward), over
    all rows at once, with the kernel's dropout masks.  With bf16 inputs it
    computes JAX's arithmetic: each product's operands rounded to bf16 and
    summed in f32, bias, gelu, dropout, residuals and both LayerNorms in
    f32, the output cast back (and each gradient to its input's type)."""
    n, d = h_in.shape
    p = float(p or 0.0)
    mm = _product(h_in.dtype)
    a = mm(a_pre.float(), wow.float()) + wob.float()
    if p > 0.0:
        a = a * dropout_scale(seed, 1, 0, n, d, p, h_in.device)
    h1 = ln(h_in.float() + a, ln1s.float(), ln1b.float())
    out = _ffn_plain(h1, w1, b1, w2, b2, ln2s, ln2b, seed, p, mid_drop, mm)
    return out.to(h_in.dtype)


def ffn_block_plain(h, w1, b1, w2, b2, ln_s, ln_b, seed: Seed, p: float) -> torch.Tensor:
    """``ffn_block`` in PyTorch ops (autograd gives the backward), over all
    rows at once, with kernel G's dropout masks (sites 2 and 3); bf16
    inputs as ``attn_tail_block_plain``."""
    out = _ffn_plain(h.float(), w1, b1, w2, b2, ln_s, ln_b, seed, float(p or 0.0), True,
                     _product(h.dtype))
    return out.to(h.dtype)


def _ffn_shapes(d: int, di: int) -> list:
    """The shapes of the FFN's six parameters (w1, b1, w2, b2, ln_scale,
    ln_bias) at widths (d, di)."""
    return [(d, di), (di,), (di, d), (d,), (d,), (d,)]


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check(kernel: str, inputs, ws, names, shapes) -> None:
    """Raise unless ``inputs`` (name, tensor) are (N, D) and ``ws`` (named
    ``names``) have ``shapes``, all contiguous float32, or all bfloat16, on
    one device, with widths the kernel takes."""
    h = inputs[0][1]
    n, d = h.shape
    di = shapes[-6][1]
    if h.dtype not in KERNEL_DTYPES:
        raise TypeError(f"{kernel}: {h.dtype} (the kernel takes float32 or bfloat16)")
    for name, t in tuple(inputs) + tuple(zip(names, ws)):
        if t.dtype != h.dtype:
            raise TypeError(f"{name}: {t.dtype}, expected {h.dtype} like the input")
        if t.device != h.device or not t.is_contiguous():
            raise ValueError(f"{name}: must be contiguous and on {h.device}")
    for name, t in inputs[1:]:
        if tuple(t.shape) != (n, d):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {(n, d)}")
    for name, t, shape in zip(names, ws, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if d % 8 or di % 8 or d > MAX_D:
        raise ValueError(f"d_model {d}, d_inner {di}: the kernel needs multiples of 8 "
                         f"and d_model <= {MAX_D}")


def _dropout_rate(p) -> float:
    p = float(p or 0.0)
    if not 0.0 <= p < 1.0:
        raise ValueError(f"dropout rate {p} outside [0, 1)")
    return p


def _seed_tensor(seed: Seed, device) -> torch.Tensor:
    """The 0-d int32 seed on ``device`` that the kernel reads; an int seed is
    a fill on the card, with no host-to-device copy per call."""
    if torch.is_tensor(seed):
        return seed.to(device=device, dtype=torch.int32).reshape(())
    return torch.full((), int(seed), dtype=torch.int32, device=device)


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# each library's C interface: symbol -> (argtypes, restype)
_BINDINGS = {
    "attn_tail": {                                              # kernel D
        "rlmg_tail_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "rlmg_attn_tail_fwd": ([_P] * 6 + [_F, _F] + [_I] * 5 + [_P], _I),
        "rlmg_attn_tail_bwd": ([_P] * 7 + [_F, _F] + [_I] * 5 + [_P], _I),
        "rlmg_cuda_launches": ([], ctypes.c_longlong),
        "rlmg_error_string": ([_I], ctypes.c_char_p)},
    "ffn_block": {                                              # kernel G
        "rlmg_ffn_scratch_floats": ([_I] * 5, ctypes.c_longlong),
        "rlmg_ffn_fwd": ([_P] * 5 + [_F, _F] + [_I] * 4 + [_P], _I),
        "rlmg_ffn_bwd": ([_P] * 6 + [_F, _F] + [_I] * 4 + [_P], _I),
        "rlmg_tile_scratch_floats": ([_I] * 3, ctypes.c_longlong),
        "rlmg_tile_product": ([_P] * 4 + [_I] * 6 + [_P], _I),
        "rlmg_ffn_runs": ([ctypes.POINTER(ctypes.c_longlong), _I], _I),
        "rlmg_cuda_launches": ([], ctypes.c_longlong),
        "rlmg_error_string": ([_I], ctypes.c_char_p)},
}
_LIBS: dict = {}


def _lib(name: str) -> ctypes.CDLL:
    """The library ``name`` of ``_BINDINGS``, built and bound at first use."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _build.load(name)
        for sym, (args, res) in _BINDINGS[name].items():
            fn = getattr(lib, sym)
            fn.argtypes, fn.restype = args, res
        lib = _LIBS.setdefault(name, lib)
    return lib


def _ptrs(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _is_bf16(h: torch.Tensor) -> int:
    return int(h.dtype == torch.bfloat16)


def _run(name: str, sym: str, what: str, h: torch.Tensor, args, counted) -> None:
    """Call ``sym`` of library ``name`` with ``args``, the dtype flag of
    ``h`` and the current stream of its device; add the CUDA launches it
    issued to ``counted.cuda_launches``; raise on an error code."""
    lib = _lib(name)
    before = lib.rlmg_cuda_launches()
    with torch.cuda.device(h.device):
        rc = getattr(lib, sym)(*args, _is_bf16(h), torch.cuda.current_stream().cuda_stream)
    if not torch.cuda.is_current_stream_capturing():    # a capture records, launches nothing
        counted.cuda_launches += lib.rlmg_cuda_launches() - before
    if rc:
        raise RuntimeError(f"{name} {what} kernel: {lib.rlmg_error_string(rc).decode()}")


def forward_kernel(h_in, a_pre, ws, seed: torch.Tensor, p: float,
                   mid_drop: bool) -> torch.Tensor:
    """One forward launch on checked inputs (``ws``: the ten parameters in
    signature order; ``seed``: an int32 tensor on the card) -> out (N, D).
    Counted in ``attn_tail_block.cuda_launches``, not in ``launches_fwd``
    (the wrapper counts its calls)."""
    n, d = h_in.shape
    di = ws[4].shape[1]
    lib = _lib("attn_tail")
    out = torch.empty_like(h_in)
    scratch = torch.empty(lib.rlmg_tail_scratch_floats(n, d, di, 0, _is_bf16(h_in)),
                          dtype=torch.float32, device=h_in.device)
    _run("attn_tail", "rlmg_attn_tail_fwd", "forward", h_in,
         (h_in.data_ptr(), a_pre.data_ptr(), _ptrs(ws), out.data_ptr(), scratch.data_ptr(),
          seed.data_ptr(), p, 1.0 / (1.0 - p), int(mid_drop), n, d, di), attn_tail_block)
    return out


def backward_kernel(h_in, a_pre, ws, dout, seed: torch.Tensor, p: float,
                    mid_drop: bool) -> list:
    """One backward launch (recomputing the forward from h_in, a_pre and
    the seed) -> the twelve gradients [dh_in, da_pre, d ws...].  Counted in
    ``cuda_launches``, not in ``launches_bwd``."""
    n, d = h_in.shape
    di = ws[4].shape[1]
    lib = _lib("attn_tail")
    grads = [torch.empty_like(h_in), torch.empty_like(a_pre)] + [torch.empty_like(w)
                                                                  for w in ws]
    scratch = torch.empty(lib.rlmg_tail_scratch_floats(n, d, di, 1, _is_bf16(h_in)),
                          dtype=torch.float32, device=h_in.device)
    _run("attn_tail", "rlmg_attn_tail_bwd", "backward", h_in,
         (h_in.data_ptr(), a_pre.data_ptr(), _ptrs(ws), dout.data_ptr(), _ptrs(grads),
          scratch.data_ptr(), seed.data_ptr(), p, 1.0 / (1.0 - p), int(mid_drop), n, d, di),
         attn_tail_block)
    return grads


class _AttnTail(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h_in, a_pre, wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b, seed,
                p: float, mid_drop: bool):
        ws = [wow, wob, ln1s, ln1b, w1, b1, w2, b2, ln2s, ln2b]
        out = forward_kernel(h_in, a_pre, ws, seed, p, mid_drop)
        if not torch.cuda.is_current_stream_capturing():
            attn_tail_block.launches_fwd += 1
        ctx.save_for_backward(h_in, a_pre, *ws, seed)
        ctx.cfg = (p, mid_drop)
        return out

    @staticmethod
    def backward(ctx, dout):
        h_in, a_pre, *ws, seed = ctx.saved_tensors
        grads = backward_kernel(h_in, a_pre, ws, dout.to(h_in.dtype).contiguous(), seed,
                                *ctx.cfg)
        attn_tail_block.launches_bwd += 1
        return (*grads, None, None, None)


_TAIL_NAMES = ("wo_w", "wo_b", "ln1_scale", "ln1_bias", "ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b",
               "ln2_scale", "ln2_bias")


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
    d = h_in.shape[-1]
    _check("attn_tail_block", (("h_in", h_in), ("a_pre", a_pre)), ws, _TAIL_NAMES,
           [(d, d), (d,), (d,), (d,)] + _ffn_shapes(d, w1.shape[-1]))
    return _AttnTail.apply(h_in, a_pre, *ws, _seed_tensor(seed, h_in.device), _dropout_rate(p),
                           bool(mid_drop))


attn_tail_block.launches_fwd = 0
attn_tail_block.launches_bwd = 0
attn_tail_block.cuda_launches = 0


# -- kernel G: ffn_block -------------------------------------------------------

def ffn_forward_kernel(h, ws, seed: torch.Tensor, p: float) -> torch.Tensor:
    """One forward launch of kernel G on checked inputs (``ws``: w1, b1, w2,
    b2, ln_scale, ln_bias; ``seed``: an int32 tensor on the card) -> out
    (N, D).  Counted in ``ffn_block.cuda_launches``, not in ``launches_fwd``."""
    n, d = h.shape
    di = ws[0].shape[1]
    lib = _lib("ffn_block")
    out = torch.empty_like(h)
    scratch = torch.empty(lib.rlmg_ffn_scratch_floats(n, d, di, 0, _is_bf16(h)),
                          dtype=torch.float32, device=h.device)
    _run("ffn_block", "rlmg_ffn_fwd", "forward", h,
         (h.data_ptr(), _ptrs(ws), out.data_ptr(), scratch.data_ptr(), seed.data_ptr(), p,
          1.0 / (1.0 - p), n, d, di), ffn_block)
    return out


def ffn_backward_kernel(h, ws, dout, seed: torch.Tensor, p: float) -> list:
    """One backward launch of kernel G (recomputing the forward from h and
    the seed) -> the seven gradients [dh, dw1, db1, dw2, db2, dln_scale,
    dln_bias].  Counted in ``cuda_launches``, not in ``launches_bwd``."""
    n, d = h.shape
    di = ws[0].shape[1]
    lib = _lib("ffn_block")
    grads = [torch.empty_like(h)] + [torch.empty_like(w) for w in ws]
    scratch = torch.empty(lib.rlmg_ffn_scratch_floats(n, d, di, 1, _is_bf16(h)),
                          dtype=torch.float32, device=h.device)
    _run("ffn_block", "rlmg_ffn_bwd", "backward", h,
         (h.data_ptr(), _ptrs(ws), dout.data_ptr(), _ptrs(grads), scratch.data_ptr(),
          seed.data_ptr(), p, 1.0 / (1.0 - p), n, d, di), ffn_block)
    return grads


class _Ffn(torch.autograd.Function):
    """Kernel G forward and backward; saves h, the parameters and the seed
    (nothing of the forward's intermediates: the backward recomputes them,
    as the TPU kernel's ``_ffn_bwd`` does)."""

    @staticmethod
    def forward(ctx, h, w1, b1, w2, b2, ln_s, ln_b, seed, p: float):
        ws = [w1, b1, w2, b2, ln_s, ln_b]
        out = ffn_forward_kernel(h, ws, seed, p)
        if not torch.cuda.is_current_stream_capturing():
            ffn_block.launches_fwd += 1
        ctx.save_for_backward(h, *ws, seed)
        ctx.p = p
        return out

    @staticmethod
    def backward(ctx, dout):
        h, *ws, seed = ctx.saved_tensors
        grads = ffn_backward_kernel(h, ws, dout.to(h.dtype).contiguous(), seed, ctx.p)
        ffn_block.launches_bwd += 1
        return (*grads, None, None)


_FFN_NAMES = ("ffn1_w", "ffn1_b", "ffn2_w", "ffn2_b", "ln2_scale", "ln2_bias")


def ffn_block(h, w1, b1, w2, b2, ln_s, ln_b, seed: Seed, p: float) -> torch.Tensor:
    """h (N, D) -> LN(h + drop3(W2 @ drop2(gelu(W1 @ h + b1)) + b2)), fully
    fused (kernel G).  ``seed``: an int or an int32 tensor (read by the
    kernel on the card, no host sync); ``p`` the dropout rate (0: none).
    Any N: the TPU kernel's ``block`` (row padding) has no counterpart.
    Differentiable in h and the six parameters."""
    if h.device.type == "cpu":
        return ffn_block_plain(h, w1, b1, w2, b2, ln_s, ln_b, seed, p)
    if h.device.type != "cuda":
        raise ValueError(f"ffn_block: no kernel for device {h.device}")
    ws = [w1, b1, w2, b2, ln_s, ln_b]
    d = h.shape[-1]
    _check("ffn_block", (("h", h),), ws, _FFN_NAMES, _ffn_shapes(d, w1.shape[-1]))
    return _Ffn.apply(h, *ws, _seed_tensor(seed, h.device), _dropout_rate(p))


ffn_block.launches_fwd = 0
ffn_block.launches_bwd = 0
ffn_block.cuda_launches = 0


# -- the product tile of kernels D and G, alone --------------------------------

def tile_product(a: torch.Tensor, b: torch.Tensor, a_t: bool = False,
                 b_t: bool = False) -> torch.Tensor:
    """op(a) @ op(b) in float32 on the tensor-core product tile of kernels D
    and G (``csrc/train_gemm_tc.cuh``): ``a`` is (M, K), or (K, M) with
    ``a_t``; ``b`` is (K, N), or (N, K) with ``b_t`` (the layouts the
    kernels use: not both); both float32 (the split arithmetic) or both
    bfloat16 (one product of the bf16 values).  The tile's own check for the
    card-only tests and ``chip_smoke.py``; the kernels call the tile from C.
    On CPU tensors the plain version, the same products in PyTorch."""
    A, B = (a.T if a_t else a), (b.T if b_t else b)
    if a.device.type == "cpu":
        return _product(a.dtype)(A.float(), B.float())
    if a.device.type != "cuda":
        raise ValueError(f"tile_product: no kernel for device {a.device}")
    if a.dtype not in KERNEL_DTYPES or b.dtype != a.dtype:
        raise TypeError(f"tile_product: {a.dtype} and {b.dtype} (both float32 or bfloat16)")
    if a.ndim != 2 or b.ndim != 2 or A.shape[1] != B.shape[0] or (a_t and b_t):
        raise ValueError(f"tile_product: shapes {tuple(a.shape)}, {tuple(b.shape)} "
                         f"(a_t={a_t}, b_t={b_t})")
    if not (a.is_contiguous() and b.is_contiguous()) or a.shape[1] % 8 or b.shape[1] % 8:
        raise ValueError("tile_product: contiguous operands whose rows are multiples of 8")
    m, k = A.shape
    n = B.shape[1]
    lib = _lib("ffn_block")
    c = torch.empty((m, n), dtype=torch.float32, device=a.device)
    scratch = torch.empty(lib.rlmg_tile_scratch_floats(m, n, k), dtype=torch.float32,
                          device=a.device)
    _run("ffn_block", "rlmg_tile_product", "product", a,
         (a.data_ptr(), b.data_ptr(), c.data_ptr(), scratch.data_ptr(), m, n, k, int(a_t),
          int(b_t)), tile_product)
    return c


tile_product.cuda_launches = 0


def ffn_kernel_runs(reset: bool = False) -> int:
    """Forward calls of kernel G that ran on the current card since the last
    reset, as the kernel counts them (its last launch; eager or replayed
    from a CUDA graph); waits for the card.  ``reset`` zeroes the count
    after the read."""
    lib = _lib("ffn_block")
    n = ctypes.c_longlong()
    rc = lib.rlmg_ffn_runs(ctypes.byref(n), int(reset))
    if rc:
        raise RuntimeError(f"ffn_block run count: {lib.rlmg_error_string(rc).decode()}")
    return n.value
