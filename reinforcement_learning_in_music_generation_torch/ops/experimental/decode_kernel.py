"""One decoder layer of one token on the augmented state: the counterpart of
the JAX package's ``ops/experimental/decode_kernel.py`` (``fused_layer_step``,
v1, its Pallas body ``_layer_kernel``; ``fused_layer_step_v2``, v2,
``_layer_kernel_v2``).

The state is the layer's (H, B, E, E + 1) f32 augmented state, z as its last
column.  Both variants use the tanh gelu of the TPU kernels; they differ in
the qkv and Wo layouts and in where the Wo bias joins the residual: v1
reads the layer's (D, 3D) [q | k | v] weight and forms h + (att Wo + bo), v2
reads head-major weights, qkv (H, D, 3E) and Wo (H, E, D), and forms
(h + sum_h att_h Wo_h) + bo.

Kernels (``csrc/decode_aug.cu``):
  v2  kernel A's token kernel (``csrc/decode_stack_tc.cuh``) for one layer
      with the tanh gelu, v3's layer: one cooperative launch a call, every
      product on the tensor cores at f32 grade.  Its weights are the
      layer's leaves packed by one launch of ``rlmg_v2_pack`` (the
      head-major qkv columns and Wo in mma fragment order, the vectors f32),
      kept in an LRU (``V2_CACHE_SIZE`` layers) while every leaf keeps its
      storage and version; an in-place update repacks.  So a call issues one
      CUDA launch once its layer is packed and two when it packs (one more
      each way when h is not a contiguous float32 tensor).
  v1  the per-layer passes (``decode_kernel_v3.run_aug``): 9 CUDA launches.
``fused_decode_step`` loops a variant over the layers (JAX :220-249), which
only tests and ``chip_smoke.py`` call, as in the JAX package.

Each variant launches its kernel for CUDA tensors and runs its plain twin
(``fused_layer_step_plain``, ``fused_layer_step_v2_plain``) for CPU
tensors; any other device raises.  All of them update the state in place.
"""

from __future__ import annotations

import collections
import ctypes
import weakref
from typing import List, NamedTuple, Optional, Tuple

import torch

from ...models import common as cm
from ...models.linear_transformer import DecodeState, embed_input
from .. import decode_kernel_v4 as dk4
from ..decode_common import gelu_tanh, ln, phi
from ..decode_kernel_v3 import _lib, aug_attention_plain, init_aug_state, run_aug
from ..linear_attention import DEFAULT_EPS

aug_state_init = init_aug_state          # the JAX module's name (:252)


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _tail_weights(lp: dict) -> list:
    """The layer's weights after Wo in the kernel's order: matrices in their
    dtype, vectors f32."""
    return [_f32(lp["wo"]["b"]), _f32(lp["ln1"]["scale"]), _f32(lp["ln1"]["bias"]),
            lp["ffn1"]["w"].contiguous(), _f32(lp["ffn1"]["b"]), lp["ffn2"]["w"].contiguous(),
            _f32(lp["ffn2"]["b"]), _f32(lp["ln2"]["scale"]), _f32(lp["ln2"]["bias"])]


def _v1_weights(lp: dict) -> list:
    """One layer's weights in the kernel's order, the (D, 3D) qkv layout
    (JAX :101-102)."""
    qkv_w = torch.cat([lp["wq"]["w"], lp["wk"]["w"], lp["wv"]["w"]], dim=-1).contiguous()
    qkv_b = torch.cat([lp["wq"]["b"], lp["wk"]["b"], lp["wv"]["b"]], dim=-1)
    return [qkv_w, _f32(qkv_b), lp["wo"]["w"].contiguous()] + _tail_weights(lp)


def head_major_layer_params(layer_params: dict, n_head: int) -> dict:
    """One layer's weights head-major for v2 (JAX :167-184): qkvw
    (H, D, 3E), qkvb (H, 3E), wow (H, E, D)."""
    lp = layer_params
    d = lp["wq"]["w"].shape[0]
    e = d // n_head

    def split_cols(w):   # (D, D) -> (H, D, E)
        return w.reshape(d, n_head, e).permute(1, 0, 2)

    qkvw = torch.cat([split_cols(lp["wq"]["w"]), split_cols(lp["wk"]["w"]),
                      split_cols(lp["wv"]["w"])], dim=-1).contiguous()
    qkvb = torch.cat([lp["wq"]["b"].reshape(n_head, e), lp["wk"]["b"].reshape(n_head, e),
                      lp["wv"]["b"].reshape(n_head, e)], dim=-1)
    return {"qkvw": qkvw, "qkvb": qkvb, "wow": lp["wo"]["w"].reshape(n_head, e, d)}


def _v2_weights(lp: dict, n_head: int) -> list:
    hm = head_major_layer_params(lp, n_head)
    return [hm["qkvw"], _f32(hm["qkvb"]), hm["wow"].contiguous()] + _tail_weights(lp)


def fused_layer_step_plain(h: torch.Tensor, layer_params: dict, s_aug: torch.Tensor, *,
                           n_head: int, eps: float = DEFAULT_EPS
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v1's arithmetic in PyTorch (JAX ``_layer_kernel``): f32 activations,
    LN1 of h + (att Wo + bo), the tanh gelu; s_aug updated in place."""
    w = [t.float() for t in _v1_weights(layer_params)]
    qkv_w, qkv_b, wo_w, wo_b, l1s, l1b, f1w, f1b, f2w, f2b, l2s, l2b = w
    x = h.float()
    b, d = x.shape
    e = d // n_head
    qkv = x @ qkv_w + qkv_b

    def heads(t):        # (B, D) -> (H, B, E)
        return t.reshape(b, n_head, e).transpose(0, 1)

    att = aug_attention_plain(heads(phi(qkv[:, :d])), heads(phi(qkv[:, d:2 * d])),
                              heads(qkv[:, 2 * d:]), s_aug, eps)
    x = ln(x + (att.transpose(0, 1).reshape(b, d) @ wo_w + wo_b), l1s, l1b)
    y = gelu_tanh(x @ f1w + f1b) @ f2w + f2b
    return ln(x + y, l2s, l2b).to(h.dtype), s_aug


def fused_layer_step_v2_plain(h: torch.Tensor, layer_params: dict, s_aug: torch.Tensor, *,
                              n_head: int, eps: float = DEFAULT_EPS
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v2's arithmetic in PyTorch (JAX ``_layer_kernel_v2``): LN1 of
    (h + sum_h att_h Wo_h) + bo, the tanh gelu; s_aug updated in place."""
    w = [t.float() for t in _v2_weights(layer_params, n_head)]
    qkvw, qkvb, wow, wo_b, l1s, l1b, f1w, f1b, f2w, f2b, l2s, l2b = w
    x = h.float()
    e = x.shape[1] // n_head
    qkv = torch.einsum("bd,hdf->hbf", x, qkvw) + qkvb[:, None, :]
    att = aug_attention_plain(phi(qkv[..., :e]), phi(qkv[..., e:2 * e]), qkv[..., 2 * e:],
                              s_aug, eps)
    x = ln((x + torch.einsum("hbe,hed->bd", att, wow)) + wo_b, l1s, l1b)
    y = gelu_tanh(x @ f1w + f1b) @ f2w + f2b
    return ln(x + y, l2s, l2b).to(h.dtype), s_aug


def fused_layer_step(h: torch.Tensor, layer_params: dict, s_aug: torch.Tensor, *,
                     n_head: int, eps: float = DEFAULT_EPS
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v1: one decoder layer on one token.  h (B, D); layer_params this
    layer's wq/wk/wv/wo/ln1/ln2/ffn1/ffn2 (unstacked); s_aug (H, B, E, E + 1)
    float32, UPDATED IN PLACE.  Returns (h' in h's dtype, s_aug).

    CUDA tensors go to the kernel (``launches`` counts the calls,
    ``cuda_launches`` their CUDA launches); CPU tensors to
    ``fused_layer_step_plain``; any other device raises."""
    if h.device.type == "cpu":
        return fused_layer_step_plain(h, layer_params, s_aug, n_head=n_head, eps=eps)
    out, n = run_aug(_v1_weights(layer_params), h.float().contiguous(), s_aug[None],
                     n_head=n_head, eps=eps, name="fused_layer_step (v1)")
    fused_layer_step.launches += 1
    fused_layer_step.cuda_launches += n
    return out.to(h.dtype), s_aug


# -- v2: the layer's leaves packed for the token kernel ------------------------

# One layer's leaves in the order of csrc/decode_aug.cu's V2_WQ..V2_L2B.
V2_LEAVES = (("wq", "w"), ("wk", "w"), ("wv", "w"), ("wo", "w"), ("ffn1", "w"), ("ffn2", "w"),
             ("wq", "b"), ("wk", "b"), ("wv", "b"), ("wo", "b"), ("ln1", "scale"),
             ("ln1", "bias"), ("ffn1", "b"), ("ffn2", "b"), ("ln2", "scale"), ("ln2", "bias"))
V2_CACHE_SIZE = 64


def v2_leaves(layer_params: dict) -> List[torch.Tensor]:
    """The layer's 16 leaves in the packing's order (``V2_LEAVES``)."""
    return [layer_params[a][b] for a, b in V2_LEAVES]


def _v2_kernel_dtype(leaves: List[torch.Tensor]) -> torch.dtype:
    """The packed matrices' type: bf16 when all six matrices are bf16, else
    f32 (a bf16 value is exact in f32 too)."""
    return (torch.bfloat16 if all(t.dtype == torch.bfloat16 for t in leaves[:6])
            else torch.float32)


def v2_pack_plain(layer_params: dict, n_head: int) -> Tuple[List[torch.Tensor],
                                                            List[torch.Tensor]]:
    """``rlmg_v2_pack``'s output in PyTorch: the head-major weights of
    ``head_major_layer_params`` as the token kernel's four matrices (qkv (D,
    3D) with columns [q_h k_h v_h] head by head, Wo (D, D), W1, W2) in
    ``pack_fragments`` order, (1, N/8, Kp/32, 32, 8), in the kernel's type,
    and its eight f32 vectors (qkv bias head-major, bo, LN1 scale and shift,
    b1, b2, LN2 scale and shift), each (1, n)."""
    wdt = _v2_kernel_dtype(v2_leaves(layer_params))
    hm = head_major_layer_params(layer_params, n_head)
    h, d, e3 = hm["qkvw"].shape
    mats = [hm["qkvw"].permute(1, 0, 2).reshape(d, h * e3), hm["wow"].reshape(d, d),
            layer_params["ffn1"]["w"], layer_params["ffn2"]["w"]]
    vecs = [hm["qkvb"].reshape(-1)] + [layer_params[a][b] for a, b in V2_LEAVES[9:]]
    return ([dk4.pack_fragments(m.to(wdt)[None]) for m in mats],
            [v.to(torch.float32).reshape(1, -1) for v in vecs])


def unpack_fragments(packed: torch.Tensor, k: int) -> torch.Tensor:
    """``pack_fragments``' inverse: (L, N/8, Kp/32, 32, 8) -> (L, K, N)."""
    L, n8, c, _, _ = packed.shape
    w = (packed.reshape(L, n8, c, 8, 4, 2, 2, 2).permute(0, 2, 5, 6, 4, 7, 1, 3)
         .reshape(L, c * 32, n8 * 8))
    return w[:, :k]


class V2Packed(NamedTuple):
    """One layer's operands of the token kernel at one batch: the four packed
    matrices, the eight f32 vectors, the row tiles' counters, their
    pointers for the C call, and d_inner."""
    mats: Tuple[torch.Tensor, ...]
    vecs: Tuple[torch.Tensor, ...]
    cnt: torch.Tensor
    wptr: ctypes.Array
    vptr: ctypes.Array
    di: int


_V2_CACHE: "collections.OrderedDict" = collections.OrderedDict()


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


def cached_layer(leaves: List[torch.Tensor], key_extra, build):
    """``build()``, kept in an LRU of ``V2_CACHE_SIZE`` entries while every
    leaf keeps its storage (the tensor it views, its address, shape and
    strides) and its version.  An entry holds weak references to the
    leaves' base tensors: a layer indexed out of a stacked leaf afresh on
    each call (``fused_decode_step``) finds it, an in-place update of a leaf
    (its version moves) builds again, and the entry goes with the weights.
    Returns (value, whether it was built)."""
    roots = [_root(t) for t in leaves]
    key = (tuple((id(r), t.data_ptr(), tuple(t.shape), t.stride(), t.dtype, t.device)
                 for r, t in zip(roots, leaves)), key_extra)
    versions = tuple(t._version for t in leaves)
    hit = _V2_CACHE.get(key)
    if hit is not None and hit[1] == versions and all(w() is r for w, r in zip(hit[0], roots)):
        _V2_CACHE.move_to_end(key)
        return hit[2], False
    _V2_CACHE.pop(key, None)
    while len(_V2_CACHE) >= V2_CACHE_SIZE:
        _V2_CACHE.popitem(last=False)
    value, tag = build(), object()

    def drop(_):
        entry = _V2_CACHE.get(key)
        if entry is not None and entry[3] is tag:
            del _V2_CACHE[key]
    _V2_CACHE[key] = ([weakref.ref(r, drop) for r in roots], versions, value, tag)
    return value, True


def _v2_pack(leaves: List[torch.Tensor], n_head: int, b: int, dev: torch.device) -> V2Packed:
    """One launch of ``rlmg_v2_pack``: the layer's operands at batch b on
    ``dev``, where every leaf must lie."""
    d, di = leaves[0].shape[0], leaves[4].shape[-1]
    shapes = [(d, d)] * 4 + [(d, di), (di, d)] + [(d,)] * 6 + [(di,)] + [(d,)] * 3
    for (a, b_), t, shp in zip(V2_LEAVES, leaves, shapes):
        if (tuple(t.shape) != shp or t.dtype not in (torch.float32, torch.bfloat16)
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"fused_layer_step_v2: {a}/{b_} {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}: expected a contiguous float32 or bfloat16 {shp} on "
                             f"{dev}")
    wdt = _v2_kernel_dtype(leaves)
    mats = tuple(torch.empty((1, n // 8, (k + 31) // 32, 32, 8), dtype=wdt, device=dev)
                 for k, n in ((d, 3 * d), (d, d), (d, di), (di, d)))
    vecs = tuple(torch.empty((1, n), dtype=torch.float32, device=dev)
                 for n in (3 * d, d, d, d, di, d, d, d))
    cnt = torch.empty((b + 15) // 16, dtype=torch.int32, device=dev)
    lib = _lib()
    src = (ctypes.c_void_p * len(leaves))(*[t.data_ptr() for t in leaves])
    mask = sum(1 << i for i, t in enumerate(leaves) if t.dtype == torch.bfloat16)
    wptr = (ctypes.c_void_p * 4)(*[t.data_ptr() for t in mats])
    vptr = (ctypes.c_void_p * 8)(*[t.data_ptr() for t in vecs])
    with torch.cuda.device(dev):
        rc = lib.rlmg_v2_pack(src, mask, wptr, vptr, cnt.data_ptr(), cnt.numel(), d, n_head,
                              di, int(wdt == torch.bfloat16),
                              torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"fused_layer_step_v2 packing: {lib.rlmg_error_string(rc).decode()}")
    return V2Packed(mats, vecs, cnt, wptr, vptr, di)


def kernel_runs_v2(reset: bool = False) -> int:
    """Runs of v2's token kernel on the current card since the last reset,
    as the kernel counts them; waits for the card."""
    n = _lib().rlmg_v2_tc_runs(int(reset))
    if n < 0:
        raise RuntimeError(f"decode_aug: {_lib().rlmg_error_string(-n).decode()}")
    return n


def fused_layer_step_v2(h: torch.Tensor, layer_params: dict, s_aug: torch.Tensor, *,
                        n_head: int, eps: float = DEFAULT_EPS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v2: ``fused_layer_step`` with head-major weights.  CUDA tensors go to
    the token kernel (``launches`` counts the calls, ``cuda_launches`` every
    CUDA launch a call issues, the packing and h's conversions included,
    ``packs`` the packings); CPU tensors take ``fused_layer_step_v2_plain``;
    any other device raises."""
    if h.device.type == "cpu":
        return fused_layer_step_v2_plain(h, layer_params, s_aug, n_head=n_head, eps=eps)
    name = "fused_layer_step_v2"
    if h.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {h.device}")
    if h.dim() != 2 or n_head < 1 or h.shape[1] % n_head:
        raise ValueError(f"{name}: h {tuple(h.shape)} with {n_head} heads; expected (B, D), "
                         "n_head dividing D")
    b, d = h.shape
    e = d // n_head
    if (tuple(s_aug.shape) != (n_head, b, e, e + 1) or s_aug.dtype != torch.float32
            or not s_aug.is_contiguous() or s_aug.device != h.device):
        raise ValueError(f"{name}: state {tuple(s_aug.shape)} {s_aug.dtype}; expected a "
                         f"contiguous float32 ({n_head}, {b}, {e}, {e + 1}) on {h.device}")
    leaves = v2_leaves(layer_params)
    lib = _lib()
    dk4.check_shape(lib.rlmg_v3_tc_shape_ok, d, n_head, leaves[4].shape[-1], name)
    work, packed = cached_layer(leaves, (n_head, b),
                                lambda: _v2_pack(leaves, n_head, b, h.device))
    launches = int(packed)
    h32 = h
    if h.dtype != torch.float32 or not h.is_contiguous() or h.data_ptr() % 16:
        h32 = torch.empty((b, d), dtype=torch.float32, device=h.device)
        h32.copy_(h)
        launches += 1
    with torch.cuda.device(h.device):
        out = torch.empty((b, d), dtype=torch.float32, device=h.device)
        scratch = torch.empty(lib.rlmg_v3_tc_scratch_floats(b, d, work.di), dtype=torch.float32,
                              device=h.device)
        launched = ctypes.c_int()
        rc = lib.rlmg_v2_tc_step(
            work.wptr, work.vptr, s_aug.data_ptr(), h32.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), work.cnt.data_ptr(), b, d, n_head, work.di, eps,
            int(work.mats[0].dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
            ctypes.byref(launched))
    if rc:
        raise RuntimeError(f"{name} kernel: {lib.rlmg_error_string(rc).decode()}")
    launches += launched.value
    if h.dtype != torch.float32:
        out = out.to(h.dtype)
        launches += 1
    fused_layer_step_v2.launches += 1
    fused_layer_step_v2.cuda_launches += launches
    fused_layer_step_v2.packs += int(packed)
    return out, s_aug


fused_layer_step.launches = fused_layer_step.cuda_launches = 0
fused_layer_step_v2.launches = fused_layer_step_v2.cuda_launches = fused_layer_step_v2.packs = 0


def fused_decode_step(params: dict, cfg, token: torch.Tensor, state: DecodeState, *,
                      pe_table: Optional[torch.Tensor] = None, variant: str = "v1"
                      ) -> Tuple[torch.Tensor, DecodeState]:
    """``lt.decode_step`` with each layer in the v1 or v2 kernel (JAX
    :220-249).  ``state.s`` is the augmented (L, H, B, E, E + 1) state,
    updated in place layer by layer (``state.z`` unused)."""
    if variant not in ("v1", "v2"):
        raise ValueError(f"variant must be 'v1' or 'v2', got {variant!r}")
    step_fn = fused_layer_step if variant == "v1" else fused_layer_step_v2
    h = embed_input(params, cfg, token, state.step, pe_table)
    for li in range(cfg.n_layer):
        lp = {k: {kk: vv[li] for kk, vv in v.items()} for k, v in params["layers"].items()}
        h, _ = step_fn(h, lp, state.s[li], n_head=cfg.n_head, eps=cfg.attn_eps)
    h = cm.layernorm(params["final_ln"], h)
    return h, DecodeState(state.s, state.z, state.step + 1)


def state_to_aug(s: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """(L, B, H, E, F), (L, B, H, E) -> (L, H, B, E, F + 1)."""
    return torch.cat([s, z[..., None]], dim=-1).transpose(1, 2).contiguous()


def aug_to_state(sa: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(L, H, B, E, F + 1) -> (L, B, H, E, F), (L, B, H, E)."""
    sb = sa.transpose(1, 2)
    return sb[..., :-1], sb[..., -1]
