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

Kernel: ``csrc/decode_aug.cu``, the v3 kernel's source
(``ops/decode_kernel_v3.py``) run for one layer: 9 CUDA launches a call for
v1, 2 H + 7 for v2.  ``fused_decode_step`` loops it over the layers (JAX
:220-249), which only tests and ``chip_smoke.py`` call, as in the JAX
package.

Each variant launches the kernel for CUDA tensors and runs its plain twin
(``fused_layer_step_plain``, ``fused_layer_step_v2_plain``) for CPU
tensors; any other device raises.  All of them update the state in place.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ...models import common as cm
from ...models.linear_transformer import DecodeState, embed_input
from ..decode_common import gelu_tanh, ln, phi
from ..decode_kernel_v3 import aug_attention_plain, init_aug_state, run_aug
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


def _layer_call(variant: str, h: torch.Tensor, layer_params: dict, s_aug: torch.Tensor,
                n_head: int, eps: float, wrapper) -> Tuple[torch.Tensor, torch.Tensor]:
    ws = (_v1_weights(layer_params) if variant == "v1"
          else _v2_weights(layer_params, n_head))
    out, n = run_aug(ws, h.float().contiguous(), s_aug[None], n_head=n_head, eps=eps,
                     head_major=variant == "v2", bias_last=variant == "v2",
                     name=f"fused_layer_step ({variant})")
    wrapper.launches += 1
    wrapper.cuda_launches += n
    return out.to(h.dtype), s_aug


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
    return _layer_call("v1", h, layer_params, s_aug, n_head, eps, fused_layer_step)


def fused_layer_step_v2(h: torch.Tensor, layer_params: dict, s_aug: torch.Tensor, *,
                        n_head: int, eps: float = DEFAULT_EPS
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """v2: ``fused_layer_step`` with head-major weights (built per call, as
    the JAX function does).  CPU tensors take ``fused_layer_step_v2_plain``."""
    if h.device.type == "cpu":
        return fused_layer_step_v2_plain(h, layer_params, s_aug, n_head=n_head, eps=eps)
    return _layer_call("v2", h, layer_params, s_aug, n_head, eps, fused_layer_step_v2)


fused_layer_step.launches = fused_layer_step.cuda_launches = 0
fused_layer_step_v2.launches = fused_layer_step_v2.cuda_launches = 0


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
