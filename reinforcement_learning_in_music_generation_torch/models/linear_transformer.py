"""Causal linear-attention CP transformer: init and recurrent decode.

Counterpart of the JAX package's ``models/linear_transformer.py`` (decode
half).  Post-norm architecture (fast_transformers' TransformerEncoderLayer):

    x -> 6 scaled embeddings -> concat(1216) -> in_linear(512) -> +sinusoidal
      -> 12x [ attn -> +res -> LN1 -> gelu FFN(2048) -> +res -> LN2 ] -> LN
      -> 6 independent heads

Parameters are the JAX tree as dicts of tensors: same key paths, ``w``
stored (in, out), per-layer leaves stacked (L, ...).  The parallel
(training) forward is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..config import LinearTransformerConfig
from ..ops.linear_attention import linear_attention_step
from . import common as cm


def init_params(cfg: LinearTransformerConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None,
                device="cuda") -> dict:
    """Random parameters with the JAX ``init_params`` shapes and
    distributions (not its values: the RNG streams differ)."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    kw = dict(generator=generator, device=device)
    d, L = cfg.d_model, cfg.n_layer
    layers = {name: cm.init_linear(d, d, stack=(L,), **kw)
              for name in ("wq", "wk", "wv", "wo")}
    layers["ln1"] = cm.init_layernorm(d, device=device, stack=(L,))
    layers["ln2"] = cm.init_layernorm(d, device=device, stack=(L,))
    layers["ffn1"] = cm.init_linear(d, cfg.d_inner, stack=(L,), **kw)
    layers["ffn2"] = cm.init_linear(cfg.d_inner, d, stack=(L,), **kw)
    params = {
        "emb": cm.init_field_embeddings(cfg.vocab_sizes, cfg.emb_sizes, **kw),
        "in_linear": cm.init_linear(sum(cfg.emb_sizes), d, **kw),
        "layers": layers,
        "final_ln": cm.init_layernorm(d, device=device),
        "heads": cm.init_field_heads(d, cfg.vocab_sizes, **kw),
    }
    if cfg.with_value_head:
        params["value_head"] = {"l1": cm.init_linear(d, 128, **kw),
                                "l2": cm.init_linear(128, 1, **kw)}
    return params


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Every floating leaf cast to ``dtype``."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


def forward_output(params: dict, cfg: LinearTransformerConfig,
                   h: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """h -> tuple of per-field logits (dqn_policy/model.py:241-249)."""
    return cm.apply_field_heads(params["heads"], h, cfg.n_fields)


def make_decode_params(params: dict, cfg: LinearTransformerConfig,
                       dtype: Optional[torch.dtype] = None) -> dict:
    """Decode layout: qkv projections fused into one (L, D, 3D) product,
    the six heads into one (D, sum V) product.  Every leaf contiguous."""
    lp = params["layers"]
    names = cm.field_names(cfg.n_fields)
    dp = {
        "emb": params["emb"],
        "in_linear": params["in_linear"],
        "final_ln": params["final_ln"],
        "qkv_w": torch.cat([lp["wq"]["w"], lp["wk"]["w"], lp["wv"]["w"]], dim=-1),
        "qkv_b": torch.cat([lp["wq"]["b"], lp["wk"]["b"], lp["wv"]["b"]], dim=-1),
        "wo": lp["wo"], "ln1": lp["ln1"], "ln2": lp["ln2"],
        "ffn1": lp["ffn1"], "ffn2": lp["ffn2"],
        "head_w": torch.cat([params["heads"][n]["w"] for n in names], dim=-1),
        "head_b": torch.cat([params["heads"][n]["b"] for n in names], dim=-1),
    }
    if dtype is not None:
        dp = cast_params(dp, dtype)

    def contig(t):
        return {k: contig(v) for k, v in t.items()} if isinstance(t, dict) else t.contiguous()
    return contig(dp)


def fused_logits(dparams: dict, cfg: LinearTransformerConfig,
                 h: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """One product for all six heads, split per field."""
    all_logits = h @ dparams["head_w"] + dparams["head_b"]
    return tuple(torch.split(all_logits, list(cfg.vocab_sizes), dim=-1))


class DecodeState(NamedTuple):
    s: torch.Tensor    # (L, B, H, Dh, Dh) running sum phi(k) v^T per layer
    z: torch.Tensor    # (L, B, H, Dh)
    step: int          # absolute position (row of the positional table)


def init_decode_state(cfg: LinearTransformerConfig, batch: int,
                      dtype=torch.float32, device="cuda") -> DecodeState:
    dh = cfg.d_head
    return DecodeState(
        s=torch.zeros((cfg.n_layer, batch, cfg.n_head, dh, dh), dtype=dtype, device=device),
        z=torch.zeros((cfg.n_layer, batch, cfg.n_head, dh), dtype=dtype, device=device),
        step=0)


def embed_input(params: dict, cfg: LinearTransformerConfig, token: torch.Tensor,
                step: int, pe_table: Optional[torch.Tensor]) -> torch.Tensor:
    """Token (B, n_fields) -> in_linear(embeddings) + pe row ``step``."""
    embs = cm.embed_fields(params["emb"], token)
    h = cm.linear(params["in_linear"], embs)
    if pe_table is None:
        pe_table = cm.sinusoidal_table(cfg.max_len, cfg.d_model, h.dtype, h.device)
    return h + pe_table[step].to(h.dtype)


def decode_step(params: dict, cfg: LinearTransformerConfig, token: torch.Tensor,
                state: DecodeState, *, pe_table: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
    """One-token forward: token (B, n_fields) int -> (h_last (B, D), state').

    The plain recurrent path (fast_transformers' recurrent mode,
    dqn_policy/model.py:236-238).  q/k/v are cast to the state dtype before
    the state update, as in the JAX function."""
    b = token.shape[0]
    h = embed_input(params, cfg, token, state.step, pe_table)
    lp = params["layers"]
    new_s, new_z = [], []
    shape = (b, cfg.n_head, cfg.d_head)
    for l in range(cfg.n_layer):
        layer = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in lp.items()}
        s_l, z_l = state.s[l], state.z[l]
        q = cm.linear(layer["wq"], h).reshape(shape).to(s_l.dtype)
        k = cm.linear(layer["wk"], h).reshape(shape).to(s_l.dtype)
        v = cm.linear(layer["wv"], h).reshape(shape).to(s_l.dtype)
        att, (s_l, z_l) = linear_attention_step(q, k, v, (s_l, z_l), eps=cfg.attn_eps)
        att = cm.linear(layer["wo"], att.to(h.dtype).reshape(b, cfg.d_model))
        h = cm.layernorm(layer["ln1"], h + att)
        y = torch.nn.functional.gelu(cm.linear(layer["ffn1"], h), approximate="none")
        y = cm.linear(layer["ffn2"], y)
        h = cm.layernorm(layer["ln2"], h + y)
        new_s.append(s_l)
        new_z.append(z_l)
    h = cm.layernorm(params["final_ln"], h)
    return h, DecodeState(torch.stack(new_s), torch.stack(new_z), state.step + 1)
