"""Causal linear-attention CP transformer: init, the parallel (training)
forward and the recurrent decode.

Counterpart of the JAX package's ``models/linear_transformer.py``.
Post-norm architecture (fast_transformers' TransformerEncoderLayer):

    x -> 6 scaled embeddings -> concat(1216) -> in_linear(512) -> +sinusoidal
      -> 12x [ attn -> +res -> LN1 -> gelu FFN(2048) -> +res -> LN2 ] -> LN
      -> 6 independent heads

Parameters are the JAX tree as dicts of tensors: same key paths, ``w``
stored (in, out), per-layer leaves stacked (L, ...).  The training forward
picks its route per layer as the JAX package does (``_ffn_backend``): on a
CUDA device at ``RLMG_FFN_MIN_ROWS`` (8192) rows or more, kernel C
(``ops/attention_block.py``) and kernel D (``ops/ffn_block.py``); otherwise
the plain PyTorch composition.  Under a data-parallel mesh (``dp_mesh``,
``parallel/mesh.py``) each rank runs its own rows: the rule reads the rank's
row count, kernel C runs on the rank's own sequences, kernel D's dropout
seed gets ``7919 * dp_index`` added (the JAX rule), and the loss is the
global masked CE (``ops/losses.py``).  Under a mesh with tp > 1 each rank
holds its tp shard of the Megatron-split weights (``parallel/sharding.py``)
and runs JAX's manual Megatron layer (``parallel/pipeline.py
_layer_forward_tp``): each field's embedding columns and ``in_linear``'s
output gathered, q/k/v of its n_head/tp heads, ``wo`` and ``ffn2``
row-parallel with one all-reduce each and their biases added once after
it, the heads row-parallel over d_model; the activations between them
replicated (``parallel/tensor.py``).  C, D and G do not run under tp (the
JAX guards, with their warnings); the attention is
``causal_linear_attention`` on the rank's heads, kernel F under
``RLMG_ATTN_BACKEND=pallas``.  An explicit ``RLMG_ATTN_BACKEND=pallas`` (or
``cfg.attn_backend``) takes the unfused layer at any row count, with kernel
F (``ops/linear_attention_kernel.py``) as its attention; an explicit
``RLMG_FFN_BACKEND=pallas`` runs the unfused layer's post-LN1 half through
kernel G (``ops/ffn_block.py ffn_block``) at any row count.  The parallel
prompt prefill (``forward_prefill``) returns the recurrent decode state of
a prompt in one training-style pass.  ``cfg.remat`` runs each layer under
``torch.utils.checkpoint`` (JAX's per-layer ``jax.checkpoint``): the
backward recomputes the layer from its input, with the same dropout masks
and kernel seeds (``_remat_layer``).
"""

from __future__ import annotations

import os
import warnings
from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.utils.checkpoint

from ..config import LinearTransformerConfig
from ..ops.attention_block import qkv_attention_block
from ..ops.ffn_block import attn_tail_block, ffn_block
from ..ops.linear_attention import (causal_linear_attention,
                                    causal_linear_attention_bshe, feature_map,
                                    linear_attention_step)
from ..ops.losses import fields_cross_entropy
from ..parallel.tensor import (copy_to_tp, gather_fields_from_tp, gather_from_tp,
                               reduce_from_tp, scatter_to_tp)
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


def n_params(params: dict) -> int:
    """Trainable parameter count (dqn_policy/model.py:61-65 network_paras)."""
    if isinstance(params, dict):
        return sum(n_params(v) for v in params.values())
    return params.numel()


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """Every floating leaf cast to ``dtype``."""
    if isinstance(params, dict):
        return {k: cast_params(v, dtype) for k, v in params.items()}
    return params.to(dtype) if params.is_floating_point() else params


# -- parallel (training) mode ---------------------------------------------------

_FFN_BACKENDS = ("xla", "pallas-tail", "pallas")


def _split_heads(x: torch.Tensor, n_head: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, n_head, d // n_head).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, dh = x.shape
    return x.transpose(1, 2).reshape(b, s, h * dh)


def _ffn_min_rows() -> int:
    """Rows below which the fused route falls back to the composition
    (RLMG_FFN_MIN_ROWS, default 8192, as in the JAX package)."""
    return int(os.environ.get("RLMG_FFN_MIN_ROWS", "8192"))


def _mesh_axes(dp_mesh) -> Tuple[int, int]:
    """(dp, tp) of a mesh, (1, 1) without one."""
    if dp_mesh is None:
        return 1, 1
    return dp_mesh.shape.get("dp", 1), dp_mesh.shape.get("tp", 1)


def check_tp(cfg: LinearTransformerConfig, tp: int) -> None:
    """Raise ``ValueError`` unless ``tp`` divides every dimension the
    Megatron rules split: the heads, d_inner, d_model and each field's
    embedding (JAX ``parallel/pipeline.py:169-172`` for the first two)."""
    if tp == 1:
        return
    sizes = {"n_head": cfg.n_head, "d_inner": cfg.d_inner, "d_model": cfg.d_model,
             **{f"emb_sizes[{i}]": e for i, e in enumerate(cfg.emb_sizes)}}
    bad = {k: v for k, v in sizes.items() if v % tp}
    if bad:
        raise ValueError(f"tp={tp} must divide {bad} (Megatron shards: whole heads, FFN "
                         "columns, d_model rows of the heads and embedding columns)")


def _row_linear(p: dict, x: torch.Tensor, mesh) -> torch.Tensor:
    """A row-parallel product under tp: the rank's rows of ``p["w"]``
    times its columns of x, summed over the tp ranks, then the (whole) bias
    once; ``cm.linear`` without tp."""
    if _mesh_axes(mesh)[1] == 1:
        return cm.linear(p, x)
    return reduce_from_tp(x @ p["w"], mesh) + p["b"]


def embed_project(params: dict, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x (..., n_fields) int -> in_linear(concat of the scaled embeddings),
    (..., d_model).  Under tp the rank's columns of each field's embedding
    are gathered field by field into the whole concat, ``in_linear`` runs
    column-parallel and its columns are gathered: h comes out replicated."""
    tp = _mesh_axes(mesh)[1]
    if tp == 1:
        return cm.linear(params["in_linear"], cm.embed_fields(params["emb"], x))
    names = cm.field_names(x.shape[-1])
    e = gather_fields_from_tp(cm.embed_fields(params["emb"], x, tp), mesh,
                              [params["emb"][n].shape[-1] for n in names])
    return gather_from_tp(cm.linear(params["in_linear"], copy_to_tp(e, mesh)), mesh)


def _ffn_backend(n_rows: int, device: torch.device, dp_mesh=None) -> str:
    """FFN-tail route of the training forward: "pallas-tail" runs kernel D
    (Wo + dropout + residual + LN1 + FFN + LN2, ``ops/ffn_block.py``),
    "xla" the plain PyTorch composition, "pallas" kernel G (the post-LN1
    FFN + LN2, ``ops/ffn_block.py ffn_block``).  RLMG_FFN_BACKEND overrides,
    except under tp > 1, which always takes "xla" (with a warning: the fused
    LN would normalize ffn2's partial sums).

    Default: the JAX rule with "the tensors are on a CUDA device" in place
    of "the default backend is a TPU": "pallas-tail" at ``_ffn_min_rows()``
    rows or more on a CUDA device, else "xla".  ``n_rows`` is the rows the
    kernel would see: under a dp mesh this rank's, JAX's per-shard
    ``n_rows // dp`` (the rank holds its 1/dp share of the batch)."""
    tp = _mesh_axes(dp_mesh)[1]
    v = os.environ.get("RLMG_FFN_BACKEND")
    if v:
        if v not in _FFN_BACKENDS:
            raise ValueError(f"RLMG_FFN_BACKEND={v!r}: expected one of {_FFN_BACKENDS}")
        if v in ("pallas", "pallas-tail") and tp > 1:
            warnings.warn(f"RLMG_FFN_BACKEND={v} ignored under tp={tp}: the fused LN would "
                          "normalize ffn2's partial sums; the composition instead")
            return "xla"
        return v
    if device.type == "cuda" and tp == 1 and n_rows >= _ffn_min_rows():
        return "pallas-tail"
    return "xla"


def _qkv_attention_call(cfg: LinearTransformerConfig, lp: dict, h: torch.Tensor,
                        dp_mesh=None) -> Optional[torch.Tensor]:
    """Kernel C (``ops/attention_block.py``) for (b, s, d) ``h``, this
    rank's sequences under a dp mesh, or None where it does not serve the
    configuration and the caller takes the composition: the JAX rule (2-D
    h, odd head count, tp > 1 with a warning, dp not dividing b, sequence
    length not a multiple of the chunk).  A head layout the kernel does not
    take raises there.  JAX reads b on the global batch; here b is the
    rank's: the same for a batch kept whole (dp does not divide it), while
    a sharded batch whose per-rank share dp does not divide takes the
    composition here where JAX takes C (the same function, up to
    rounding)."""
    if h.ndim != 3 or cfg.n_head % 2 != 0:
        return None
    b, s, d = h.shape
    dp, tp = _mesh_axes(dp_mesh)
    if tp > 1:
        warnings.warn("attention backend pallas-qkv ignored under tp > 1: the qkv projections "
                      "are tensor-sharded; the composition instead")
        return None
    if dp > 1 and b % dp != 0:
        return None
    chunk = min(cfg.attn_chunk, s)
    if s % chunk != 0:
        return None
    wqkv = torch.cat([lp["wq"]["w"], lp["wk"]["w"], lp["wv"]["w"]], dim=-1)
    bqkv = torch.cat([lp["wq"]["b"], lp["wk"]["b"], lp["wv"]["b"]])
    att = qkv_attention_block(h.reshape(b * s, d), wqkv, bqkv, b, cfg.n_head, chunk=chunk,
                              eps=cfg.attn_eps)
    return att.reshape(b, s, d)


def _dropout_seed(generator: Optional[torch.Generator], p: float, device, dp_mesh=None):
    """A fused kernel's dropout seed: drawn from ``generator`` when p > 0,
    else 0 (no generator means no dropout, not dropout with a fixed seed).
    Under a dp mesh the ranks of dp index i add 7919 i (JAX's
    ``axis_index("dp") * 7919``): the kernels draw their masks by row, and
    the rows restart at 0 on every dp index."""
    if p <= 0.0:
        return 0
    seed = torch.randint(0, 2 ** 30, (), generator=generator, device=generator.device,
                         dtype=torch.int32)
    if _mesh_axes(dp_mesh)[0] > 1:
        seed = seed + 7919 * dp_mesh.dp_index
    return seed.to(device, non_blocking=True)


def _layer_forward(cfg: LinearTransformerConfig, h: torch.Tensor, lp: dict,
                   generator: Optional[torch.Generator], deterministic: bool,
                   attn_backend: Optional[str], dp_mesh=None,
                   rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    # an explicitly requested attention backend (argument, config or env)
    # is not dropped by the fused route, whose attention is the head-minor
    # composition or kernel C; "xla" and None are compatible with it
    explicit_attn = attn_backend or cfg.attn_backend or os.environ.get("RLMG_ATTN_BACKEND")
    fused_ok = explicit_attn in (None, "", "xla", "pallas-qkv")
    if h.ndim == 3 and fused_ok and _ffn_backend(h.shape[0] * h.shape[1], h.device,
                                                 dp_mesh) == "pallas-tail":
        b, s, d = h.shape
        att = None
        if explicit_attn in ("pallas-qkv", None, ""):
            att = _qkv_attention_call(cfg, lp, h, dp_mesh)
        if att is None:
            bshe = lambda x: x.reshape(b, s, cfg.n_head, cfg.d_head)
            att = causal_linear_attention_bshe(
                bshe(cm.linear(lp["wq"], h)), bshe(cm.linear(lp["wk"], h)),
                bshe(cm.linear(lp["wv"], h)), eps=cfg.attn_eps, chunk=cfg.attn_chunk)
        p = 0.0 if (deterministic or generator is None) else cfg.dropout
        seed = _dropout_seed(generator, p, h.device, dp_mesh)
        out = attn_tail_block(h.reshape(b * s, d), att.reshape(b * s, d).contiguous(),
                              lp["wo"]["w"], lp["wo"]["b"], lp["ln1"]["scale"],
                              lp["ln1"]["bias"], lp["ffn1"]["w"], lp["ffn1"]["b"],
                              lp["ffn2"]["w"], lp["ffn2"]["b"], lp["ln2"]["scale"],
                              lp["ln2"]["bias"], seed, p)
        return out.reshape(b, s, d)
    att = None
    if explicit_attn == "pallas-qkv":
        att = _qkv_attention_call(cfg, lp, h, dp_mesh)
    tp = _mesh_axes(dp_mesh)[1]
    if att is None:
        # under tp: the rank's n_head / tp heads, column-parallel
        hc = copy_to_tp(h, dp_mesh)
        q = _split_heads(cm.linear(lp["wq"], hc), cfg.n_head // tp)
        k = _split_heads(cm.linear(lp["wk"], hc), cfg.n_head // tp)
        v = _split_heads(cm.linear(lp["wv"], hc), cfg.n_head // tp)
        ca_backend = attn_backend or cfg.attn_backend
        if ca_backend == "pallas-qkv":      # odd heads / 2-D h / tp: the composition
            ca_backend = "xla"
        att = _merge_heads(causal_linear_attention(q, k, v, eps=cfg.attn_eps,
                                                   backend=ca_backend, chunk=cfg.attn_chunk))
    att = _row_linear(lp["wo"], att, dp_mesh)
    h = cm.layernorm(lp["ln1"], h + cm.dropout(generator, att, cfg.dropout, deterministic,
                                               rows=rows))
    if h.ndim == 3 and _ffn_backend(h.shape[0] * h.shape[1], h.device, dp_mesh) == "pallas":
        b, s, d = h.shape
        p = 0.0 if (deterministic or generator is None) else cfg.dropout
        out = ffn_block(h.reshape(b * s, d), lp["ffn1"]["w"], lp["ffn1"]["b"], lp["ffn2"]["w"],
                        lp["ffn2"]["b"], lp["ln2"]["scale"], lp["ln2"]["bias"],
                        _dropout_seed(generator, p, h.device, dp_mesh), p)
        return out.reshape(b, s, d)
    y = torch.nn.functional.gelu(cm.linear(lp["ffn1"], copy_to_tp(h, dp_mesh)),
                                 approximate="none")
    # the rank's columns of the one-process mask: the tp ranks' generators
    # stay in step
    y = cm.dropout(generator, y, cfg.dropout, deterministic,
                   shard=(dp_mesh.tp_index, tp) if tp > 1 else (0, 1), rows=rows)
    y = _row_linear(lp["ffn2"], y, dp_mesh)
    y = cm.dropout(generator, y, cfg.dropout, deterministic, rows=rows)
    return cm.layernorm(lp["ln2"], h + y)


def _remat_layer(cfg: LinearTransformerConfig, h: torch.Tensor, lp: dict,
                 generator: Optional[torch.Generator], deterministic: bool,
                 attn_backend: Optional[str], dp_mesh=None,
                 rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """``_layer_forward`` under ``torch.utils.checkpoint`` (JAX ``cfg.remat``:
    ``jax.checkpoint`` around each layer): the backward keeps only the
    layer's input and runs the layer again.  The layer's randomness (the
    dropout masks and the fused kernels' seeds, all drawn from
    ``generator``) replays: the first run draws from ``generator`` as the
    layer does without remat, the recompute from a generator of its own set
    to ``generator``'s state before the layer, so it draws the same values
    and the caller's generator ends where it would without remat.  The
    kernels' forward counters count the recompute too: two forward calls
    a layer and step."""
    state = None if generator is None else generator.get_state()
    runs = []

    def run(h_: torch.Tensor, lp_: dict) -> torch.Tensor:
        gen = generator
        if runs and generator is not None:          # the recompute: replay the draws
            gen = torch.Generator(device=generator.device)
            gen.set_state(state)
        runs.append(1)
        return _layer_forward(cfg, h_, lp_, gen, deterministic, attn_backend, dp_mesh, rows)

    return torch.utils.checkpoint.checkpoint(run, h, lp, use_reentrant=False)


def forward_hidden(params: dict, cfg: LinearTransformerConfig, x: torch.Tensor, *,
                   deterministic: bool = True, generator: Optional[torch.Generator] = None,
                   attn_backend: Optional[str] = None, dp_mesh=None,
                   rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """x (B, S, n_fields) int -> h (B, S, D) (dqn_policy/model.py:200-233:
    embeddings -> in_linear -> positional encoding -> causal-linear
    encoder).  ``generator`` (on the tensors' device) draws the dropout
    masks and the kernels' dropout seeds; None means no dropout.
    ``dp_mesh``: x is this rank's rows of a batch over the mesh's dp, and
    under tp > 1 ``params`` the rank's tp shards; h comes out replicated
    over the tp group.  ``rows`` = (j, m): x is the j-th of m row blocks
    of the batch (``parallel/mesh.py row_block``), and the composition's
    dropout masks are the whole batch's draw at those rows, so that a
    generator seeded alike on every rank stays in step (the fused kernels'
    seeds keep JAX's dp rule, ``_dropout_seed``); (0, 1): x is the batch
    the generator draws for."""
    check_tp(cfg, _mesh_axes(dp_mesh)[1])
    deterministic = deterministic or generator is None
    s = x.shape[1]
    h = embed_project(params, x, dp_mesh)
    h = h + cm.sinusoidal_table(s, cfg.d_model, h.dtype, h.device)[None]
    h = cm.dropout(generator, h, cfg.dropout, deterministic, rows=rows)
    layers = params["layers"]
    layer = _remat_layer if cfg.remat and torch.is_grad_enabled() else _layer_forward
    for l in range(cfg.n_layer):
        lp = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in layers.items()}
        h = layer(cfg, h, lp, generator, deterministic, attn_backend, dp_mesh, rows)
    return cm.layernorm(params["final_ln"], h)


def forward_output(params: dict, cfg: LinearTransformerConfig, h: torch.Tensor,
                   mesh=None) -> Tuple[torch.Tensor, ...]:
    """h -> tuple of per-field logits (dqn_policy/model.py:241-249).  Under
    tp the heads are row-parallel over d_model (``head_logits``)."""
    if _mesh_axes(mesh)[1] == 1:
        return cm.apply_field_heads(params["heads"], h, cfg.n_fields)
    return tuple(torch.split(head_logits(params, cfg, h, mesh), list(cfg.vocab_sizes), dim=-1))


def head_logits(params: dict, cfg: LinearTransformerConfig, h: torch.Tensor,
                mesh=None) -> torch.Tensor:
    """The six heads' logits side by side, (..., sum V), in field order.
    Under tp: the rank's d_model columns of the replicated h times its rows
    of each head's ``w``, the six partial products summed over the tp ranks
    in one all-reduce, then the biases."""
    hw, hb = cm.fused_head_params(params["heads"], cfg.n_fields)
    if _mesh_axes(mesh)[1] == 1:
        return h @ hw + hb
    return reduce_from_tp(scatter_to_tp(h, mesh) @ hw, mesh) + hb


def value_head(params: dict, h: torch.Tensor) -> torch.Tensor:
    """PPO actor value head (ppo_policy/model.py:154-158): D -> 128 -> relu
    -> 1, returning (...,)."""
    y = torch.relu(cm.linear(params["value_head"]["l1"], h))
    return cm.linear_scalar(params["value_head"]["l2"], y)


def train_losses(params: dict, cfg: LinearTransformerConfig, x: torch.Tensor,
                 target: torch.Tensor, mask: torch.Tensor, *, deterministic: bool = False,
                 generator: Optional[torch.Generator] = None,
                 attn_backend: Optional[str] = None, dp_mesh=None,
                 rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Per-field masked CE (n_fields,), as LinearTransformer.train_step
    (dqn_policy/model.py:170-197); under a dp mesh this rank's share of the
    global losses (``ops/losses.py``), which the caller all-reduces.
    ``rows``: as ``forward_hidden``'s."""
    h = forward_hidden(params, cfg, x, deterministic=deterministic, generator=generator,
                       attn_backend=attn_backend, dp_mesh=dp_mesh, rows=rows)
    return fields_cross_entropy(forward_output(params, cfg, h, dp_mesh), target, mask,
                                mesh=dp_mesh)


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
    step: Union[int, torch.Tensor]   # absolute position (row of the positional
                                     # table): an int, or a (B,) tensor, one a song


def init_decode_state(cfg: LinearTransformerConfig, batch: int,
                      dtype=torch.float32, device="cuda", mesh=None) -> DecodeState:
    """A zero state; under tp of the rank's n_head / tp heads."""
    dh, h = cfg.d_head, cfg.n_head // _mesh_axes(mesh)[1]
    return DecodeState(
        s=torch.zeros((cfg.n_layer, batch, h, dh, dh), dtype=dtype, device=device),
        z=torch.zeros((cfg.n_layer, batch, h, dh), dtype=dtype, device=device),
        step=0)


def embed_input(params: dict, cfg: LinearTransformerConfig, token: torch.Tensor,
                step: Union[int, torch.Tensor], pe_table: Optional[torch.Tensor],
                mesh=None) -> torch.Tensor:
    """Token (B, n_fields) -> in_linear(embeddings) + pe row ``step``.
    ``step``: a Python int, a 0-d integer tensor on the table's device, or a
    (B,) one, a position per song (the JAX ``pe_table[state.step]`` gather,
    which continuous batching uses: each slot at its own position).  A
    tensor's rows are gathered on the device, with no host sync: a CUDA
    graph replays the gather at whatever positions the tensor holds.
    ``mesh``: tp shards in, h replicated out (``embed_project``)."""
    h = embed_project(params, token, mesh)
    if pe_table is None:
        pe_table = cm.sinusoidal_table(cfg.max_len, cfg.d_model, h.dtype, h.device)
    row = pe_table.index_select(0, step.reshape(-1)) if torch.is_tensor(step) \
        else pe_table[step]
    return h + row.to(h.dtype)


def decode_step(params: dict, cfg: LinearTransformerConfig, token: torch.Tensor,
                state: DecodeState, *, pe_table: Optional[torch.Tensor] = None,
                mesh=None) -> Tuple[torch.Tensor, DecodeState]:
    """One-token forward: token (B, n_fields) int -> (h_last (B, D), state').

    The plain recurrent path (fast_transformers' recurrent mode,
    dqn_policy/model.py:236-238).  q/k/v are cast to the state dtype before
    the state update, as in the JAX function.  Under tp (``mesh``) the
    per-token Megatron layer on the rank's shards: the state holds the
    rank's n_head / tp heads, h is replicated.  No gradient flows here, so
    the column-parallel products need no ``copy_to_tp``."""
    tp = _mesh_axes(mesh)[1]
    b = token.shape[0]
    h = embed_input(params, cfg, token, state.step, pe_table, mesh)
    lp = params["layers"]
    new_s, new_z = [], []
    shape = (b, cfg.n_head // tp, cfg.d_head)
    for l in range(cfg.n_layer):
        layer = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in lp.items()}
        s_l, z_l = state.s[l], state.z[l]
        q = cm.linear(layer["wq"], h).reshape(shape).to(s_l.dtype)
        k = cm.linear(layer["wk"], h).reshape(shape).to(s_l.dtype)
        v = cm.linear(layer["wv"], h).reshape(shape).to(s_l.dtype)
        att, (s_l, z_l) = linear_attention_step(q, k, v, (s_l, z_l), eps=cfg.attn_eps)
        att = _row_linear(layer["wo"], att.to(h.dtype).reshape(b, cfg.d_model // tp), mesh)
        h = cm.layernorm(layer["ln1"], h + att)
        y = torch.nn.functional.gelu(cm.linear(layer["ffn1"], h), approximate="none")
        y = _row_linear(layer["ffn2"], y, mesh)
        h = cm.layernorm(layer["ln2"], h + y)
        new_s.append(s_l)
        new_z.append(z_l)
    h = cm.layernorm(params["final_ln"], h)
    return h, DecodeState(torch.stack(new_s), torch.stack(new_z), state.step + 1)


def prefill_bucket(t: int, quantum: int = 64) -> int:
    """Padded prompt length for ``forward_prefill``: the next multiple of
    ``quantum`` (the JAX function, :585), so prompts of varied lengths share
    one padded shape."""
    return max(quantum, -(-t // quantum) * quantum)


def forward_prefill(params: dict, cfg: LinearTransformerConfig, x: torch.Tensor,
                    n_valid: Optional[int] = None, *,
                    pe_table: Optional[torch.Tensor] = None,
                    state_dtype: torch.dtype = torch.float32, mesh=None
                    ) -> Tuple[torch.Tensor, DecodeState]:
    """Parallel prompt ingestion (JAX :593-646): one training-style forward
    over the prompt that also returns the recurrent state after its last
    valid token, the closed form of scanning ``decode_step`` over it,

        S_l = sum_t phi(k_t) v_t^T,   z_l = sum_t phi(k_t).

    x (B, T, n_fields) int, T possibly padded (``prefill_bucket``);
    ``n_valid`` (default T) is the prompt's true length: positions >=
    n_valid add nothing to the state, and h_last is read at n_valid - 1.
    The state sums in ``state_dtype`` (f32) whatever the weights' type.
    The attention is the chunked ``causal_linear_attention_bshe`` core on
    every backend, as JAX's; its summation order differs from the
    per-token scan, so streams are float-close, not bit-equal.

    Under tp (``mesh``) the Megatron layer of ``decode_step`` on the
    rank's shards; the state holds its n_head / tp heads.

    Returns (h_last (B, D) after final_ln, DecodeState at step n_valid)."""
    tp = _mesh_axes(mesh)[1]
    b, t, _ = x.shape
    n_valid = t if n_valid is None else int(n_valid)
    valid = (torch.arange(t, device=x.device) < n_valid)[None, :, None, None]
    h = embed_project(params, x, mesh)
    if pe_table is None:
        pe_table = cm.sinusoidal_table(cfg.max_len, cfg.d_model, h.dtype, h.device)
    h = h + pe_table[:t][None].to(h.dtype)
    ss, zs = [], []
    for l in range(cfg.n_layer):
        lp = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in params["layers"].items()}
        bshe = lambda a: a.reshape(b, t, cfg.n_head // tp, cfg.d_head)
        q, k, v = (bshe(cm.linear(lp[n], h)) for n in ("wq", "wk", "wv"))
        pk = feature_map(k.to(state_dtype)) * valid
        ss.append(torch.einsum("bthe,bthf->bhef", pk, v.to(state_dtype)))
        zs.append(pk.sum(1))
        att = causal_linear_attention_bshe(q, k, v, eps=cfg.attn_eps,
                                           chunk=min(cfg.attn_chunk, t))
        att = _row_linear(lp["wo"], att.reshape(b, t, cfg.d_model // tp), mesh)
        h = cm.layernorm(lp["ln1"], h + att)
        y = torch.nn.functional.gelu(cm.linear(lp["ffn1"], h), approximate="none")
        h = cm.layernorm(lp["ln2"], h + _row_linear(lp["ffn2"], y, mesh))
    h_last = cm.layernorm(params["final_ln"], h[:, n_valid - 1])
    return h_last, DecodeState(torch.stack(ss), torch.stack(zs), n_valid)
