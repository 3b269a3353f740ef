"""Sliding-window ("Longformer"-style) CP-token encoders: the counterpart of
the JAX package's ``models/longformer.py``.

One parameterized family for the reference's three HF LongformerModel
variants: the AIRL discriminator (10 layers, window 50, score head), the
PPO reward model (12 layers, window 512, per-field scalar eval heads) and
the discrim-pretrain LM (12 layers, window 512, 7 fields).

Trunk: CP field embeddings -> proj(d_model) -> + learned absolute positions
-> LN -> N x [window attention -> Wo -> add & LN -> gelu FFN -> add & LN],
the BERT post-norm layout HF uses.  Parameters are the JAX tree as dicts of
tensors (same key paths, ``w`` stored (in, out), per-layer leaves stacked
(L, ...)); the score head's BatchNorm running stats are a separate state
dict, as in JAX.

A layer takes one of two routes, by the JAX rule:
  * fused tail: when RLMG_WINDOW_BACKEND is not "pallas" and
    ``linear_transformer._ffn_backend`` says "pallas-tail" (a CUDA device at
    RLMG_FFN_MIN_ROWS = 8192 rows or more, or the RLMG_FFN_BACKEND
    override), the head-minor window attention
    (``ops/window_attention.py window_attention_bshe``) and kernel D
    (``ops/ffn_block.py attn_tail_block`` with ``mid_drop=False``: this
    layer has no dropout after the gelu);
  * plain: the PyTorch Wo / LN / FFN composition around
    ``ops/window_attention.py window_attention``, which takes kernel E for
    long sequences under RLMG_WINDOW_BACKEND=pallas.
Dropout is drawn from an explicit ``torch.Generator`` on the tensors'
device; no generator means no dropout.

Under a mesh with tp > 1 (``mesh``, ``parallel/mesh.py``) each rank holds
its tp shard of the leaves the Megatron rules split (``emb``, ``proj``,
the layers' q/k/v, ``wo``, ``ffn1``, ``ffn2`` and the token ``heads``;
``parallel/sharding.py``) and runs the Megatron layer of the agent's
(``models/linear_transformer.py``): each field's embedding columns
gathered field by field, ``proj`` column-parallel and gathered before the
positions and ``emb_ln``, q/k/v of the rank's n_head / tp heads (kernel E
under RLMG_WINDOW_BACKEND=pallas on those heads), ``wo`` and ``ffn2``
row-parallel with one all-reduce each and their biases once, the token
heads row-parallel over d_model.  The activations between them, and so
both dropouts' inputs, are replicated: every tp rank draws the same masks
from the same generator state.  The score head, its BatchNorm and the eval
heads read the replicated h with their whole weights.  Under tp the fused
tail does not run (``_ffn_backend``'s guard, with its warning).

A batch split over dp (``rows`` = (j, m): the input is the j-th of m equal
row blocks of the batch, a dp rank's rows; ``rl/airl.py``'s split
discriminator epoch) draws the whole batch's dropout masks and keeps the
rank's rows (``cm.dropout(rows=)``), so the draw is one process's; kernel
D draws its masks by row from a seed, the rows restarting at 0 on every
rank, so there the ranks add 7919 j to the seed (the agent's rule,
``linear_transformer._dropout_seed``).  The score head's BatchNorm then
normalises with the statistics of the whole batch (``parallel/tensor.py
sum_over`` over the dp group, forward and backward), and ``token_ce`` is
the rank's share of the global masked CE (``ops/losses.py``).
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ..config import WindowTransformerConfig
from ..ops.ffn_block import attn_tail_block
from ..ops.losses import fields_cross_entropy
from ..ops.window_attention import window_attention, window_attention_bshe
from ..parallel.tensor import copy_to_tp, gather_fields_from_tp, gather_from_tp, sum_over
from . import common as cm
from .linear_transformer import _ffn_backend, _mesh_axes, _row_linear, check_tp, forward_output

MAX_REL = 64            # relative_key distances kept (JAX init_params)


def init_params(cfg: WindowTransformerConfig, *, seed: int = 0,
                generator: Optional[torch.Generator] = None, device="cuda") -> dict:
    """Random parameters with the JAX ``init_params`` key paths, shapes and
    distributions (not its values: the RNG streams differ)."""
    if generator is None:
        generator = torch.Generator(device=device)
        generator.manual_seed(seed)
    kw = dict(generator=generator, device=device)
    d, L = cfg.d_model, cfg.n_layer
    layers = {name: cm.init_linear(d, d, stack=(L,), **kw) for name in ("wq", "wk", "wv", "wo")}
    layers["ln1"] = cm.init_layernorm(d, device=device, stack=(L,))
    layers["ln2"] = cm.init_layernorm(d, device=device, stack=(L,))
    layers["ffn1"] = cm.init_linear(d, cfg.d_inner, stack=(L,), **kw)
    layers["ffn2"] = cm.init_linear(cfg.d_inner, d, stack=(L,), **kw)
    normal = lambda *shape: torch.randn(shape, generator=generator, device=device) * 0.02
    params = {
        "emb": cm.init_field_embeddings(cfg.vocab_sizes, cfg.emb_sizes, **kw),
        "proj": cm.init_linear(sum(cfg.emb_sizes), d, **kw),
        "pos_emb": normal(cfg.max_pos, d),
        "emb_ln": cm.init_layernorm(d, device=device),
        "layers": layers,
        "heads": cm.init_field_heads(d, cfg.vocab_sizes, **kw),
    }
    if cfg.position_embedding_type == "relative_key":
        params["rel_emb"] = normal(2 * MAX_REL + 1, cfg.d_head)
    if cfg.with_score_head:
        params["score"] = {
            "l1": cm.init_linear(d, 128, **kw),
            "bn": {"scale": torch.ones(128, device=device),
                   "bias": torch.zeros(128, device=device)},
            "l2": cm.init_linear(128, 64, **kw),
            "l3": cm.init_linear(64, 1, **kw),
        }
    if cfg.with_eval_heads:
        params["eval_heads"] = {n: cm.init_linear(v, 1, **kw) for n, v in
                                zip(cm.field_names(cfg.n_fields), cfg.vocab_sizes)}
    return params


def init_state(cfg: WindowTransformerConfig, device="cuda") -> dict:
    """Running stats of the score head's BatchNorm1d (AIRL_model.py:93)."""
    if not cfg.with_score_head:
        return {}
    return {"bn_mean": torch.zeros(128, device=device),
            "bn_var": torch.ones(128, device=device)}


# -- trunk ----------------------------------------------------------------------

def _layer(cfg: WindowTransformerConfig, h: torch.Tensor, lp: dict,
           attention_mask: Optional[torch.Tensor], rel: Optional[torch.Tensor],
           generator: Optional[torch.Generator], deterministic: bool,
           mesh=None, rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    b, s, d = h.shape
    tp = _mesh_axes(mesh)[1]
    # an explicit RLMG_WINDOW_BACKEND=pallas request (kernel E, (B, H, S, D)
    # layout) is not dropped by the fused-tail route, whose attention is the
    # head-minor composition; under tp the guard takes the composition
    if (os.environ.get("RLMG_WINDOW_BACKEND") != "pallas"
            and _ffn_backend(b * s, h.device, mesh) == "pallas-tail"):
        bshe = lambda x: x.reshape(b, s, cfg.n_head, cfg.d_head)
        att = window_attention_bshe(bshe(cm.linear(lp["wq"], h)), bshe(cm.linear(lp["wk"], h)),
                                    bshe(cm.linear(lp["wv"], h)), attention_mask,
                                    window=cfg.attention_window, rel_emb=rel)
        # no generator means no dropout, not dropout with a fixed seed
        p = 0.0 if deterministic else cfg.dropout
        if p > 0.0:
            seed = torch.randint(0, 2 ** 30, (), generator=generator, device=generator.device,
                                 dtype=torch.int32)
            if rows[0]:
                seed = seed + 7919 * rows[0]
            seed = seed.to(h.device, non_blocking=True)
        else:
            seed = 0
        out = attn_tail_block(h.reshape(b * s, d), att.reshape(b * s, d).contiguous(),
                              lp["wo"]["w"], lp["wo"]["b"], lp["ln1"]["scale"],
                              lp["ln1"]["bias"], lp["ffn1"]["w"], lp["ffn1"]["b"],
                              lp["ffn2"]["w"], lp["ffn2"]["b"], lp["ln2"]["scale"],
                              lp["ln2"]["bias"], seed, p, mid_drop=False)
        return out.reshape(b, s, d)
    # under tp: the rank's n_head / tp heads, column-parallel
    hc = copy_to_tp(h, mesh)
    heads = lambda x: x.reshape(b, s, cfg.n_head // tp, cfg.d_head).transpose(1, 2)
    att = window_attention(heads(cm.linear(lp["wq"], hc)), heads(cm.linear(lp["wk"], hc)),
                           heads(cm.linear(lp["wv"], hc)), attention_mask,
                           window=cfg.attention_window, rel_emb=rel)
    att = _row_linear(lp["wo"], att.transpose(1, 2).reshape(b, s, d // tp), mesh)
    h = cm.layernorm(lp["ln1"], h + cm.dropout(generator, att, cfg.dropout, deterministic,
                                               rows=rows))
    y = torch.nn.functional.gelu(cm.linear(lp["ffn1"], copy_to_tp(h, mesh)), approximate="none")
    y = _row_linear(lp["ffn2"], y, mesh)
    return cm.layernorm(lp["ln2"], h + cm.dropout(generator, y, cfg.dropout, deterministic,
                                                  rows=rows))


def embed(params: dict, cfg: WindowTransformerConfig, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """x (B, S, n_fields) int -> the field-concat embeddings (B, S,
    sum(emb_sizes)), whole: under tp each field's column shards gathered."""
    tp = _mesh_axes(mesh)[1]
    check_tp(cfg, tp)
    embs = cm.embed_fields(params["emb"], x, tp)
    if tp == 1:
        return embs
    names = cm.field_names(x.shape[-1])
    return gather_fields_from_tp(embs, mesh, [params["emb"][n].shape[-1] for n in names])


def forward(params: dict, cfg: WindowTransformerConfig, x: torch.Tensor,
            attention_mask: Optional[torch.Tensor] = None, *, deterministic: bool = True,
            generator: Optional[torch.Generator] = None, mesh=None,
            rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """x (B, S, n_fields) int -> sequence output (B, S, D)
    (AIRL_model.py:101-118: embeddings -> proj -> longformer); ``mesh``:
    tp shards in, h replicated out; ``rows``: x is that row block of a
    batch (the dropout masks the batch's)."""
    return forward_from_embeddings(params, cfg, embed(params, cfg, x, mesh), attention_mask,
                                   deterministic=deterministic, generator=generator, mesh=mesh,
                                   rows=rows)


def forward_from_embeddings(params: dict, cfg: WindowTransformerConfig, embs: torch.Tensor,
                            attention_mask: Optional[torch.Tensor] = None, *,
                            deterministic: bool = True,
                            generator: Optional[torch.Generator] = None,
                            mesh=None, rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The trunk on field-concat embeddings (B, S, sum(emb_sizes)), HF's
    ``inputs_embeds`` path; the AIRL gradient penalty differentiates
    through it.  Under tp ``embs`` is whole and ``proj`` runs
    column-parallel, its columns gathered."""
    check_tp(cfg, _mesh_axes(mesh)[1])
    deterministic = deterministic or generator is None
    s = embs.shape[1]
    h = gather_from_tp(cm.linear(params["proj"], copy_to_tp(embs, mesh)), mesh)
    h = cm.layernorm(params["emb_ln"], h + params["pos_emb"][None, :s])
    rel = params.get("rel_emb")
    layers = params["layers"]
    for l in range(cfg.n_layer):
        lp = {k: {kk: vv[l] for kk, vv in v.items()} for k, v in layers.items()}
        h = _layer(cfg, h, lp, attention_mask, rel, generator, deterministic, mesh, rows)
    return h


# -- heads ----------------------------------------------------------------------

def _batchnorm(p: dict, state: dict, x: torch.Tensor, train: bool, momentum: float = 0.1,
               eps: float = 1e-5, dp_mesh=None) -> Tuple[torch.Tensor, dict]:
    """BatchNorm1d over the batch; train mode normalises with the batch's
    (biased) statistics and moves the running ones by ``momentum``.
    ``dp_mesh``: x is this rank's 1/dp of the batch's rows, and the
    statistics are the whole batch's (sums over the dp group, whose
    backward sums the ranks' cotangents: ``sum_over``), equal on its
    ranks."""
    if train and dp_mesh is not None:
        n = x.shape[0] * dp_mesh.dp
        mu = sum_over(x.sum(dim=0), dp_mesh, "dp") / n
        var = sum_over(((x - mu) ** 2).sum(dim=0), dp_mesh, "dp") / n
        new_state = {"bn_mean": (1 - momentum) * state["bn_mean"] + momentum * mu,
                     "bn_var": (1 - momentum) * state["bn_var"] + momentum * var}
    elif train:
        mu = x.mean(dim=0)
        var = x.var(dim=0, correction=0)
        new_state = {"bn_mean": (1 - momentum) * state["bn_mean"] + momentum * mu,
                     "bn_var": (1 - momentum) * state["bn_var"] + momentum * var}
    else:
        mu, var = state["bn_mean"], state["bn_var"]
        new_state = state
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"], new_state


def _score_head(params: dict, state: dict, h: torch.Tensor, train: bool,
                dp_mesh=None) -> Tuple[torch.Tensor, dict]:
    """score_classifier MLP (AIRL_model.py:91-99): mean-pool -> Linear ->
    BatchNorm -> tanh -> Linear -> tanh -> Linear -> sigmoid."""
    sc = params["score"]
    y, new_state = _batchnorm(sc["bn"], state, cm.linear(sc["l1"], h.mean(dim=1)), train,
                              dp_mesh=dp_mesh)
    y = torch.tanh(cm.linear(sc["l2"], torch.tanh(y)))
    return torch.sigmoid(cm.linear_scalar(sc["l3"], y))[..., None], new_state


def _split(mesh, rows: Tuple[int, int]):
    """The dp mesh a batch split by ``rows`` is spread over, or None."""
    return mesh if rows[1] > 1 else None


def score_forward(params: dict, cfg: WindowTransformerConfig, x: torch.Tensor,
                  attention_mask: Optional[torch.Tensor], state: dict, *, train: bool = False,
                  deterministic: bool = True, generator: Optional[torch.Generator] = None,
                  mesh=None, rows: Tuple[int, int] = (0, 1)) -> Tuple[torch.Tensor, dict]:
    """Realness score in (0, 1) (AIRL_model.py:101-122) -> (score (B, 1),
    new BatchNorm state).  ``rows`` = (j, m), m > 1: x is the j-th of the
    m = dp row blocks of a batch split over ``mesh``'s dp group, and the
    BatchNorm's statistics are the whole batch's."""
    h = forward(params, cfg, x, attention_mask, deterministic=deterministic, generator=generator,
                mesh=mesh, rows=rows)
    return _score_head(params, state, h, train, _split(mesh, rows))


def score_from_embeddings(params: dict, cfg: WindowTransformerConfig, embs: torch.Tensor,
                          attention_mask: Optional[torch.Tensor], state: dict, *,
                          train: bool = False, deterministic: bool = True,
                          generator: Optional[torch.Generator] = None, mesh=None
                          ) -> Tuple[torch.Tensor, dict]:
    """``score_forward`` on embeddings: the differentiable entry of the WGAN
    gradient penalty (token ids are discrete, so it interpolates
    embeddings)."""
    h = forward_from_embeddings(params, cfg, embs, attention_mask, deterministic=deterministic,
                                generator=generator, mesh=mesh)
    return _score_head(params, state, h, train)


def token_logits(params: dict, cfg: WindowTransformerConfig, x: torch.Tensor,
                 attention_mask: Optional[torch.Tensor] = None, *, deterministic: bool = True,
                 generator: Optional[torch.Generator] = None,
                 mesh=None, rows: Tuple[int, int] = (0, 1)) -> Tuple[torch.Tensor, ...]:
    """Per-field logits over the sequence (AIRL_model.py:131-153); under tp
    the heads row-parallel over d_model, the logits replicated."""
    h = forward(params, cfg, x, attention_mask, deterministic=deterministic, generator=generator,
                mesh=mesh, rows=rows)
    return forward_output(params, cfg, h, mesh)


def token_ce(params: dict, cfg: WindowTransformerConfig, x: torch.Tensor, target: torch.Tensor,
             mask: torch.Tensor, *, deterministic: bool = True,
             generator: Optional[torch.Generator] = None, mesh=None,
             rows: Tuple[int, int] = (0, 1)) -> torch.Tensor:
    """Mean masked CE over fields (AIRL_model.py:131-170), with the mask
    applied as intended (the reference's unmasked mean made it a no-op).
    ``mesh``: the weights' tp shards; the rows whole on every rank, or
    with ``rows`` = (j, m), m > 1, the rank's block of the batch, and the
    result its share of the global CE (summed over dp by the caller)."""
    logits = token_logits(params, cfg, x, mask, deterministic=deterministic, generator=generator,
                          mesh=mesh, rows=rows)
    return torch.mean(fields_cross_entropy(logits, target, mask, mesh=_split(mesh, rows)))


def eval_score(params: dict, cfg: WindowTransformerConfig, x: torch.Tensor,
               attention_mask: Optional[torch.Tensor] = None, *, deterministic: bool = True,
               generator: Optional[torch.Generator] = None, mesh=None) -> torch.Tensor:
    """PPO reward model score (B, 1): the mean over fields of the sigmoid of
    each field's scalar head, averaged over the sequence
    (ppo_policy/IRL_model.py:128-163)."""
    logits = token_logits(params, cfg, x, attention_mask, deterministic=deterministic,
                          generator=generator, mesh=mesh)
    names = cm.field_names(cfg.n_fields)
    total = 0.0
    for n, lg in zip(names, logits):
        hid = cm.linear_scalar(params["eval_heads"][n], lg).mean(dim=1)[..., None]
        total = total + torch.sigmoid(hid)
    return total / len(names)
