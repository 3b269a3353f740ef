"""Kernel F's plain twin (``ops/linear_attention_kernel.py
causal_product`` on CPU tensors) against the JAX package's Pallas causal
product (``_fwd_pallas`` / ``_bwd_pallas``) on bf16 inputs, on the CPU,
and ``pretrain --dtype bfloat16`` under RLMG_ATTN_BACKEND=pallas against
JAX's step.

The JAX side runs its Pallas kernels in interpret mode under
``jax.disable_jit()`` and ``pltpu.force_tpu_interpret_mode()``.  JAX's
kernel widens q, k and [v | 1] to f32, forms every product in f32, and
returns out = num / (den + eps) and den rounded to bf16; its backward forms
dnum = g / (den + eps) and dden = -sum(g out) / (den + eps) in bf16
arithmetic on the rounded out and den, outside its kernels, and rounds dq,
dk, dv on store.  The twin computes the same, so every tensor agrees to
f32 rounding before its one cast.  Tolerance: half a bf16 step at the
tensor's largest magnitude, 2^(floor(log2 max|ref|) - 8), and a mean
|diff| within MEAN_SHARE of mean |ref|.  The control, the chunked
composition run in bf16 arithmetic (the ``xla`` route on bf16 tensors),
misses the half step on at least one of out, dq, dk, dv at every shape
(at exactly one step it may meet it on one tensor), and the mean share on
each of them by ten times or more: it differs by a step or more almost
everywhere, where the twin differs nowhere, or in a few elements."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.ops import linear_attention as tla
from reinforcement_learning_in_music_generation_torch.ops import linear_attention_kernel as tlk
from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.ops import linear_attention as jla

EPS = 1e-6
# (batch, heads, rows, head width, chunk): a rollout-like 50 rows in one
# ragged chunk, a ragged S > chunk, and several chunks of 16
SHAPES = [(1, 2, 50, 8, 128), (1, 2, 150, 8, 128), (2, 2, 67, 8, 16)]
NAMES = ("out", "den", "dq", "dk", "dv")
MEAN_SHARE = 2 ** -12


def _half_step(ref: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 8))


def _bf16_inputs(b, h, s, e, seed):
    """phi(q), phi(k) (the feature map in bf16, as the model applies it),
    v and the upstream gradient, as bf16 JAX arrays."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (jnp.asarray(rng.standard_normal((b, h, s, e)), jnp.bfloat16)
                  for _ in range(4))
    return jla.feature_map(q), jla.feature_map(k), v, g


def _torch(a):
    return torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)


def _run(fn, ins, g):
    """fn(phi_q, phi_k, v) -> (out, den); returns out, den and the three
    gradients of <out, g>."""
    ts = [t.detach().clone().requires_grad_(True) for t in ins]
    out, den = fn(*ts)
    return (out, den, *torch.autograd.grad(out, ts, g))


def _bf16_composition(chunk):
    """The chunked composition on the bf16 tensors, every product in bf16."""
    def fn(pq, pk, v):
        t = lambda x: x.transpose(1, 2)
        out, den = tla._ChunkedCore.apply(t(pq), t(pk), t(v), EPS, chunk)
        return t(out), den.transpose(1, 2)
    return fn


@pytest.mark.parametrize("b,h,s,e,chunk", SHAPES)
def test_twin_computes_the_pallas_kernels_bf16_arithmetic(b, h, s, e, chunk):
    pq, pk, v, g = _bf16_inputs(b, h, s, e, seed=s + chunk)
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        out, den = jla._fwd_pallas(pq, pk, v, EPS, chunk)
        refs = (out, den, *jla._bwd_pallas(pq, pk, v, out, den, g, EPS, chunk))
    ins = [_torch(a) for a in (pq, pk, v)]
    ours = _run(lambda *a: tlk.causal_product(*a, EPS, chunk), ins, _torch(g))
    ctl = _run(_bf16_composition(chunk), ins, _torch(g))
    assert all(x.dtype == torch.bfloat16 for x in ours)
    ctl_fails = []
    for name, x, c, y in zip(NAMES, ours, ctl, refs):
        ref = np.asarray(y.astype(jnp.float32))
        tol, mean_ref = _half_step(ref), float(np.abs(ref).mean())
        d = np.abs(x.detach().float().numpy() - ref)
        assert d.max() <= tol, f"{name}: max|diff| {d.max()}, half a bf16 step {tol}"
        assert d.mean() <= MEAN_SHARE * mean_ref, f"{name}: mean|diff| {d.mean()}"
        if name == "den":            # one sum a row: the composition rounds it once too
            continue
        dc = np.abs(c.detach().float().numpy() - ref)
        assert dc.mean() > MEAN_SHARE * mean_ref, f"{name}: the control's mean|diff| {dc.mean()}"
        ctl_fails.append(dc.max() > tol)
    assert any(ctl_fails), "the bf16 composition meets the half step on every tensor"


def test_twin_at_float32_is_the_chunked_core():
    """At float32 every rounding of the bf16 arithmetic is the identity: the
    twin is the chunked core's arithmetic, bit for bit."""
    rng = np.random.default_rng(1)
    pq, pk, v, g = (torch.from_numpy(rng.random((2, 2, 67, 8), np.float32)) for _ in range(4))
    t = lambda x: x.transpose(1, 2)
    ours = _run(lambda *a: tlk.causal_product(*a, EPS, 16), (pq, pk, v), g)
    ref = _run(lambda a, b_, c: tuple(x.transpose(1, 2) for x in tla._ChunkedCore.apply(
        t(a), t(b_), t(c), EPS, 16)), (pq, pk, v), g)
    for name, x, y in zip(NAMES, ours, ref):
        assert torch.equal(x, y), name


def test_wrapper_takes_float32_and_bfloat16_only():
    x = torch.ones((1, 2, 50, 8))
    for dt in (torch.float32, torch.bfloat16):
        out, den = tlk.causal_product(x.to(dt), x.to(dt), x.to(dt))
        assert out.dtype == den.dtype == dt
    for bad in ((x.half(),) * 3, (x, x, x.bfloat16())):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            tlk.causal_product(*bad)


KW = dict(vocab_sizes=(56, 135, 18, 87, 18, 25), emb_sizes=(8,) * 6, d_model=16, n_layer=2,
          n_head=2, d_inner=32, dropout=0.0, dtype="bfloat16")


def test_pretrain_bf16_step_under_the_pallas_route_matches_jax(monkeypatch):
    """One ``agent_grad_step`` at ``--dtype bfloat16`` (f32 master weights
    cast to bf16 for the forward) under RLMG_ATTN_BACKEND=pallas: every
    layer's attention is the Pallas product in JAX and kernel F's twin in
    the port, both on bf16 tensors.  Per-field losses within 1e-3
    relative and every gradient within 2^-5 of its leaf's largest: the two
    frameworks round the other bf16 operations of the model alike but sum
    in other orders (a bias gradient is a bf16 sum over every row), and a
    flipped rounding travels through two layers and the backward; the
    ``xla`` route at bf16 differs from JAX's by as much (0.1% to 2.2% of a
    leaf's largest gradient on this batch)."""
    monkeypatch.setenv("RLMG_ATTN_BACKEND", "pallas")
    cfg, tcfg = C.LinearTransformerConfig(**KW), TC.LinearTransformerConfig(**KW)
    jp = jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(2), cfg))
    x, y, m = jds.synthetic_cp_dataset(2, 50, n_class=KW["vocab_sizes"], seed=5)
    calls = []
    real = tlk.causal_product
    monkeypatch.setattr(tlk, "causal_product",
                        lambda *a: calls.append(a[0].dtype) or real(*a))
    tp = tw.from_jax_params(jp, device="cpu")
    grads, (loss, losses) = tpre.agent_grad_step(tp, tcfg, *(torch.from_numpy(a) for a in
                                                            (x, y, m)), None)

    def loss_fn(p):
        p = jax.tree_util.tree_map(lambda a: a.astype(jnp.bfloat16), p)
        ls = jlt.train_losses(p, cfg, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                              deterministic=True)
        return jnp.mean(ls), ls

    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        (_, jls), jg = jax.value_and_grad(loss_fn, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, jp))
    assert calls == [torch.bfloat16] * cfg.n_layer
    assert all(np.isfinite(losses.numpy()))
    np.testing.assert_allclose(losses.numpy(), np.asarray(jls), rtol=1e-3)
    ours = _flat(grads)
    for key, ref in _flat(jg).items():
        scale = float(np.abs(ref).max())
        err = float(np.abs(ours[key] - ref).max())
        assert err <= 2 ** -5 * max(scale, 1e-6), f"{key}: max|diff| {err} of {scale}"


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items() for k, v in _flat(sub, f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree.float().numpy() if torch.is_tensor(tree) else tree,
                               np.float32)}
