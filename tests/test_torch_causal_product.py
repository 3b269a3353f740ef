"""Kernel F's route, the causal linear-attention product behind
``causal_linear_attention(backend="pallas")``, against the JAX package's
Pallas causal product (``_fwd_pallas`` / ``_bwd_pallas``), on the CPU.

The JAX side runs its Pallas kernels in interpret mode under
``jax.disable_jit()`` and ``pltpu.force_tpu_interpret_mode()``, as
tests/test_linear_attention.py runs them; the port's wrapper runs its plain
twin on CPU tensors.  Inputs come from a numpy seed.  Forward within 1e-5 of
its magnitude, the q, k, v gradients within 1e-4 of theirs, at sequence
lengths 1, 37, 50 (DQN's state), 67 and 150 (a ragged third 64-row tile of
the CUDA kernel) with chunks of 16 and 128 (one ragged chunk, as JAX pads
50 to 128).  One full ``forward_hidden`` under
RLMG_ATTN_BACKEND=pallas agrees on both sides, and the wrapper refuses what
the kernel does not take."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import linear_attention as tla
from reinforcement_learning_in_music_generation_torch.ops import linear_attention_kernel as tlk
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.ops import linear_attention as jla


def _inputs(b, h, s, e, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, h, s, e)).astype(np.float32) for _ in range(4)]


def _close(a, b, tol, what):
    """max |a - b| <= tol * max(1, max |b|)."""
    err = float(np.abs(np.asarray(a) - np.asarray(b)).max())
    mag = max(1.0, float(np.abs(np.asarray(b)).max()))
    assert err <= tol * mag, f"{what}: max |diff| {err} vs {tol} x {mag}"


@pytest.mark.parametrize("chunk", [16, 128])
@pytest.mark.parametrize("s", [1, 37, 50, 67, 150])
def test_pallas_route_matches_jax(s, chunk):
    q, k, v, w = _inputs(1, 2, s, 8, seed=s + chunk)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tla.causal_linear_attention(tq, tk, tv, chunk=chunk, backend="pallas")
    (out * torch.from_numpy(w)).sum().backward()

    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        ref, vjp = jax.vjp(lambda a, b, c: jla.causal_linear_attention(
            a, b, c, chunk=chunk, backend="pallas"), q, k, v)
        grads = vjp(jnp.asarray(w))
    _close(out.detach().numpy(), ref, 1e-5, "out")
    for name, t, g in zip(("dq", "dk", "dv"), (tq, tk, tv), grads):
        _close(t.grad.numpy(), g, 1e-4, name)


def test_den_is_returned_unclipped_as_fwd_pallas_returns_it():
    q, k, v, _ = _inputs(1, 2, 50, 8, seed=3)
    pq, pk = (jla.feature_map(jnp.asarray(a)) for a in (q, k))
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        ref_out, ref_den = jla._fwd_pallas(pq, pk, jnp.asarray(v), 1e-6, 128)
    out, den = tlk.causal_product(*(torch.from_numpy(np.array(a)) for a in (pq, pk)),
                                  torch.from_numpy(v), 1e-6, 128)
    assert den.shape == (1, 2, 50) and not den.requires_grad
    _close(out.numpy(), ref_out, 1e-5, "out")
    _close(den.numpy(), ref_den, 1e-5, "den")


def test_forward_hidden_under_the_pallas_route_matches_jax(monkeypatch):
    """RLMG_ATTN_BACKEND=pallas on both sides (conftest pins xla): every
    layer's attention is the Pallas product in JAX and kernel F's wrapper in
    the port; the FFN tail stays the plain composition."""
    kw = dict(vocab_sizes=(56, 135, 18, 87, 18, 25), emb_sizes=(8,) * 6, d_model=16,
              n_layer=2, n_head=2, d_inner=32, dropout=0.0)
    cfg, tcfg = C.LinearTransformerConfig(**kw), TC.LinearTransformerConfig(**kw)
    jp = jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(2), cfg))
    x, y, m = jds.synthetic_cp_dataset(2, 50, n_class=kw["vocab_sizes"], seed=5)
    monkeypatch.setenv("RLMG_ATTN_BACKEND", "pallas")
    calls = []
    real = tlk.causal_product
    monkeypatch.setattr(tlk, "causal_product", lambda *a: calls.append(a[0].shape) or real(*a))
    ours = tlt.forward_hidden(tw.from_jax_params(jp, device="cpu"), tcfg, torch.from_numpy(x))
    with jax.disable_jit(), pltpu.force_tpu_interpret_mode():
        ref = jlt.forward_hidden(jp, cfg, jnp.asarray(x))
    assert calls == [(2, 2, 50, 8)] * cfg.n_layer
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.ones((1, 2, 50, 8))
    with pytest.raises(TypeError, match="float32"):
        tlk.causal_product(x.double(), x.double(), x.double())
    wide = torch.ones((1, 2, 50, 72))
    with pytest.raises(ValueError, match="head width"):
        tlk.causal_product(wide, wide, wide)
    meta = x.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tlk.causal_product(meta, meta, meta)
    with pytest.raises(ValueError, match="as wide"):
        tla.causal_linear_attention(x, x, torch.ones((1, 2, 50, 4)), backend="pallas")
