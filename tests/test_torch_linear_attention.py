"""The port's chunked causal linear attention (both layouts, forward and
the analytic backward) against the JAX package's, on the CPU.

Inputs are made with numpy and go through both packages; outputs and the
gradients of a random linear functional of the output agree to 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch.ops import linear_attention as tla
from reinforcement_learning_in_music_generation_tpu.ops import linear_attention as jla

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape_qk, shape_v, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape_qk).astype(np.float32)
    k = rng.standard_normal(shape_qk).astype(np.float32)
    v = rng.standard_normal(shape_v).astype(np.float32)
    w = rng.standard_normal(shape_v).astype(np.float32)
    return q, k, v, w


def _port_out_and_grads(fn, q, k, v, w):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(tq, tk, tv)
    (out * torch.from_numpy(w)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in (tq, tk, tv)]


def _jax_out_and_grads(fn, q, k, v, w):
    out = fn(q, k, v)
    grads = jax.grad(lambda a, b, c: jnp.sum(fn(a, b, c) * w), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("seq", [32, 29])          # whole chunks, and a ragged tail
@pytest.mark.parametrize("chunk", [8, 32])
def test_causal_linear_attention_bhse_matches_jax(seq, chunk):
    q, k, v, w = _inputs((2, 2, seq, 8), (2, 2, seq, 6), seed=seq + chunk)
    ours = _port_out_and_grads(
        lambda a, b, c: tla.causal_linear_attention(a, b, c, chunk=chunk, backend="xla"),
        q, k, v, w)
    ref = _jax_out_and_grads(
        lambda a, b, c: jla.causal_linear_attention(a, b, c, chunk=chunk, backend="xla"),
        q, k, v, w)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), ours[1], ref[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


@pytest.mark.parametrize("seq", [32, 29])
@pytest.mark.parametrize("chunk", [8, 32])
def test_causal_linear_attention_bshe_matches_jax(seq, chunk):
    q, k, v, w = _inputs((2, seq, 2, 8), (2, seq, 2, 6), seed=100 + seq + chunk)
    ours = _port_out_and_grads(
        lambda a, b, c: tla.causal_linear_attention_bshe(a, b, c, chunk=chunk), q, k, v, w)
    ref = _jax_out_and_grads(
        lambda a, b, c: jla.causal_linear_attention_bshe(a, b, c, chunk=chunk), q, k, v, w)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, a, b in zip(("dq", "dk", "dv"), ours[1], ref[1]):
        np.testing.assert_allclose(a, b, err_msg=name, **TOL)


def test_layouts_agree_and_match_the_recurrent_step():
    """The chunked product in both layouts equals the per-token recurrence
    the decode path uses."""
    q, k, v, _ = _inputs((1, 2, 20, 4), (1, 2, 20, 4), seed=7)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = tla.causal_linear_attention(tq, tk, tv, chunk=8)
    bshe = tla.causal_linear_attention_bshe(*(t.transpose(1, 2) for t in (tq, tk, tv)), chunk=8)
    torch.testing.assert_close(bshe.transpose(1, 2), out, rtol=1e-5, atol=1e-5)
    state = tla.init_attention_state(1, 2, 4, device="cpu")
    steps = []
    for t in range(20):
        o, state = tla.linear_attention_step(tq[:, :, t], tk[:, :, t], tv[:, :, t], state)
        steps.append(o)
    torch.testing.assert_close(torch.stack(steps, 2), out, rtol=1e-5, atol=1e-5)


def test_pallas_backend_is_not_ported():
    """The name predates the port of this route: backend="pallas" (the JAX
    package's Pallas causal product) now runs kernel F's wrapper, which on
    CPU tensors is the same chunked core as backend="xla"
    (tests/test_torch_causal_product.py holds it against the JAX kernels)."""
    q, k, v, _ = _inputs((1, 2, 29, 8), (1, 2, 29, 8), seed=9)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    torch.testing.assert_close(tla.causal_linear_attention(tq, tk, tv, chunk=8, backend="pallas"),
                               tla.causal_linear_attention(tq, tk, tv, chunk=8, backend="xla"),
                               rtol=0, atol=0)
