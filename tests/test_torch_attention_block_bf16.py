"""Kernel C's plain twin (``ops/attention_block.py qkv_attention_block``
on CPU tensors) against the JAX package's Pallas ``qkv_attention_block``
in interpret mode, on the CPU, at bf16.

JAX's kernel casts h, W and b to f32, forms the projection and the whole
causal attention in f32 on the unrounded phi(q), phi(k), v, and rounds
only what it stores: the residual [phi(q) | phi(k) | v] and the output;
den stays f32.  Its backward forms dq, dk, dv in f32 from those rounded
residuals and the upstream gradient cast to h's type, folds phi' =
min(phi, 1) into dq and dk, rounds dqkv once, and leaves dh = dqkv W^T,
dW = h^T dqkv and db = sum dqkv to XLA in h's type.  The twin computes
the same, so every tensor agrees to f32 rounding before its one cast.
Tolerance: half a bf16 step at the tensor's largest magnitude,
2^(floor(log2 max|ref|) - 8).  A twin that runs the attention in bf16
misses it by one to three steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch.ops import attention_block as tab
from reinforcement_learning_in_music_generation_tpu.ops import attention_block as jab

# (sequences, rows each, heads, head width, chunk)
SHAPES = [(2, 64, 2, 32, 16), (2, 32, 2, 16, 8)]


def _arrays(n, d, seed):
    r = np.random.default_rng(seed)
    f = lambda *shape, sc=1.0: (sc * r.standard_normal(shape)).astype(np.float32)
    return (f(n, d), f(d, 3 * d, sc=0.2), f(3 * d, sc=0.1)), f(n, d)


def _half_step(ref: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 8))


@pytest.mark.parametrize("n_seq,s,n_head,e,chunk", SHAPES)
def test_qkv_attention_twin_computes_jax_bf16_arithmetic(n_seq, s, n_head, e, chunk):
    d = n_head * e
    arrays, g = _arrays(n_seq * s, d, seed=s + e)
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in arrays]
    out = tab.qkv_attention_block(*ts, n_seq, n_head, chunk=chunk)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g).to(torch.bfloat16))
    ja = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    jout, vjp = jax.vjp(lambda *a: jab.qkv_attention_block(*a, n_seq, n_head, chunk=chunk,
                                                           interpret=True), *ja)
    jgrads = vjp(jnp.asarray(g, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in grads)
    for name, x, y in zip(("att", "dh", "dW", "db"), (out, *grads), (jout, *jgrads)):
        ref = np.asarray(y.astype(jnp.float32))
        err = float(np.abs(x.detach().float().numpy() - ref).max())
        assert err <= _half_step(ref), \
            f"{name}: max|diff| {err}, half a bf16 step {_half_step(ref)} (max|ref| " \
            f"{np.abs(ref).max()})"
