"""The bf16 plain twins of kernels D and G (``ops/ffn_block.py``
``attn_tail_block_plain``, ``ffn_block_plain``) against the JAX package's
Pallas ``attn_tail_block`` / ``ffn_block`` in interpret mode, on the CPU,
at bf16, D=32, DI=128, N=64, dropout 0.

JAX's kernels round only each product's operands to the weights' type and
sum in f32; bias, gelu, dropout, residuals and both LayerNorms run in f32
and only the outputs are cast.  The twins compute the same, and round the
operands of the weight-gradient products too (the TPU's MXU rounds JAX's
f32 operands there; interpret mode keeps them exact), so the output and
the input gradients agree to f32 rounding and a weight gradient to about
half a bf16 ulp before its cast.  Tolerance: every tensor within one bf16
ulp at its largest magnitude, 2^(floor(log2 max|ref|) - 7).  A twin that
runs every step in bf16 misses it by 2-3 ulps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_tpu.ops import ffn_block as jfb

N, D, DI = 64, 32, 128


def _arrays(seed=0):
    """(h_in, a_pre, the ten tail parameters) and the upstream gradient."""
    r = np.random.default_rng(seed)
    f = lambda *shape, sc=1.0, off=0.0: (off + sc * r.standard_normal(shape)).astype(np.float32)
    arrays = (f(N, D), f(N, D), f(D, D, sc=0.2), f(D, sc=0.1), f(D, sc=0.1, off=1.0),
              f(D, sc=0.1), f(D, DI, sc=0.2), f(DI, sc=0.1), f(DI, D, sc=0.1), f(D, sc=0.1),
              f(D, sc=0.1, off=1.0), f(D, sc=0.1))
    return arrays, f(N, D)


def _bf16_ulp(ref: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _compare(ours_fn, jax_fn, arrays, g):
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True) for a in arrays]
    out = ours_fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g).to(torch.bfloat16))
    ja = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    jout, vjp = jax.vjp(jax_fn, *ja)
    jgrads = vjp(jnp.asarray(g, jnp.bfloat16))
    assert out.dtype == torch.bfloat16
    assert all(x.dtype == torch.bfloat16 for x in grads)
    for i, (x, y) in enumerate([(out, jout)] + list(zip(grads, jgrads))):
        ref = np.asarray(y.astype(jnp.float32))
        err = float(np.abs(x.detach().float().numpy() - ref).max())
        assert err <= _bf16_ulp(ref), f"tensor {i}: max|diff| {err}, ulp {_bf16_ulp(ref)}"


@pytest.mark.parametrize("mid_drop", [True, False])
def test_attn_tail_twin_computes_jax_bf16_arithmetic(mid_drop):
    arrays, g = _arrays()
    _compare(lambda *a: tfb.attn_tail_block_plain(*a, 0, 0.0, mid_drop),
             lambda *a: jfb.attn_tail_block(*a, jnp.int32(0), 0.0, 256, True, mid_drop),
             arrays, g)


def test_ffn_block_twin_computes_jax_bf16_arithmetic():
    arrays, g = _arrays(1)
    ffn = (arrays[0],) + arrays[6:]
    _compare(lambda *a: tfb.ffn_block_plain(*a, 0, 0.0),
             lambda *a: jfb.ffn_block(*a, jnp.int32(0), 0.0, 256, True), ffn, g)


def test_f32_twin_products_stay_f32():
    """At f32 the twins' products are plain f32 products: the same output
    as the composition with ``torch.matmul``."""
    arrays, _ = _arrays(2)
    t = [torch.from_numpy(a) for a in arrays]
    h, w1, b1, w2, b2, s, b = t[0], *t[6:]
    ref = tfb.ln(h + (tfb.gelu_exact(h @ w1 + b1) @ w2 + b2), s, b)
    assert torch.equal(tfb.ffn_block_plain(h, w1, b1, w2, b2, s, b, 0, 0.0), ref)
