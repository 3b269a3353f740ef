"""The plain versions of the port's two training kernels against the JAX
package's Pallas kernels (run in interpret mode, as tests/test_ffn_block.py
and tests/test_attention_block.py run them), on the CPU.

Kernel C (``ops/attention_block.py``): forward and (dh, dWqkv, dbqkv) at
1e-5.  Kernel D (``ops/ffn_block.py``): forward and all twelve gradients at
1e-5 with dropout off; the JAX kernels' gelu uses the A&S 7.1.26 erf
polynomial where the port uses the exact erf, about 1e-7 apart, inside the
tolerance.  Dropout with p > 0 cannot match JAX (its interpret mode skips
the on-core PRNG), so the port's masks are checked on their own: forward
and backward see one mask, the keep rate is 1 - p, and a mask does not
depend on the row block.  The wrappers are called with CPU tensors, so
they run the plain versions; ``tests/test_torch_kernels_gpu.py`` holds the
CUDA kernels against those on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch.ops import attention_block as tab
from reinforcement_learning_in_music_generation_torch.ops import decode_common as tdc
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_tpu.ops import attention_block as jab
from reinforcement_learning_in_music_generation_tpu.ops import ffn_block as jfb

TOL = dict(rtol=1e-5, atol=1e-5)
N_SEQ, S, H, E, CHUNK = 2, 32, 2, 16, 8
D, DI = H * E, 64


def _rng(seed):
    return np.random.default_rng(seed)


def _qkv_inputs(seed):
    r = _rng(seed)
    h = r.standard_normal((N_SEQ * S, D)).astype(np.float32)
    w = (r.standard_normal((D, 3 * D)) * 0.2).astype(np.float32)
    b = (r.standard_normal(3 * D) * 0.1).astype(np.float32)
    g = r.standard_normal((N_SEQ * S, D)).astype(np.float32)
    return h, w, b, g


def _grads_torch(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _grads_jax(fn, arrays, g):
    out = fn(*arrays)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * g), argnums=tuple(range(len(arrays))))(*arrays)
    return np.asarray(out), [np.asarray(x) for x in grads]


@pytest.mark.parametrize("route", ["wrapper", "plain"])
def test_qkv_attention_block_matches_jax(route):
    h, w, b, g = _qkv_inputs(0)
    fn = tab.qkv_attention_block if route == "wrapper" else tab.qkv_attention_block_plain
    ours = _grads_torch(lambda *a: fn(*a, N_SEQ, H, chunk=CHUNK), (h, w, b), g)
    ref = _grads_jax(lambda *a: jab.qkv_attention_block(*a, N_SEQ, H, chunk=CHUNK,
                                                         interpret=True), (h, w, b), g)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, x, y in zip(("dh", "dwqkv", "dbqkv"), ours[1], ref[1]):
        np.testing.assert_allclose(x, y, err_msg=name, **TOL)


def test_qkv_attention_block_rejects_ragged_chunks():
    h = torch.zeros((2 * 12, D))
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tab.qkv_attention_block(h, torch.zeros((D, 3 * D)), torch.zeros(3 * D), 2, H, chunk=8)


@pytest.mark.parametrize("d,n_head", [(144, 2), (36, 2), (30, 2)])
def test_qkv_kernel_check_rejects_head_widths_it_does_not_take(d, n_head):
    """Heads wider than 64, or not a multiple of 4, raise (the CUDA kernel's
    own limits), so a route never sends them to it unnoticed."""
    h = torch.zeros((2 * 16, d))
    with pytest.raises(ValueError, match="head width"):
        tab._check(h, torch.zeros((d, 3 * d)), torch.zeros(3 * d), 2, n_head, 8)
    tab._check(torch.zeros((32, 128)), torch.zeros((128, 384)), torch.zeros(384), 2, 2, 8)


def _tail_inputs(n, seed):
    r = _rng(seed)
    f = lambda *shape, s=1.0: (r.standard_normal(shape) * s).astype(np.float32)
    return [f(n, D), f(n, D), f(D, D, s=0.2), f(D, s=0.1), 1.0 + f(D, s=0.1), f(D, s=0.1),
            f(D, DI, s=0.2), f(DI, s=0.1), f(DI, D, s=0.15), f(D, s=0.1), 1.0 + f(D, s=0.1),
            f(D, s=0.1)], f(n, D)


TAIL_GRADS = ("dh_in", "da_pre", "dwo_w", "dwo_b", "dln1_s", "dln1_b", "dw1", "db1", "dw2",
              "db2", "dln2_s", "dln2_b")


@pytest.mark.parametrize("n,block", [(64, 16), (50, 16), (64, 256)])
def test_attn_tail_block_matches_jax_without_dropout(n, block):
    arrays, g = _tail_inputs(n, seed=n + block)
    # block is the JAX kernel's row tile; the port's masks and math do not
    # depend on one
    ours = _grads_torch(lambda *a: tfb.attn_tail_block(*a, 0, 0.0), arrays, g)
    ref = _grads_jax(lambda *a: jfb.attn_tail_block(*a, jnp.int32(0), 0.0, block, True),
                     arrays, g)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, x, y in zip(TAIL_GRADS, ours[1], ref[1]):
        np.testing.assert_allclose(x, y, err_msg=name, **TOL)


def _philox_mask(seed, site, n, cols, p):
    """The keep rule built from philox_bits directly: element (r, c) of
    site s is kept when bits(r, c, s, 0) >> 8 times 2^-24 >= p."""
    r = torch.arange(n, dtype=torch.int64)[:, None]
    c = torch.arange(cols, dtype=torch.int64)[None, :]
    bits = tdc.philox_bits(seed, r, c, torch.tensor(site), torch.tensor(0))
    keep = ((bits >> 8).to(torch.float64) / 2 ** 24) >= p
    return keep.to(torch.float32) / (1.0 - p)


@pytest.mark.parametrize("mid_drop", [True, False])
def test_attn_tail_dropout_forward_and_backward_share_one_mask(mid_drop):
    """Gradients of the plain version (autograd) equal those of a
    composition with masks drawn from philox_bits directly."""
    n, p, seed = 48, 0.3, 12345
    arrays, g = _tail_inputs(n, seed=5)
    m1, m2, m3 = (_philox_mask(seed, s, n, c, p) for s, c in ((1, D), (2, DI), (3, D)))

    def manual(h_in, a_pre, wow, wob, l1s, l1b, w1, b1, w2, b2, l2s, l2b):
        h1 = tdc.ln(h_in + (a_pre @ wow + wob) * m1, l1s, l1b)
        y = tdc.gelu_exact(h1 @ w1 + b1)
        if mid_drop:
            y = y * m2
        return tdc.ln(h1 + (y @ w2 + b2) * m3, l2s, l2b)

    ours = _grads_torch(lambda *a: tfb.attn_tail_block(*a, seed, p, mid_drop), arrays, g)
    ref = _grads_torch(manual, arrays, g)
    np.testing.assert_allclose(ours[0], ref[0], **TOL)
    for name, x, y in zip(TAIL_GRADS, ours[1], ref[1]):
        np.testing.assert_allclose(x, y, err_msg=name, **TOL)
    # and the masks really drop: the output differs from p = 0
    no_drop = tfb.attn_tail_block(*map(torch.from_numpy, arrays), seed, 0.0)
    assert not torch.allclose(torch.from_numpy(ours[0]), no_drop)


@pytest.mark.parametrize("site", [1, 2, 3])
def test_dropout_keep_rate_within_four_sigma(site):
    p, rows, cols = 0.1, 256, 512
    m = tfb.dropout_scale(987, site, 0, rows, cols, p, "cpu")
    n = rows * cols
    rate = (m > 0).float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n), rate
    assert torch.all((m == 0) | (m == torch.tensor(1 / (1 - p), dtype=torch.float32)))


def test_dropout_masks_do_not_depend_on_the_row_block():
    whole = tfb.dropout_scale(3, 2, 0, 64, 40, 0.25, "cpu")
    for block in (8, 16, 64):
        parts = torch.cat([tfb.dropout_scale(3, 2, r0, min(block, 64 - r0), 40, 0.25, "cpu")
                           for r0 in range(0, 64, block)])
        assert torch.equal(whole, parts)
    # any row slice, aligned to no tile, is the same slice of the full draw
    assert torch.equal(tfb.dropout_scale(3, 2, 17, 13, 40, 0.25, "cpu"), whole[17:30])
    # different sites and seeds give different masks
    assert not torch.equal(whole, tfb.dropout_scale(3, 1, 0, 64, 40, 0.25, "cpu"))
    assert not torch.equal(whole, tfb.dropout_scale(4, 2, 0, 64, 40, 0.25, "cpu"))


def test_wrappers_refuse_other_devices():
    meta = torch.zeros((4, D), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tab.qkv_attention_block(meta, torch.zeros((D, 3 * D), device="meta"),
                                torch.zeros(3 * D, device="meta"), 1, H, chunk=4)
    with pytest.raises(ValueError, match="no kernel"):
        tfb.attn_tail_block(meta, meta, *([meta] * 10), 0, 0.0)
