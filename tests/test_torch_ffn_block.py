"""Kernel G's plain twin (``ops/ffn_block.py ffn_block``) against the JAX
package's Pallas ``ffn_block`` run in interpret mode (as
tests/test_ffn_block.py runs it), on the CPU, at D=64, DI=256 and a ragged
N=100.

Forward and all seven gradients at p = 0 within 1e-5 of each tensor's
magnitude (the JAX kernel's gelu is the A&S 7.1.26 erf polynomial, the
port's the exact erf, about 1e-7 apart).  With p > 0 the masks cannot match
JAX (its interpret mode skips the on-core PRNG), so the port's are checked
on their own: forward and backward share one Philox mask per site, the keep
rate is 1 - p, and a mask keys on the absolute row, so it does not depend on
how the rows are split.  Then the model's route: ``forward_hidden`` and the
``train_losses`` gradients under RLMG_FFN_BACKEND=pallas, port against JAX.
The wrapper is called with CPU tensors and so runs the plain twin;
``tests/test_torch_kernels_gpu.py`` holds the CUDA kernel against it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import decode_common as tdc
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_torch.train import optim as topt
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.data import dataset as jds
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as jlt
from reinforcement_learning_in_music_generation_tpu.ops import ffn_block as jfb

N, D, DI = 100, 64, 256
GRADS = ("dh", "dw1", "db1", "dw2", "db2", "dln_s", "dln_b")


def _inputs(n=N, seed=0):
    r = np.random.default_rng(seed)
    f = lambda *shape, sc=1.0, off=0.0: (off + sc * r.standard_normal(shape)).astype(np.float32)
    arrays = (f(n, D), f(D, DI, sc=0.1), f(DI, sc=0.1), f(DI, D, sc=0.05), f(D, sc=0.1),
              f(D, sc=0.1, off=1.0), f(D, sc=0.1))
    return arrays, f(n, D)


def _grads_torch(fn, arrays, g):
    ts = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ts)
    (out * torch.from_numpy(g)).sum().backward()
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _close(ours, ref, what, tol=1e-5):
    """max |ours - ref| <= tol * max(1, max |ref|)."""
    err = float(np.abs(ours - ref).max())
    assert err <= tol * max(1.0, float(np.abs(ref).max())), f"{what}: max|diff| {err}"


@pytest.mark.parametrize("block", [32, 256])
def test_ffn_block_matches_jax_without_dropout(block):
    """``block`` is the JAX kernel's row tile (100 rows: 4 tiles of 32 with
    28 padded rows, or one of 256); the port has none."""
    arrays, g = _inputs()
    ours = _grads_torch(lambda *a: tfb.ffn_block(*a, 0, 0.0), arrays, g)
    fn = lambda *a: jfb.ffn_block(*a, jnp.int32(0), 0.0, block, True)
    out = fn(*arrays)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * g), argnums=tuple(range(7)))(*arrays)
    _close(ours[0], np.asarray(out), "out")
    assert len(ours[1]) == len(grads) == len(GRADS)
    for name, x, y in zip(GRADS, ours[1], grads):
        assert x.shape == y.shape, name
        _close(x, np.asarray(y), name)


def _philox_mask(seed, site, rows, cols, p, row0=0):
    """Kept where the top 24 bits of Philox at (row, col, site, 0), times
    2^-24, are >= p; kept values scaled by 1/(1-p)."""
    r = torch.arange(row0, row0 + rows, dtype=torch.int64)[:, None]
    c = torch.arange(cols, dtype=torch.int64)[None, :]
    bits = tdc.philox_bits(seed, r, c, torch.tensor(site), torch.tensor(0))
    return (((bits >> 8).to(torch.float64) / 2 ** 24) >= p).to(torch.float32) / (1.0 - p)


def _composition(m2, m3):
    def fn(h, w1, b1, w2, b2, ls, lb):
        y = tdc.gelu_exact(h @ w1 + b1) * m2
        return tdc.ln(h + (y @ w2 + b2) * m3, ls, lb)
    return fn


def test_ffn_block_dropout_forward_and_backward_share_one_mask():
    """At p = 0.3 the plain twin (autograd) gives the output and the seven
    gradients of a composition with masks built from philox_bits directly,
    sites 2 and 3; and the masks do drop."""
    p, seed = 0.3, 424242
    arrays, g = _inputs(seed=1)
    m2, m3 = _philox_mask(seed, 2, N, DI, p), _philox_mask(seed, 3, N, D, p)
    ours = _grads_torch(lambda *a: tfb.ffn_block(*a, seed, p), arrays, g)
    ref = _grads_torch(_composition(m2, m3), arrays, g)
    _close(ours[0], ref[0], "out")
    for name, x, y in zip(GRADS, ours[1], ref[1]):
        _close(x, y, name)
    no_drop = tfb.ffn_block(*map(torch.from_numpy, arrays), seed, 0.0)
    assert not torch.allclose(torch.from_numpy(ours[0]), no_drop)


@pytest.mark.parametrize("site,cols", [(2, DI), (3, D)])
def test_ffn_block_keep_rate_within_binomial_bounds(site, cols):
    """The share of kept elements of each site within 4 sigma of 1 - p."""
    p, rows = 0.3, 400
    m = tfb.dropout_scale(77, site, 0, rows, cols, p, "cpu")
    n = rows * cols
    rate = (m > 0).float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n), rate


def test_ffn_block_masks_do_not_depend_on_the_row_split():
    """The masks key on the absolute row: the plain twin over 100 rows
    equals the composition with each site's mask drawn in pieces of rows
    (7, 64, 29: aligned to no tile) and put together."""
    p, seed = 0.2, 99
    arrays, _ = _inputs(seed=2)
    pieces = ((0, 7), (7, 64), (71, 29))
    m2 = torch.cat([tfb.dropout_scale(seed, 2, r0, n, DI, p, "cpu") for r0, n in pieces])
    m3 = torch.cat([tfb.dropout_scale(seed, 3, r0, n, D, p, "cpu") for r0, n in pieces])
    assert torch.equal(m2, _philox_mask(seed, 2, N, DI, p))
    ts = [torch.from_numpy(a) for a in arrays]
    torch.testing.assert_close(tfb.ffn_block_plain(*ts, seed, p), _composition(m2, m3)(*ts),
                               rtol=0, atol=0)


def test_ffn_block_wrapper_refuses_a_meta_device():
    meta = lambda *shape: torch.zeros(shape, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfb.ffn_block(meta(N, D), meta(D, DI), meta(DI), meta(DI, D), meta(D), meta(D),
                      meta(D), 0, 0.0)


# -- the model's route -------------------------------------------------------------

VOCAB = (56, 135, 18, 87, 18, 25)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=D, n_layer=2, n_head=2, d_inner=DI,
          attn_chunk=8, dropout=0.0)
CFG, TCFG = C.LinearTransformerConfig(**KW), TC.LinearTransformerConfig(**KW)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree.detach().numpy() if torch.is_tensor(tree) else tree)}


def test_forward_and_train_loss_gradients_match_jax_under_the_pallas_route(monkeypatch):
    """RLMG_FFN_BACKEND=pallas: every layer's post-LN1 half is ffn_block on
    both sides (JAX in interpret mode).  forward_hidden to 1e-4 (the bound
    tests/test_torch_pretrain.py holds for the other routes), the losses to
    1e-5 relative, every parameter's gradient within 1e-5 of its leaf's
    largest; and ffn_block's wrapper ran once per layer."""
    monkeypatch.setenv("RLMG_FFN_BACKEND", "pallas")
    monkeypatch.setenv("RLMG_FFN_INTERPRET", "1")
    monkeypatch.setenv("RLMG_ATTN_BACKEND", "xla")
    jp = jax.tree_util.tree_map(np.asarray, jlt.init_params(jax.random.PRNGKey(5), CFG))
    x, y, m = jds.synthetic_cp_dataset(2, 24, n_class=VOCAB, seed=6)
    tp = tw.from_jax_params(jp, device="cpu")
    calls = []
    real = tfb.ffn_block_plain
    monkeypatch.setattr(tfb, "ffn_block_plain", lambda *a: calls.append(1) or real(*a))
    np.testing.assert_allclose(tlt.forward_hidden(tp, TCFG, torch.from_numpy(x)).numpy(),
                               np.asarray(jlt.forward_hidden(jp, CFG, jnp.asarray(x))),
                               rtol=1e-4, atol=1e-4)
    assert len(calls) == CFG.n_layer

    def jloss(p):
        return jnp.sum(jlt.train_losses(p, CFG, jnp.asarray(x), jnp.asarray(y), jnp.asarray(m),
                                        deterministic=True))

    ref_loss, ref_g = jax.value_and_grad(jloss)(jax.tree_util.tree_map(jnp.asarray, jp))
    loss, _, grads = topt.value_and_grad(
        lambda p: (tlt.train_losses(p, TCFG, torch.from_numpy(x), torch.from_numpy(y),
                                    torch.from_numpy(m), deterministic=True).sum(), None), tp)
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ours, ref = _flat(grads), _flat(jax.tree_util.tree_map(np.asarray, ref_g))
    assert sorted(ours) == sorted(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(ours[k], r, rtol=0, atol=1e-5 * max(float(np.abs(r).max()),
                                                                        1e-6), err_msg=k)
