"""Kernel E's plain twin (``ops/window_attention_kernel.py
window_attention_band`` on CPU tensors) against the JAX package's Pallas
``window_attention_pallas`` in interpret mode on bf16 inputs with a padding
mask, on the CPU, and the discriminator LM with bf16 parameters under
RLMG_WINDOW_BACKEND=pallas.

JAX's kernel widens q, k and v to f32, forms the scores, the softmax and
P v in f32, and stores out in the inputs' dtype and the row LSE in f32; its
backward takes dr = sum(g out) in f32 from the stored, rounded out and
stores dq, dk, dv in their inputs' dtype.  The twin computes the same.
Tolerance, as for kernel F's bf16 twin: half a bf16 step at the tensor's
largest magnitude and a mean |diff| within MEAN_SHARE of mean |ref|, out
on the rows that see a kept key (the JAX kernel spreads a row without one
over its block; the LM's masked loss gives dO = 0 there).  The control,
the band attention run in bf16 arithmetic (scores, softmax and products
rounded to bf16), misses the mean share on out and every gradient and the
half step on at least one of them."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.models import longformer as tlf
from reinforcement_learning_in_music_generation_torch.ops import window_attention_kernel as twk
from reinforcement_learning_in_music_generation_tpu.ops import window_attention_kernel as jwk

MEAN_SHARE = 2 ** -12
NAMES = ("out", "dq", "dk", "dv")


def _half_step(ref: np.ndarray) -> float:
    return float(2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 8))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


# (rows, head width, window, padding at the end of the first song): a
# tail shorter than the one-sided window and one longer (w = 50 < 70)
@pytest.mark.parametrize("s,d,window,tail", [(160, 16, 50, 17), (256, 32, 100, 70)])
def test_twin_computes_the_pallas_kernels_bf16_arithmetic(s, d, window, tail):
    r = np.random.default_rng(s + tail)
    q, k, v, g = (r.standard_normal((2, 2, s, d)).astype(np.float32) for _ in range(4))
    mask = np.ones((2, s), np.float32)
    mask[0, -tail:] = 0.0
    valid = mask[:, None, :, None] > 0
    g = g * valid
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    out, vjp = jax.vjp(lambda a, b, c: jwk.window_attention_pallas(
        a, b, c, jnp.asarray(mask), window, 64, True), jb(q), jb(k), jb(v))
    refs = (out, *vjp(jb(g)))

    def run(fn):
        ts = [_bf16(a).requires_grad_(True) for a in (q, k, v)]
        o = fn(*ts, torch.from_numpy(mask), window)
        return (o, *torch.autograd.grad(o, ts, _bf16(g)))

    ours = run(twk.window_attention_band)
    ctl = run(lambda *a: twk.band_plain(*a)[0])
    assert all(x.dtype == torch.bfloat16 for x in ours)
    ctl_fails = []
    for name, x, c, y in zip(NAMES, ours, ctl, refs):
        keep = valid if name == "out" else 1.0
        ref = np.asarray(y.astype(jnp.float32)) * keep
        tol, mean_ref = _half_step(ref), float(np.abs(ref).mean())
        dx = np.abs(x.detach().float().numpy() * keep - ref)
        dc = np.abs(c.detach().float().numpy() * keep - ref)
        assert dx.max() <= tol, f"{name}: max|diff| {dx.max()}, half a bf16 step {tol}"
        assert dx.mean() <= MEAN_SHARE * mean_ref, f"{name}: mean|diff| {dx.mean()}"
        assert dc.mean() > MEAN_SHARE * mean_ref, f"{name}: the control's mean|diff| {dc.mean()}"
        ctl_fails.append(dc.max() > tol)
    assert any(ctl_fails), "the bf16 band attention meets the half step on every tensor"


def test_lse_stays_float32_and_the_wrapper_takes_float32_and_bfloat16_only():
    r = np.random.default_rng(0)
    q, k, v = (_bf16(r.standard_normal((1, 2, 40, 8)).astype(np.float32)) for _ in range(3))
    out, lse = twk.window_attention_band_plain(q, k, v, None, 16)
    ref_out, ref_lse = twk.band_plain(q.float(), k.float(), v.float(), None, 16)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert torch.equal(out, ref_out.bfloat16()) and torch.equal(lse, ref_lse)
    for bad in ((q.half(), k.half(), v.half()), (q, k.float(), v)):
        with pytest.raises(TypeError, match="float32 or bfloat16"):
            twk.window_attention_band(*bad, None, 16)


def test_discriminator_lm_runs_kernel_e_on_bf16_parameters(monkeypatch):
    """The discriminator LM with its parameters cast to bf16 under
    RLMG_WINDOW_BACKEND=pallas (S > 1024 and S > 2 x window, the JAX rule)
    reaches kernel E's wrapper on bf16 tensors in every layer, and its
    masked loss and gradients are finite."""
    monkeypatch.setenv("RLMG_WINDOW_BACKEND", "pallas")
    vocab = (56, 135, 18, 87, 18, 25)
    cfg = TC.discrim_lm_config(vocab, emb_sizes=(8,) * 6, dropout=0.0, n_layer=2, d_model=32,
                               n_head=2, d_inner=64, attention_window=64)
    params = tlt.cast_params(tlf.init_params(cfg, seed=0, device="cpu"), torch.bfloat16)
    calls = []
    real = twk.window_attention_band
    monkeypatch.setattr(twk, "window_attention_band",
                        lambda q, *a: calls.append(q.dtype) or real(q, *a))
    r = np.random.default_rng(1)
    s = 1100
    x = torch.from_numpy(np.stack([r.integers(0, n, (1, s)) for n in vocab], -1))
    mask = torch.ones((1, s))
    mask[0, -30:] = 0.0
    leaves = [t.requires_grad_(True) for t in _leaves(params)]
    logits = tlf.token_logits(params, cfg, x, mask, deterministic=True)
    loss = sum(lg.float().logsumexp(-1).mean() for lg in logits)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert calls == [torch.bfloat16] * cfg.n_layer
    assert torch.isfinite(loss)
    assert all(g is None or bool(torch.isfinite(g.float()).all()) for g in grads)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]
