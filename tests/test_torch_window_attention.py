"""The port's window attention against the JAX package's, on the CPU.

``ops/window_attention.py``: the plain compositions (dense, blocked, and
both in the (B, S, H, D) layout, with and without the relative-key term)
against the JAX ones at 1e-5, and the dispatch rule.
``ops/window_attention_kernel.py``: the plain twin of kernel E against the
JAX ``window_attention_pallas`` in interpret mode, at the sizes and
tolerances of tests/test_window_attention_kernel.py (forward 2e-5 on the
rows that see a kept key, q/k/v gradients 5e-5), and what the wrapper
refuses.  The wrapper runs the plain twin for CPU tensors;
``tests/test_torch_kernels_gpu.py`` holds the CUDA kernel against it on a
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch.ops import window_attention as twa
from reinforcement_learning_in_music_generation_torch.ops import window_attention_kernel as twk
from reinforcement_learning_in_music_generation_tpu.ops import window_attention as jwa
from reinforcement_learning_in_music_generation_tpu.ops import window_attention_kernel as jwk

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b=2, h=2, s=160, d=16, seed=0, tail=17):
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((b, h, s, d)).astype(np.float32) for _ in range(3))
    mask = np.ones((b, s), np.float32)
    if tail:
        mask[0, -tail:] = 0.0                      # padding on one song
    return q, k, v, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _bshe(a):
    return np.ascontiguousarray(np.swapaxes(a, 1, 2))


@pytest.mark.parametrize("rel", [False, True])
@pytest.mark.parametrize("window", [16, 50])
def test_plain_compositions_match_jax(rel, window):
    q, k, v, mask = _inputs()
    rel_emb = (np.random.default_rng(1).standard_normal((2 * 8 + 1, 16)) * 0.1
               ).astype(np.float32) if rel else None
    trel = None if rel_emb is None else _t(rel_emb)
    cases = [
        (twa._window_attention_dense(_t(q), _t(k), _t(v), _t(mask), window=window, rel_emb=trel),
         jwa._window_attention_dense(q, k, v, mask, window=window, rel_emb=rel_emb)),
        (twa.window_attention_blocked(_t(q), _t(k), _t(v), _t(mask), window=window,
                                      rel_emb=trel, block=64),
         jwa.window_attention_blocked(q, k, v, mask, window=window, rel_emb=rel_emb,
                                      block=64)),
        (twa._window_dense_bshe(*map(_t, (_bshe(q), _bshe(k), _bshe(v), mask)), window=window,
                                rel_emb=trel),
         jwa._window_dense_bshe(_bshe(q), _bshe(k), _bshe(v), mask, window=window,
                                rel_emb=rel_emb)),
        (twa._window_blocked_bshe(*map(_t, (_bshe(q), _bshe(k), _bshe(v), mask)),
                                  window=window, rel_emb=trel, block=64),
         jwa._window_blocked_bshe(_bshe(q), _bshe(k), _bshe(v), mask, window=window,
                                  rel_emb=rel_emb, block=64)),
    ]
    for i, (ours, ref) in enumerate(cases):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), err_msg=str(i), **TOL)
    np.testing.assert_array_equal(twa.band_mask(20, 3).numpy(), np.asarray(jwa.band_mask(20, 3)))
    assert twa.NEG_INF == jwa.NEG_INF == twk.NEG_INF == jwk.NEG_INF


@pytest.mark.parametrize("window,block", [(50, 64), (64, 64), (100, 64), (128, 64)])
def test_plain_twin_forward_matches_pallas(window, block):
    q, k, v, mask = _inputs()
    out, lse = twk.window_attention_band_plain(_t(q), _t(k), _t(v), _t(mask), window)
    ref = jwk.window_attention_pallas(q, k, v, mask, window, block, True)
    valid = mask[:, None, :, None] > 0
    np.testing.assert_allclose(out.numpy() * valid, np.asarray(ref) * valid, rtol=2e-5,
                               atol=2e-5)
    # the LSE of the plain twin is the log-normaliser of the dense form
    scores = np.einsum("bhqd,bhkd->bhqk", q, k) / 4.0
    scores = scores + np.asarray(jwa.band_mask(160, window // 2))[None, None]
    scores = scores + np.where(mask > 0, 0.0, -1e9)[:, None, None, :]
    ref_lse = np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1)) + scores.max(-1)
    np.testing.assert_allclose(lse.numpy() * valid[..., 0], ref_lse * valid[..., 0],
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("window", [50, 64, 128])
def test_plain_twin_gradients_match_pallas(window):
    q, k, v, mask = _inputs(s=128)
    valid = mask[:, None, :, None] > 0

    def loss_ref(q, k, v):
        o = jwk.window_attention_pallas(q, k, v, mask, window, 64, True)
        return jnp.mean(jnp.square(o * valid))

    ref = jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out = twk.window_attention_band(*ts, _t(mask), window)
    torch.mean(torch.square(out * _t(valid))).backward()
    for t, r, name in zip(ts, ref, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-5, atol=5e-5,
                                   err_msg=f"d{name}")


def test_padding_longer_than_the_window_stays_finite():
    """Rows whose whole band is padding: finite forward and gradients, and
    every row that sees a kept key equal to JAX's (dO zero on padded rows,
    as the LM's masked loss gives)."""
    window, tail = 50, 60                          # w = 25 < 60
    q, k, v, mask = _inputs(tail=tail)
    valid = mask[:, None, :, None] > 0
    ts = [_t(a).requires_grad_(True) for a in (q, k, v)]
    out, lse = twk.window_attention_band_plain(*ts, _t(mask), window)
    torch.sum(out * _t(valid) * 0.01).backward()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    assert all(torch.isfinite(t.grad).all() for t in ts)
    # a row whose band holds no kept key is the uniform average of its band
    w, s = window // 2, q.shape[2]
    for i in (s - 1, s - tail + w + 1):
        band = v[0, :, max(0, i - w):min(s, i + w + 1)].mean(axis=1)
        np.testing.assert_allclose(out[0, :, i].detach().numpy(), band, rtol=1e-5, atol=1e-6)
    ref_fn = lambda q, k, v: jwk.window_attention_pallas(q, k, v, mask, window, 64, True)
    ref = ref_fn(q, k, v)
    np.testing.assert_allclose(out.detach().numpy() * valid, np.asarray(ref) * valid,
                               rtol=2e-5, atol=2e-5)
    ref_g = jax.grad(lambda *a: jnp.sum(ref_fn(*a) * valid * 0.01), argnums=(0, 1, 2))(q, k, v)
    for t, r, name in zip(ts, ref_g, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-5, atol=5e-5,
                                   err_msg=f"d{name}")


def test_pick_blocks_matches_jax():
    for s, window in ((3584, 512), (160, 50), (4096, 700), (100, 8)):
        assert twk.pick_blocks(s, window) == jwk.pick_blocks(s, window)


def _spy(monkeypatch, calls):
    for mod, name in ((twa, "_window_attention_dense"), (twa, "window_attention_blocked"),
                      (twk, "window_attention_band"), (twa, "_window_dense_bshe"),
                      (twa, "_window_blocked_bshe")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name, **kw: calls.append(_n))


@pytest.mark.parametrize("s,window,rel,env,taken", [
    (64, 16, False, "pallas", "_window_attention_dense"),        # s <= threshold
    (160, 100, False, "pallas", "_window_attention_dense"),      # s <= 2 window
    (160, 50, False, None, "window_attention_blocked"),
    (160, 50, False, "pallas", "window_attention_band"),
    (160, 50, True, "pallas", "window_attention_blocked"),       # rel_emb: no kernel
    (1200, 514, False, "pallas", "window_attention_blocked"),    # w = 257 > 256
])
def test_dispatch_follows_the_jax_rule(monkeypatch, s, window, rel, env, taken):
    calls = []
    _spy(monkeypatch, calls)
    if env:
        monkeypatch.setenv("RLMG_WINDOW_BACKEND", env)
    else:
        monkeypatch.delenv("RLMG_WINDOW_BACKEND", raising=False)
    x = torch.zeros((1, 1, s, 4))
    twa.window_attention(x, x, x, None, window=window,
                         rel_emb=torch.zeros((3, 4)) if rel else None, block_threshold=64)
    assert calls == [taken]
    calls.clear()
    xs = torch.zeros((1, s, 1, 4))
    twa.window_attention_bshe(xs, xs, xs, None, window=window, block_threshold=64)
    assert calls == ["_window_blocked_bshe" if taken != "_window_attention_dense"
                     else "_window_dense_bshe"]


def test_wrapper_runs_the_plain_twin_on_cpu_and_refuses_what_the_kernel_does_not_take():
    q, k, v, mask = map(_t, _inputs())
    before = (twk.window_attention_band.launches_fwd, twk.window_attention_band.launches_bwd)
    torch.testing.assert_close(twk.window_attention_band(q, k, v, mask, 50),
                               twk.window_attention_band_plain(q, k, v, mask, 50)[0])
    assert (twk.window_attention_band.launches_fwd,
            twk.window_attention_band.launches_bwd) == before
    with pytest.raises(TypeError, match="float32"):
        twk.window_attention_band(q.double(), k.double(), v.double(), mask, 50)
    for d in (72, 6):                              # wider than 64; not a multiple of 4
        x = torch.zeros((1, 2, 40, d))
        with pytest.raises(ValueError, match="head width"):
            twk.window_attention_band(x, x, x, None, 16)
    with pytest.raises(ValueError, match="mask"):
        twk.window_attention_band(q, k, v, mask[:, :10], 50)
    x = torch.zeros((1, 2, 40, 8))
    with pytest.raises(ValueError, match="strides"):
        twk.window_attention_band(x[..., 1:5], x[..., 1:5], x[..., 1:5], None, 16)
    meta = torch.zeros((1, 2, 40, 8), device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        twk.window_attention_band(meta, meta, meta, None, 16)
