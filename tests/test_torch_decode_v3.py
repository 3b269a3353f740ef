"""The port's v3 decode step (``ops/decode_kernel_v3.py``) and the odd-head
fused generation that reaches it, against the JAX package, on the CPU.

The CUDA kernel cannot run here: ``fused_stack_step`` takes its plain twin
for CPU tensors, and that is what is held against the JAX Pallas kernel run
with ``interpret=True`` (``decode_step_v3``) or under
``pltpu.force_tpu_interpret_mode`` (inside JAX ``generate_tokens``), at the
tolerances of the JAX package's ``tests/test_decode_kernel_v3.py``.
``tests/test_torch_kernels_gpu.py`` holds the kernel against the twin on a
card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v3 as tdk3
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v6 as tdk6
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.generate import sampler as jsam
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.ops import decode_kernel_v3 as dk3
from reinforcement_learning_in_music_generation_tpu.ops import sampling as jsmp

VOCAB = (8, 10, 6, 12, 6, 7)
# (d_model, n_head): an even head count and an odd one (3 heads of 16)
SHAPES = [(32, 2), (48, 3)]


def _kw(d_model, n_head):
    return dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=d_model, n_head=n_head,
                n_layer=2, d_inner=64, dropout=0.0, max_len=128)


_CACHE = {}


def _both(d_model, n_head):
    """(JAX cfg, port cfg, JAX f32 params, the same params as CPU tensors)."""
    key = (d_model, n_head)
    if key not in _CACHE:
        cfg = C.LinearTransformerConfig(**_kw(d_model, n_head), dtype="float32")
        jp = lt.init_params(jax.random.PRNGKey(0), cfg)
        tp = tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
        _CACHE[key] = (cfg, TC.LinearTransformerConfig(**_kw(d_model, n_head)), jp, tp)
    return _CACHE[key]


@pytest.mark.parametrize("d_model,n_head", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_make_v3_params_equals_jax(d_model, n_head, dtype):
    cfg, tcfg, jp, tp = _both(d_model, n_head)
    jv = dk3.make_v3_params(jp, cfg, dtype=getattr(jnp, dtype))
    tv = tdk3.make_v3_params(tp, tcfg, dtype=getattr(torch, dtype))
    assert set(jv) == set(tv) == set(tdk3.V3_KEYS)
    for k in tdk3.V3_KEYS:
        ref = np.asarray(jv[k].astype(jnp.float32))
        assert tuple(tv[k].shape) == ref.shape, k
        assert (tv[k].dtype == torch.float32) == (jv[k].dtype == jnp.float32), k
        assert tv[k].is_contiguous(), k
        np.testing.assert_array_equal(tv[k].float().numpy(), ref, err_msg=k)


@pytest.mark.parametrize("d_model,n_head", SHAPES)
@pytest.mark.parametrize("wdt", ["float32", "bfloat16"])
def test_decode_step_v3_matches_jax_interpret(d_model, n_head, wdt):
    """Six teacher-forced tokens at B=4, f32 or bf16 weights (make_v3_params'
    dtype on both sides: the matrices in it, the vectors f32; the state is
    f32 either way): h within rtol 2e-4 / atol 2e-5 and the augmented state
    within 1e-4 / 1e-5 of the JAX kernel in interpret mode (the same values
    cast up on both sides; only the sums' order differs)."""
    cfg, tcfg, jp, tp = _both(d_model, n_head)
    jv = dk3.make_v3_params(jp, cfg, dtype=getattr(jnp, wdt))
    tv = tdk3.make_v3_params(tp, tcfg, dtype=getattr(torch, wdt))
    b = 4
    rng = np.random.default_rng(0)
    toks = np.stack([rng.integers(0, v, size=(6, b)) for v in VOCAB], -1).astype(np.int32)
    jst = lt.DecodeState(dk3.init_aug_state(cfg, b), jnp.zeros((1,), jnp.float32),
                         jnp.zeros((), jnp.int32))
    tst = tlt.DecodeState(tdk3.init_aug_state(tcfg, b, "cpu"), torch.zeros(1), 0)
    assert tst.s.dtype == torch.float32 and tuple(tst.s.shape) == tuple(jst.s.shape)
    for t in range(toks.shape[0]):
        jh, jst = dk3.decode_step_v3(jp, jv, cfg, jnp.asarray(toks[t]), jst, interpret=True)
        th, tst = tdk3.decode_step_v3(tp, tv, tcfg, torch.from_numpy(toks[t]), tst)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-5)
    assert tst.step == 6
    np.testing.assert_allclose(tst.s.numpy(), np.asarray(jst.s), rtol=1e-4, atol=1e-5)


def _count(monkeypatch, module, name):
    """Wrap module.name, recording the arguments of each call."""
    calls, real = [], getattr(module, name)

    def wrapped(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_fused_odd_heads_decode_through_v3_with_an_f32_state(monkeypatch):
    """generate_tokens(fused=True) with 3 heads reaches v3's wrapper with an
    f32 (L, H, B, E, E + 1) state, whatever RLMG_DECODE_STATE_DTYPE says,
    and never kernel A's; its greedy f32 stream over 16 tokens equals JAX
    generate_tokens(fused=True) with v3 in interpret mode."""
    monkeypatch.setenv("RLMG_DECODE_STATE_DTYPE", "bfloat16")
    monkeypatch.setenv("RLMG_PREFILL", "0")
    cfg, tcfg, jp, tp = _both(48, 3)
    v3 = _count(monkeypatch, tdk3, "fused_stack_step_plain")
    a = _count(monkeypatch, tdk4, "fused_stack_step_plain")
    b, n = 4, 16
    init = np.asarray([[0, 0, 1, 0, 0, 0], [1, 2, 3, 4, 5, 6], [7, 9, 5, 11, 5, 6],
                       [2, 3, 1, 0, 4, 1]], np.int32)[:, None, :]
    ours = tsam.generate_tokens(tp, tcfg, torch.from_numpy(init), max_tokens=n, greedy=True,
                                settings=tsmp.GREEDY, fused=True)
    assert len(v3) == n + 1 and not a          # the seed token and the n fed back
    s_aug = v3[0][2]
    assert s_aug.dtype == torch.float32
    assert tuple(s_aug.shape) == (2, 3, b, 16, 17)
    with pltpu.force_tpu_interpret_mode():
        ref = jsam.generate_tokens(jp, cfg, jax.random.PRNGKey(0), jnp.asarray(init),
                                   max_tokens=n, greedy=True, settings=tuple(jsmp.GREEDY),
                                   fused=True)
    np.testing.assert_array_equal(ours.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(ours.valid.numpy(), np.asarray(ref.valid))


def test_fused_even_heads_still_decode_through_kernel_a(monkeypatch):
    _, tcfg, _, tp = _both(32, 2)
    v3 = _count(monkeypatch, tdk3, "fused_stack_step_plain")
    a = _count(monkeypatch, tdk4, "fused_stack_step_plain")
    init = torch.zeros((3, 1, 6), dtype=torch.int32)
    tsam.generate_tokens(tp, tcfg, init, max_tokens=4, greedy=True, settings=tsmp.GREEDY,
                         fused=True)
    assert len(a) == 5 and not v3


def test_generate_songs_odd_heads_take_neither_chunked_path(monkeypatch):
    """The JAX rule (sampler :760-763): odd head counts take neither the
    chunked nor the latency path, even when forced; with the fused knob
    they decode through v3."""
    _, tcfg, _, tp = _both(48, 3)
    for var, val in (("RLMG_PERSISTENT_DECODE", "1"), ("RLMG_LATENCY_DECODE", "1"),
                     ("RLMG_FUSED_DECODE", "1"), ("RLMG_PREFILL", "0")):
        monkeypatch.setenv(var, val)
    v3 = _count(monkeypatch, tdk3, "fused_stack_step_plain")
    chunk = _count(monkeypatch, tdk6, "fused_decode_v6_plain")
    gcfg = TC.GenerateConfig(batch_size=3, max_tokens=6, bar_production=None, token_count=6,
                             seed=1)
    songs = tsam.generate_songs(tp, tcfg, gcfg)
    assert len(songs) == 3 and all(s.shape == (7, 6) for s in songs)
    assert v3 and not chunk
