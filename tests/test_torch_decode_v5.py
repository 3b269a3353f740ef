"""The port's batch-major persistent decode (``ops/experimental/decode_kernel_v5.py``)
against the JAX package, on the CPU.

JAX's v5 kernel has no interpret mode of its own (its nested
``emit_pipeline`` asks the device for its TPU generation, which the CPU
lacks), so, as in the JAX ``scripts/profile_decode_v5.py``, the f32 parity
reference is the JAX XLA greedy path (``generate_tokens(greedy=True,
fused=False)``) and the plain ``decode_step`` state; with bf16 weights the
twin is held against JAX ``fused_decode_v5`` itself under
``pltpu.force_tpu_interpret_mode()``, with the pipeline's generation lookup
answered by the test.  The pieces the kernel is built from are held against
JAX ``decode_kernel_v5``'s, on the cases of the JAX package's
``tests/test_decode_kernel_v5.py``.  The wrapper takes its
plain twin for CPU tensors; ``tests/test_torch_kernels_gpu.py`` holds the
kernel against it on a card."""

import importlib

import jax
import jax._src.pallas.mosaic.pipeline as jax_pipeline
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import common as tcm
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v6 as tdk6
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_torch.ops.experimental import (
    decode_kernel_v5 as tdk5)
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.generate import sampler as jsam
from reinforcement_learning_in_music_generation_tpu.models import common as jcm
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.ops import sampling as jsmp

dk5 = importlib.import_module(
    "reinforcement_learning_in_music_generation_tpu.ops.experimental.decode_kernel_v5")

VOCAB = (8, 10, 6, 12, 6, 7)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=32, n_head=2, n_layer=2, d_inner=64,
          dropout=0.0, max_len=128)
CFG = C.LinearTransformerConfig(**KW, dtype="float32")
TCFG = TC.LinearTransformerConfig(**KW)
BF16 = torch.bfloat16
GREEDY = dict(temps=(1.0,) * 6, topps=(float("inf"),) * 6, greedy=True)


@pytest.fixture(scope="module")
def both():
    jp = lt.init_params(jax.random.PRNGKey(0), CFG)
    return jp, tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def test_keep_threshold_equals_jax():
    rng = np.random.default_rng(0)
    for trial in range(10):
        logits = rng.normal(size=(4, 37)).astype(np.float32)
        p = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
        for top_p in (0.5, 0.9, 0.99, float("inf")):
            ref = np.asarray(dk5.nucleus_keep_by_threshold(jnp.asarray(p),
                                                           jnp.full((4, 1), top_p)))
            ours = tdk5.nucleus_keep_by_threshold(torch.from_numpy(p),
                                                  torch.full((4, 1), top_p)).numpy()
            np.testing.assert_array_equal(ours, ref, err_msg=f"{trial} {top_p}")
    keep = tdk5.nucleus_keep_by_threshold(torch.tensor([[0.5, 0.3, 0.2, 0.0]]),
                                          torch.full((1, 1), float("inf")))
    np.testing.assert_array_equal(keep.numpy(), [[True, True, True, False]])
    assert tdk5.nucleus_keep_by_threshold is tdk6.nucleus_keep
    assert tdk5.argmax_first is tdk6.argmax_first


def test_argmax_first_equals_jax():
    x = np.asarray([[1.0, 3.0, 3.0, 0.0], [5.0, 2.0, 5.0, 5.0], [-1.0, -1.0, -2.0, -1.0]],
                   np.float32)
    ref = np.asarray(dk5.argmax_first(jnp.asarray(x)))[:, 0]
    np.testing.assert_array_equal(tdk5.argmax_first(torch.from_numpy(x)).numpy(), ref)
    np.testing.assert_array_equal(ref, np.argmax(x, axis=-1))


def test_v5_params_equal_jax_folds_heads_and_layers(both):
    jp, tp = both
    jv = dk5.make_v5_params(jp, CFG, dtype=jnp.float32)
    tv = tdk5.make_v5_params(tp, TCFG, dtype=torch.float32)
    assert tv.m.dtype == torch.float32
    n = sum(VOCAB)
    np.testing.assert_array_equal(tv.m.numpy(), np.asarray(jv.memb)[:n])
    assert not np.asarray(jv.memb)[n:].any()
    assert tv.field_off == tuple(np.concatenate([[0], np.cumsum(VOCAB)[:-1]]))
    np.testing.assert_array_equal(tv.head_w.numpy(), np.asarray(jv.whp))
    np.testing.assert_array_equal(tv.head_b.numpy(), np.asarray(jv.bhp)[0])
    for ours, ref in ((tv.b_in, jv.binr), (tv.fls, jv.fls), (tv.flb, jv.flb)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref)[0])
    lay = tv.layers
    for ours, ref in ((lay["qkv_w"], jv.qkvw), (lay["wo"]["w"], jv.wow),
                      (lay["ffn1"]["w"], jv.f1w), (lay["ffn2"]["w"], jv.f2w)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for ours, ref in ((lay["qkv_b"], jv.qkvb), (lay["wo"]["b"], jv.wob),
                      (lay["ln1"]["scale"], jv.l1s), (lay["ln1"]["bias"], jv.l1b),
                      (lay["ln2"]["scale"], jv.l2s), (lay["ln2"]["bias"], jv.l2b),
                      (lay["ffn1"]["b"], jv.f1b), (lay["ffn2"]["b"], jv.f2b)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref)[:, 0])
    assert tdk5.make_v5_params(tp, TCFG).layers["qkv_w"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v5_operands_are_jax_make_v5_params_weights(both, dtype):
    """The five products' weights the kernel reads (``_product_weights``:
    Wqkv, Wo, W1, W2, the padded heads) are JAX ``make_v5_params``'s: with
    bf16 weights the leaves themselves (one plane), with f32 weights their
    three bf16 planes (``V6Params.planes``, built on the card; here by
    ``weight_planes``), which add up to JAX's f32 weights exactly."""
    jp, tp = both
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, BF16)
    jv = dk5.make_v5_params(jp, CFG, dtype=jdt)
    tv = tdk5.make_v5_params(tp, TCFG, dtype=tdt)
    ws = tdk4.layer_weights(tv.layers)
    if tdt == torch.float32:
        mats = [ws[i] for i in tdk6.PLANE_WEIGHTS] + [tv.head_w]
        tv = tv._replace(planes=tuple(tdk6.weight_planes(m) for m in mats))
    planes, strides = tdk5._product_weights(tv, ws)
    refs = (jv.qkvw, jv.wow, jv.f1w, jv.f2w, jv.whp)
    for pl, stride, ref in zip(planes, strides, refs):
        ref = np.asarray(ref.astype(jnp.float32))
        if tdt == torch.float32:
            assert pl.dtype == BF16 and stride == ref.size
            np.testing.assert_array_equal(((pl[0].float() + pl[1].float()) + pl[2].float()).numpy(),
                                          ref)
        else:
            assert pl.dtype == BF16 and stride == 0
            np.testing.assert_array_equal(pl.float().numpy(), ref)
    if tdt == torch.float32:       # f32 weights without their planes are refused
        with pytest.raises(ValueError, match="planes"):
            tdk5._product_weights(tv._replace(planes=None), ws)


def test_embedding_fold_and_heads_match_the_model(both):
    """sum_f M[off_f + tok_f] + b_in == in_linear(embeddings); the padded
    heads equal the model's head logits, NEG in the padding."""
    _, tp = both
    tv = tdk5.make_v5_params(tp, TCFG, dtype=torch.float32)
    tok = torch.tensor([[1, 2, 3, 4, 5, 6], [0, 0, 1, 0, 0, 0]], dtype=torch.int32)
    ref = tcm.linear(tp["in_linear"], tcm.embed_fields(tp["emb"], tok))
    got = tdk6.embed_plain(tv, tok, 0) - tv.pe[0]
    torch.testing.assert_close(got, ref, rtol=2e-4, atol=2e-4)
    h = torch.randn(3, TCFG.d_model, generator=torch.Generator().manual_seed(2))
    heads = tlt.forward_output(tp, TCFG, h)
    got = h @ tv.head_w + tv.head_b
    for f, v in enumerate(VOCAB):
        torch.testing.assert_close(got[:, f * 256:f * 256 + v], heads[f], rtol=2e-4, atol=2e-4)
        assert (got[:, f * 256 + v:(f + 1) * 256] <= -1e29).all()


def test_pack_unpack_state_equal_jax():
    rng = np.random.default_rng(3)
    s = rng.normal(size=(2, 3, 2, 16, 16)).astype(np.float32)
    z = rng.normal(size=(2, 3, 2, 16)).astype(np.float32)
    js5, jz5 = dk5.pack_state(jnp.asarray(s), jnp.asarray(z))
    ts5, tz5 = tdk5.pack_state(torch.from_numpy(s), torch.from_numpy(z))
    np.testing.assert_array_equal(ts5.numpy(), np.asarray(js5))
    np.testing.assert_array_equal(tz5.numpy(), np.asarray(jz5))
    ts, tz = tdk5.unpack_state(ts5, tz5, 2)
    np.testing.assert_array_equal(ts.numpy(), s)
    np.testing.assert_array_equal(tz.numpy(), z)


def _pe_rows(T):
    return tcm.sinusoidal_table(TCFG.max_len, TCFG.d_model, torch.float32, "cpu")[:T]


def test_plain_v5_greedy_matches_jax_reference(both):
    """Greedy, f32 weights, T=8, B=8: the plain fused_decode_v5 emits the
    tokens of JAX generate_tokens(greedy=True, fused=False); after
    unpack_state its state is within 1e-4 of JAX's decode state after the
    same fed tokens."""
    jp, tp = both
    b, T = 8, 8
    rng = np.random.default_rng(5)
    tok0 = np.stack([rng.integers(0, v, size=b) for v in VOCAB], -1).astype(np.int32)
    tv = tdk5.make_v5_params(tp, TCFG, dtype=torch.float32)
    st = tlt.init_decode_state(TCFG, b, device="cpu")
    s5, z5 = tdk5.pack_state(st.s, st.z)
    toks, s5, z5 = tdk5.fused_decode_v5(tv, torch.from_numpy(tok0), s5, z5, _pe_rows(T), 0,
                                        n_head=2, max_tokens=T, bb=8, vocab_sizes=VOCAB,
                                        eps=CFG.attn_eps, **GREEDY)
    ref = jsam.generate_tokens(jp, CFG, jax.random.PRNGKey(0), jnp.asarray(tok0)[:, None, :],
                               max_tokens=T, greedy=True, settings=tuple(jsmp.GREEDY),
                               fused=False, fused_sampling=True)
    ref_toks = np.asarray(ref.tokens)[:, 1:]
    np.testing.assert_array_equal(toks.numpy().transpose(1, 0, 2), ref_toks)
    js = lt.init_decode_state(CFG, b)
    fed = np.concatenate([tok0[:, None], ref_toks[:, :-1]], axis=1)
    for t in range(T):
        _, js = lt.decode_step(jp, CFG, jnp.asarray(fed[:, t]), js)
    s, z = tdk5.unpack_state(s5, z5, 2)
    np.testing.assert_allclose(s.numpy(), np.asarray(js.s), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(z.numpy(), np.asarray(js.z), rtol=1e-4, atol=1e-4)


def test_plain_v5_samples_in_range_and_equals_kernel_b_plain(both):
    """Stochastic CP sampling: tokens within each field's vocabulary, and the
    stream of kernel B's plain chunk on the unpacked state (pe rows and
    Philox positions from 0)."""
    _, tp = both
    b, T = 16, 6
    temps = tuple(s.temperature for s in tsmp.CP_SAMPLING)
    topps = tuple(s.top_p if s.top_p is not None else float("inf") for s in tsmp.CP_SAMPLING)
    tv = tdk5.make_v5_params(tp, TCFG, dtype=torch.float32)
    tok0 = torch.zeros((b, 6), dtype=torch.int32)
    st = tlt.init_decode_state(TCFG, b, device="cpu")
    s5, z5 = tdk5.pack_state(st.s, st.z)
    toks, _, _ = tdk5.fused_decode_v5(tv, tok0, s5, z5, _pe_rows(T), 11, n_head=2,
                                      max_tokens=T, bb=16, vocab_sizes=VOCAB, temps=temps,
                                      topps=topps, eps=CFG.attn_eps)
    for f, v in enumerate(VOCAB):
        assert ((toks[..., f] >= 0) & (toks[..., f] < v)).all()
    ref, s, _ = tdk6.fused_decode_v6(tv, tok0, st.s.clone(), st.z.clone(), 0, 11, n_head=2,
                                     max_tokens=T, vocab_sizes=VOCAB, temps=temps, topps=topps,
                                     eps=CFG.attn_eps)
    assert torch.equal(toks, ref)
    assert torch.equal(tdk5.unpack_state(s5, z5, 2)[0], s)


# bf16 weights: max|ds| / max|s| after one token against JAX's v5; the
# reason and the measurements are those of test_torch_latency_decode's
# BF16_STATE_TOL (repaired twin 3.0e-4 to 4.5e-4 on numpy seeds 1-4, v4's
# arithmetic 1.1e-3 to 1.4e-3).
BF16_STATE_TOL = 6e-4


def test_bf16_weights_match_jax_v5_interpret(both, monkeypatch):
    """bf16 weights, f32 state, B=64, bb=8, one greedy teacher-forced token
    from a state seeded with 3 tokens: the wrapper on CPU tensors (the twin:
    product inputs rounded to bf16, M in f32) and JAX fused_decode_v5 in TPU
    interpret mode on make_v5_params(..., dtype=bf16) end in states within
    BF16_STATE_TOL of max|s|, and >= 99% of the greedy tokens are equal."""
    jp, tp = both
    b = 64
    rng = np.random.default_rng(1)
    toks = np.stack([rng.integers(0, v, size=(b, 4)) for v in VOCAB], -1).astype(np.int32)
    js = lt.init_decode_state(CFG, b)
    ts = tlt.init_decode_state(TCFG, b, device="cpu")
    for i in range(3):
        _, js = lt.decode_step(jp, CFG, jnp.asarray(toks[:, i]), js)
        _, ts = tlt.decode_step(tp, TCFG, torch.from_numpy(toks[:, i]), ts)
    pe = jcm.sinusoidal_table(CFG.max_len, CFG.d_model, jnp.float32)
    monkeypatch.setattr(jax_pipeline, "_get_tpu_generation", lambda: 5)
    js5, jz5 = dk5.pack_state(js.s, js.z)
    with pltpu.force_tpu_interpret_mode():
        jt, js5, _ = dk5.fused_decode_v5(dk5.make_v5_params(jp, CFG, dtype=jnp.bfloat16),
                                         jnp.asarray(toks[:, -1]), js5, jz5, pe[3:4],
                                         jnp.int32(1), n_head=2, max_tokens=1, bb=8,
                                         vocab_sizes=VOCAB, **GREEDY)
    tv = tdk5.make_v5_params(tp, TCFG, dtype=torch.bfloat16)
    s5, z5 = tdk5.pack_state(ts.s, ts.z)
    pe_rows = torch.from_numpy(np.array(pe[3:4]))
    ours, s5, _ = tdk5.fused_decode_v5(tv, torch.from_numpy(toks[:, -1]), s5, z5, pe_rows, 1,
                                       n_head=2, max_tokens=1, bb=8, vocab_sizes=VOCAB,
                                       eps=CFG.attn_eps, **GREEDY)
    ref = np.asarray(js5)
    ds = np.abs(s5.numpy() - ref).max() / np.abs(ref).max()
    assert ds <= BF16_STATE_TOL, ds
    assert (ours.numpy() == np.asarray(jt)).mean() >= 0.99


@pytest.mark.parametrize("b,bb", [(8, 16), (12, 8), (16, 4), (32, 24)])
def test_bb_must_divide_the_batch(both, b, bb):
    _, tp = both
    tv = tdk5.make_v5_params(tp, TCFG, dtype=torch.float32)
    st = tlt.init_decode_state(TCFG, b, device="cpu")
    s5, z5 = tdk5.pack_state(st.s, st.z)
    with pytest.raises(ValueError, match="bb="):
        tdk5.fused_decode_v5(tv, torch.zeros((b, 6), dtype=torch.int32), s5, z5, _pe_rows(2),
                             0, n_head=2, max_tokens=2, bb=bb, vocab_sizes=VOCAB,
                             eps=CFG.attn_eps, **GREEDY)
