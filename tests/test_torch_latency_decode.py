"""The port's latency-mode decode (``ops/experimental/decode_kernel_v8.py``,
``decode_kernel_v7.py`` and ``generate/sampler.py generate_tokens_latency``)
against the JAX package, on the CPU.

The CUDA kernel cannot run here: the wrappers take their plain twin
(``decode_kernel_v8.latency_decode_plain``) for CPU tensors, and that is
what is held against the JAX Pallas kernels run in TPU interpret mode
(``pltpu.force_tpu_interpret_mode``), at the small config of the JAX
package's ``tests/test_decode_kernel_v8.py``: with f32 weights, and with
bf16 weights, where JAX's v8 and v7 round each product's input and the
folded embedding to bf16.  ``tests/test_torch_kernels_gpu.py``
holds the kernels against the twin on a card."""

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
from reinforcement_learning_in_music_generation_torch.ops import decode_common as tdc
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v6 as tdk6
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_torch.ops.experimental import (
    decode_kernel_v7 as tdk7, decode_kernel_v8 as tdk8)
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.generate import sampler as jsam
from reinforcement_learning_in_music_generation_tpu.models import common as jcm
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.ops import sampling as jsmp
from reinforcement_learning_in_music_generation_tpu.ops.experimental import (
    decode_kernel_v7 as dk7, decode_kernel_v8 as dk8)

VOCAB = (8, 10, 6, 12, 6, 7)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=32, n_head=2, n_layer=2,
          d_inner=64, dropout=0.0, max_len=128)
CFG = C.LinearTransformerConfig(**KW, dtype="float32")
TCFG = TC.LinearTransformerConfig(**KW)
GREEDY = dict(temps=(1.0,) * 6, topps=(float("inf"),) * 6, greedy=True)
CP_TEMPS = tuple(s.temperature for s in tsmp.CP_SAMPLING)
CP_TOPPS = tuple(s.top_p if s.top_p is not None else float("inf") for s in tsmp.CP_SAMPLING)
PORT = {"v7": tdk7.fused_decode_v7, "v8": tdk8.fused_decode_v8}
JAXK = {"v7": dk7.fused_decode_v7, "v8": dk8.fused_decode_v8}


@pytest.fixture(scope="module")
def both():
    """(JAX params, the same params as torch tensors on the CPU)."""
    jp = lt.init_params(jax.random.PRNGKey(0), CFG)
    return jp, tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _seeded(jp, tp, b=8, n_seed=4, seed=1):
    """Tokens (B, n_seed, 6) from a numpy seed; the f32 states after the
    first n_seed - 1 of them on both sides (JAX pair layout, port layout)."""
    rng = np.random.default_rng(seed)
    toks = np.stack([rng.integers(0, v, size=(b, n_seed)) for v in VOCAB], -1).astype(np.int32)
    js = lt.init_decode_state(CFG, b)
    ts = tlt.init_decode_state(TCFG, b, device="cpu")
    for i in range(n_seed - 1):
        _, js = lt.decode_step(jp, CFG, jnp.asarray(toks[:, i]), js)
        _, ts = tlt.decode_step(tp, TCFG, torch.from_numpy(toks[:, i]), ts)
    return toks, js, ts


def test_resident_params_match_jax_fold_heads_and_layers(both):
    jp, tp = both
    pe = jcm.sinusoidal_table(CFG.max_len, CFG.d_model, jnp.float32)
    jr = dk8.make_resident_params(jp, CFG, pe, dtype=jnp.float32)
    tr = tdk8.make_resident_params(tp, TCFG)
    assert tdk7.make_v7_params is tdk8.make_resident_params and tdk7.V7Params is tdk8.ResidentParams
    memb = np.asarray(jr.memb)
    for f, (v, off) in enumerate(zip(VOCAB, tr.field_off)):
        np.testing.assert_array_equal(tr.m[off:off + v].numpy(),
                                      memb[f * tdc.VF_PAD:f * tdc.VF_PAD + v], err_msg=str(f))
    np.testing.assert_array_equal(tr.head_w.numpy(), np.asarray(jr.whp))
    np.testing.assert_array_equal(tr.head_b.reshape(6, tdc.VF_PAD).numpy(), np.asarray(jr.bhp))
    for ours, ref in ((tr.b_in, jr.binr), (tr.fls, jr.fls), (tr.flb, jr.flb)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref)[0])
    # sin/cos of two libraries: the table agrees to f32 rounding, not bit for bit
    np.testing.assert_allclose(tr.pe.numpy(), np.asarray(jr.pe), rtol=1e-6, atol=1e-6)
    # the layer stack: JAX's head-pair packing of the same values
    L, d, e, P = CFG.n_layer, CFG.d_model, CFG.d_head, CFG.n_head // 2
    qkv = tr.layers["qkv_w"].numpy()
    pair = lambda w: w.reshape(L, d, P, 2 * e).transpose(0, 2, 1, 3)
    packed = np.concatenate([pair(qkv[..., i * d:(i + 1) * d]) for i in range(3)], -1)
    np.testing.assert_array_equal(packed, np.asarray(jr.qkvw))
    np.testing.assert_array_equal(tr.layers["wo"]["w"].numpy().reshape(L, P, 2 * e, d),
                                  np.asarray(jr.wow))
    np.testing.assert_array_equal(tr.layers["ffn1"]["w"].numpy(), np.asarray(jr.f1w))
    np.testing.assert_array_equal(tr.layers["ffn2"]["w"].numpy(), np.asarray(jr.f2w))


@pytest.mark.parametrize("version", ["v8", "v7"])
def test_greedy_chunk_matches_jax_interpret(both, version):
    """f32 weights and state, greedy, T=6, B=8: the port's wrapper on CPU
    tensors (the plain twin) and the JAX Pallas kernel in TPU interpret mode
    emit the same tokens; the states agree within 1e-5 after JAX's
    unpack_state_pair."""
    jp, tp = both
    toks, js, ts = _seeded(jp, tp)
    T, t0 = 6, 3
    pe = jcm.sinusoidal_table(CFG.max_len, CFG.d_model, jnp.float32)
    jr = dk8.make_resident_params(jp, CFG, pe, dtype=jnp.float32)
    s4, z4 = dk8.pack_state_pair(js.s, js.z)
    with pltpu.force_tpu_interpret_mode():
        jt, js4, jz4 = JAXK[version](
            jr, jnp.asarray(toks[:, -1]).T, s4, z4, jnp.int32(t0), jnp.int32(42),
            n_head=CFG.n_head, max_tokens=T, vocab_sizes=VOCAB, **GREEDY)
    tr = tdk8.make_resident_params(tp, TCFG)
    s, z = ts.s.clone(), ts.z.clone()
    ours, s, z = PORT[version](tr, torch.from_numpy(toks[:, -1]), s, z, t0, 42,
                               n_head=2, max_tokens=T, vocab_sizes=VOCAB, eps=CFG.attn_eps,
                               **GREEDY)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(jt).transpose(0, 2, 1))
    js_ref, jz_ref = dk8.unpack_state_pair(js4, jz4)
    np.testing.assert_allclose(s.numpy(), np.asarray(js_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz_ref), rtol=1e-5, atol=1e-5)


# bf16 weights: max|ds| / max|s| after one token.  The twin rounds where JAX
# rounds, but its f32 sums run in another order, so a product input near a
# bf16 rounding boundary can round the other way (a step of 2^-8 of it):
# 3.0e-4 to 4.5e-4 on numpy seeds 1-4; v4's arithmetic (f32 product inputs,
# f32 embedding rows) is 1.1e-3 to 1.75e-3 away.
BF16_STATE_TOL = 6e-4


@pytest.mark.parametrize("version", ["v8", "v7"])
def test_bf16_weights_match_jax_arithmetic(both, version):
    """bf16 weights, f32 state, B=64, one greedy teacher-forced token from a
    state seeded with 3 tokens: the wrapper on CPU tensors (the twin) and
    the JAX Pallas kernel in TPU interpret mode on make_resident_params(...,
    dtype=bf16) end in states within BF16_STATE_TOL of max|s|, and >= 99%
    of the greedy tokens are equal."""
    jp, tp = both
    toks, js, ts = _seeded(jp, tp, b=64)
    pe = jcm.sinusoidal_table(CFG.max_len, CFG.d_model, jnp.float32)
    jr = dk8.make_resident_params(jp, CFG, pe, dtype=jnp.bfloat16)
    s4, z4 = dk8.pack_state_pair(js.s, js.z)
    with pltpu.force_tpu_interpret_mode():
        jt, js4, jz4 = JAXK[version](
            jr, jnp.asarray(toks[:, -1]).T, s4, z4, jnp.int32(3), jnp.int32(42),
            n_head=CFG.n_head, max_tokens=1, vocab_sizes=VOCAB, **GREEDY)
    tr = tdk8.make_resident_params(tp, TCFG, dtype=torch.bfloat16)
    s, z = ts.s.clone(), ts.z.clone()
    ours, s, z = PORT[version](tr, torch.from_numpy(toks[:, -1]), s, z, 3, 42, n_head=2,
                               max_tokens=1, vocab_sizes=VOCAB, eps=CFG.attn_eps, **GREEDY)
    js_ref = np.asarray(dk8.unpack_state_pair(js4, jz4)[0])
    ds = np.abs(s.numpy() - js_ref).max() / np.abs(js_ref).max()
    assert ds <= BF16_STATE_TOL, ds
    assert (ours.numpy() == np.asarray(jt).transpose(0, 2, 1)).mean() >= 0.99


@pytest.mark.parametrize("version", ["v8", "v7"])
def test_plain_twin_is_chunk_invariant_and_samples_the_nucleus(both, version):
    """8 stochastic tokens in one call equal 4 + 4 (the Philox stream depends
    only on the position); every draw is a valid id inside the JAX
    nucleus_mask of its field's tempered softmax."""
    jp, tp = both
    toks, _, ts = _seeded(jp, tp, b=5)
    tr = tdk8.make_resident_params(tp, TCFG)
    kw = dict(n_head=2, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS, eps=CFG.attn_eps)
    tok0 = torch.from_numpy(toks[:, -1])
    s1, z1, s2, z2 = ts.s.clone(), ts.z.clone(), ts.s.clone(), ts.z.clone()
    one, _, _ = PORT[version](tr, tok0, s1, z1, 3, 9, max_tokens=8, **kw)
    first, _, _ = PORT[version](tr, tok0, s2, z2, 3, 9, max_tokens=4, **kw)
    rest, _, _ = PORT[version](tr, first[-1], s2, z2, 7, 9, max_tokens=4, **kw)
    assert torch.equal(one, torch.cat([first, rest]))
    assert torch.equal(s1, s2) and torch.equal(z1, z2)
    # replay the fed tokens through the plain pieces to get each step's logits
    s, z, fed = ts.s.clone(), ts.z.clone(), [tok0] + list(one[:-1])
    for t, tok in enumerate(fed):
        h, s, z = tdk4.fused_stack_step_plain(tr.layers, tdk6.embed_plain(tr, tok, 3 + t), s, z,
                                              n_head=2, eps=CFG.attn_eps)
        logits = (tdc.ln(h, tr.fls, tr.flb) @ tr.head_w + tr.head_b).reshape(5, 6, -1)
        for f, (v, st) in enumerate(zip(VOCAB, tsmp.CP_SAMPLING)):
            draw = one[t, :, f].numpy()
            assert ((draw >= 0) & (draw < v)).all()
            probs = np.asarray(jsmp.softmax_with_temperature(
                jnp.asarray(logits[:, f, :v].numpy()), st.temperature))
            keep = np.ones_like(probs, bool) if st.top_p is None else \
                np.asarray(jsmp.nucleus_mask(jnp.asarray(probs), st.top_p))
            assert keep[np.arange(5), draw].all(), (t, f)


LATENCY_ENVS = [
    {},
    {"RLMG_LATENCY_DECODE": "1"},
    {"RLMG_LATENCY_DECODE": "0", "RLMG_LATENCY_MAX_BATCH": "16"},
    {"RLMG_LATENCY_MAX_BATCH": "8"},
    {"RLMG_LATENCY_MAX_BATCH": "4"},
    {"RLMG_LATENCY_KERNEL": "v7"},
    {"RLMG_LATENCY_KERNEL": "v9"},
]


@pytest.mark.parametrize("env", LATENCY_ENVS, ids=lambda e: ",".join(
    f"{k[5:]}={v}" for k, v in e.items()) or "none")
def test_latency_dispatch_rules_match_jax(env, monkeypatch):
    """The JAX predicates on the CPU backend equal the port's for a CPU
    device; for a CUDA device the port answers as JAX does on a TPU."""
    for var in ("RLMG_LATENCY_DECODE", "RLMG_LATENCY_MAX_BATCH", "RLMG_LATENCY_KERNEL"):
        monkeypatch.delenv(var, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert tsam.latency_max_batch() == jsam.latency_max_batch()
    for batch in (None, 1, 5, 16):
        assert tsam.use_latency_decode("cpu", batch) == jsam.use_latency_decode(batch)
        forced = env.get("RLMG_LATENCY_DECODE")
        on_tpu = forced == "1" if forced is not None else (
            batch is not None and batch <= jsam.latency_max_batch())
        assert tsam.use_latency_decode("cuda", batch) == on_tpu
    if env.get("RLMG_LATENCY_KERNEL") == "v9":
        for fn in (tsam.latency_kernel_version, jsam.latency_kernel_version):
            with pytest.raises(ValueError, match="v7 or v8"):
                fn()
    else:
        assert tsam.latency_kernel_version() == jsam.latency_kernel_version()


@pytest.mark.parametrize("version", ["v8", "v7"])
def test_generate_songs_latency_greedy_equals_per_step(both, version, monkeypatch):
    """RLMG_LATENCY_DECODE=1 takes greedy generate_songs to the latency path
    (the explicit opt-in of the greedy pin); with f32 weights and state its
    songs equal the plain per-step path's, bar stop included."""
    _, tp = both
    gcfg = TC.GenerateConfig(batch_size=5, max_tokens=40, bar_production=3, greedy=True)
    for var in ("RLMG_PERSISTENT_DECODE", "RLMG_FUSED_DECODE", "RLMG_FUSED_SAMPLING",
                "RLMG_LATENCY_DECODE"):
        monkeypatch.delenv(var, raising=False)
    ref = tsam.generate_songs(tp, TCFG, gcfg)
    monkeypatch.setenv("RLMG_LATENCY_DECODE", "1")
    monkeypatch.setenv("RLMG_LATENCY_KERNEL", version)
    monkeypatch.setenv("RLMG_DECODE_STATE_DTYPE", "float32")
    calls = {"latency": 0, version: 0}
    real_lat, real_k = tsam.generate_tokens_latency, PORT[version]

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    monkeypatch.setattr(tsam, "generate_tokens_latency", count("latency", real_lat))
    monkeypatch.setitem(tsam._CHUNK_KERNELS, version, count(version, real_k))
    got = tsam.generate_songs(tp, TCFG, gcfg)
    assert calls["latency"] == 1 and calls[version] >= 1
    assert len(got) == len(ref) == 5
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)


def test_packed_params_are_reused_and_follow_in_place_updates(both):
    """The chunked paths pack the weights once per params object (the JAX
    LRU), and pack them again after an in-place update of a leaf, which
    JAX's immutable arrays never see."""
    _, tp = both
    params = tlt.cast_params(tp, torch.float32)
    params = {k: ({kk: {n: t.clone() for n, t in vv.items()} for kk, vv in v.items()}
                  if k == "layers" else v) for k, v in params.items()}
    first = tsam._packed_decode_params(params, TCFG)
    assert tsam._packed_decode_params(params, TCFG) is first
    wq = params["layers"]["wq"]["w"]
    want = torch.cat([2.0 * wq, params["layers"]["wk"]["w"], params["layers"]["wv"]["w"]], -1)
    wq.mul_(2.0)                                      # an optimizer step, in place
    second = tsam._packed_decode_params(params, TCFG)
    assert second is not first
    assert torch.equal(second.layers["qkv_w"], want)
