"""The port's recurrent decode and its two kernels' plain versions against
the JAX package, on the CPU.

The CUDA kernels themselves cannot run here: their wrappers take the plain
PyTorch version for CPU tensors, and that version is what is held against
the JAX functions (the Pallas kernels in interpret mode, or the JAX
package's own reference pieces).  ``tests/test_torch_kernels_gpu.py``
holds the kernels against the plain versions where a card is present;
``chip_smoke.py`` does the same at the full model width."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import common as tcm
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import decode_common as tdc
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v6 as tdk6
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.models import common as jcm
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.ops import decode_common as jdc
from reinforcement_learning_in_music_generation_tpu.ops import decode_kernel_v4 as dk4
from reinforcement_learning_in_music_generation_tpu.ops import decode_kernel_v6 as dk6
from reinforcement_learning_in_music_generation_tpu.ops import sampling as jsmp

VOCAB = (56, 135, 18, 87, 18, 25)
CFG = C.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=32,
                                n_layer=2, n_head=2, d_inner=64, max_len=256)
TCFG = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=32,
                                  n_layer=2, n_head=2, d_inner=64, max_len=256)
CP_TEMPS = tuple(s.temperature for s in tsmp.CP_SAMPLING)
CP_TOPPS = tuple(s.top_p if s.top_p is not None else float("inf") for s in tsmp.CP_SAMPLING)


@pytest.fixture(scope="module")
def both():
    """(JAX params, the same params as torch tensors on the CPU)."""
    jp = lt.init_params(jax.random.PRNGKey(0), CFG)
    return jp, tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _tokens(seed, steps, b):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, size=(steps, b)) for v in VOCAB], -1).astype(np.int32)


def test_decode_step_matches_jax(both):
    jp, tp = both
    toks = _tokens(0, 8, 3)
    js, ts = lt.init_decode_state(CFG, 3), tlt.init_decode_state(TCFG, 3, device="cpu")
    for t in range(8):
        jh, js = lt.decode_step(jp, CFG, jnp.asarray(toks[t]), js)
        th, ts = tlt.decode_step(tp, TCFG, torch.from_numpy(toks[t]), ts)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.s.numpy(), np.asarray(js.s), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ts.z.numpy(), np.asarray(js.z), rtol=1e-5, atol=1e-5)
    assert ts.step == int(js.step) == 8


def test_make_decode_params_and_fused_logits_match_jax(both):
    jp, tp = both
    jd, td = lt.make_decode_params(jp, CFG), tlt.make_decode_params(tp, TCFG)
    for k in ("qkv_w", "qkv_b", "head_w", "head_b"):
        np.testing.assert_array_equal(td[k].numpy(), np.asarray(jd[k]), err_msg=k)
    h = np.random.default_rng(1).normal(size=(4, 32)).astype(np.float32)
    for a, b in zip(tlt.fused_logits(td, TCFG, torch.from_numpy(h)),
                    lt.fused_logits(jd, CFG, jnp.asarray(h))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    for a, b in zip(tlt.forward_output(tp, TCFG, torch.from_numpy(h)),
                    lt.forward_output(jp, CFG, jnp.asarray(h))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def _bf16_matrices(td: dict) -> dict:
    """make_decode_params' dict with the four weight matrices in bf16 and
    the vectors in f32: what JAX make_v4_params(dtype=bfloat16) holds."""
    out = dict(td, qkv_w=td["qkv_w"].to(torch.bfloat16))
    for k in ("wo", "ffn1", "ffn2"):
        out[k] = dict(td[k], w=td[k]["w"].to(torch.bfloat16))
    return out


# (weights, state, rtol/atol of h, of the state).  f32 weights and state:
# the tolerances of tests/test_decode_kernel_v3.py (the two sides sum in
# other orders).  bf16 weights: the same values cast up on both sides, so
# the same tolerances.  bf16 state: both sides round the same f32 sums on
# store; a sum the two orders left on either side of a rounding boundary
# would store one bf16 step apart, so the state is held to 2^-8 relative
# (here every stored value agrees, and h within 7.2e-7).
V4_CASES = [("float32", "float32", (2e-4, 2e-5), (2e-4, 2e-5)),
            ("bfloat16", "float32", (2e-4, 2e-5), (2e-4, 2e-5)),
            ("bfloat16", "bfloat16", (2e-4, 2e-5), (4e-3, 2e-5))]


@pytest.mark.parametrize("wdt,sdt,h_tol,s_tol", V4_CASES)
def test_plain_decode_step_v4_matches_pallas_interpret(both, wdt, sdt, h_tol, s_tol):
    """Kernel A's plain version against the Pallas v4 kernel in interpret
    mode at the dtypes the port runs: f32 or bf16 weights (JAX
    make_v4_params' dtype), f32 or bf16 state."""
    jp, tp = both
    b = 4
    v4p = dk4.make_v4_params(jp, CFG, dtype=getattr(jnp, wdt))
    jst = dk4.init_pair_state(CFG, b, dtype=getattr(jnp, sdt))
    td = tlt.make_decode_params(tp, TCFG)
    if wdt == "bfloat16":
        td = _bf16_matrices(td)
    tst = tdk4.init_state(TCFG, b, getattr(torch, sdt), "cpu")
    toks = _tokens(1, 6, b)
    for t in range(6):
        jh, jst = dk4.decode_step_v4(jp, v4p, CFG, jnp.asarray(toks[t]), jst, interpret=True)
        th, tst = tdk4.decode_step_v4(tp, td, TCFG, torch.from_numpy(toks[t]), tst)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=h_tol[0], atol=h_tol[1])
    L, P, e = CFG.n_layer, CFG.n_head // 2, CFG.d_head
    s4 = np.asarray(jst.s.astype(jnp.float32)).reshape(L, P, b, e, 2, e).transpose(
        0, 2, 1, 4, 3, 5)
    z4 = np.asarray(jst.z.astype(jnp.float32)).reshape(L, P, b, 2, e).transpose(0, 2, 1, 3, 4)
    np.testing.assert_allclose(tst.s.float().numpy(), s4.reshape(L, b, CFG.n_head, e, e),
                               rtol=s_tol[0], atol=s_tol[1])
    np.testing.assert_allclose(tst.z.float().numpy(), z4.reshape(L, b, CFG.n_head, e),
                               rtol=s_tol[0], atol=s_tol[1])


def test_plain_twin_sums_ln1_as_the_jax_kernel(both, monkeypatch):
    """LN1's input is (h + att Wo) + bo, JAX v4's ``hf + ao_scr[...] +
    wob_ref[0, 0]``: ln1_input equals that expression in jnp bit for bit on
    values where the other order, h + (att Wo + bo), differs; and the twin
    forms LN1's input through ln1_input, once a layer."""
    rng = np.random.default_rng(11)
    h = rng.normal(size=(64, 32)).astype(np.float32) * 1e3
    ao = rng.normal(size=(64, 32)).astype(np.float32)
    bo = rng.normal(size=(32,)).astype(np.float32) * 1e-3
    jax_order = np.asarray(jnp.asarray(h) + jnp.asarray(ao) + jnp.asarray(bo))
    ours = tdk4.ln1_input(torch.from_numpy(h), torch.from_numpy(ao), torch.from_numpy(bo))
    np.testing.assert_array_equal(ours.numpy(), jax_order)
    other = (torch.from_numpy(h) + (torch.from_numpy(ao) + torch.from_numpy(bo))).numpy()
    assert (other != jax_order).any()            # the orders can be told apart here
    _, tp = both
    seen, real = [], tdk4.ln1_input
    monkeypatch.setattr(tdk4, "ln1_input", lambda *a: seen.append(a) or real(*a))
    td = tlt.make_decode_params(tp, TCFG)
    st = tdk4.init_state(TCFG, 2, torch.float32, "cpu")
    tdk4.fused_stack_step_plain(td, torch.from_numpy(h[:2]), st.s, st.z, n_head=2)
    assert len(seen) == CFG.n_layer
    assert torch.equal(seen[0][0], torch.from_numpy(h[:2]))


def test_pack_fragments_follow_the_mma_layout():
    """pack_fragments' (L, N/8, Kp/32, 32, 8) values are the B fragments of
    mma.m16n8k16 (lane l = 4 g + t, depth step s: rows k0 + 2t, +1, +8, +9
    of column 8 j + g, k0 = 32 c + 16 s), K padded with zeros to 32."""
    rng = np.random.default_rng(12)
    w = torch.from_numpy(rng.normal(size=(2, 40, 24)).astype(np.float32))
    p = tdk4.pack_fragments(w)
    assert tuple(p.shape) == (2, 3, 2, 32, 8)
    wp = torch.nn.functional.pad(w, (0, 0, 0, 24))
    for l, j, c, lane in ((0, 0, 0, 0), (1, 2, 1, 31), (0, 1, 1, 13), (1, 0, 0, 6)):
        g, t = lane // 4, lane % 4
        for sidx in range(2):
            k0 = 32 * c + 16 * sidx + 2 * t
            want = [wp[l, k, 8 * j + g] for k in (k0, k0 + 1, k0 + 8, k0 + 9)]
            assert p[l, j, c, lane, 4 * sidx:4 * sidx + 4].tolist() == [x.item() for x in want]
    assert (p[:, :, 1, :, :].abs().sum() > 0) and tdk4.pack_fragments(w[:, :32]).shape[2] == 1


def test_embed_input_at_a_device_position_equals_the_int_position(both):
    """embed_input with the position as a 0-d tensor (what the per-step
    CUDA graph replays) gives the int position's rows bit for bit."""
    _, tp = both
    tok = torch.from_numpy(_tokens(13, 1, 3)[0])
    pe = tcm.sinusoidal_table(TCFG.max_len, TCFG.d_model, torch.float32, "cpu")
    for step in (0, 1, 17, TCFG.max_len - 1):
        a = tlt.embed_input(tp, TCFG, tok, step, pe)
        b = tlt.embed_input(tp, TCFG, tok, torch.tensor(step), pe)
        assert torch.equal(a, b), step
    assert torch.equal(tlt.embed_input(tp, TCFG, tok, torch.tensor(5), None),
                       tlt.embed_input(tp, TCFG, tok, 5, None))


def test_fused_stack_step_checks_its_inputs(both):
    _, tp = both
    td = tlt.make_decode_params(tp, TCFG)
    st = tdk4.init_state(TCFG, 2, torch.float32, "cpu")
    h = torch.zeros((2, 32))
    with pytest.raises(ValueError, match="no kernel"):
        tdk4.fused_stack_step(td, h.to("meta"), st.s, st.z, n_head=2)
    with pytest.raises(ValueError, match="state"):
        tdk4._check_inputs(tdk4.layer_weights(td), h, st.s[:, :1], st.z, 2)
    with pytest.raises(TypeError, match="h0"):
        tdk4._check_inputs(tdk4.layer_weights(td), h.double(), st.s, st.z, 2)


@pytest.mark.parametrize("d_model,n_head,ok", [(48, 4, False), (48, 3, True),
                                                (2056, 8, False)])
def test_chunk_kernels_keep_their_head_width_rule(d_model, n_head, ok):
    """The input check that kernels B, v5, v8 and v7 share refuses what their
    kernels do not take: a head width not dividing 256 (12 at 48 / 4) or
    above 128, or d_model above 2048 (a width kernel A refuses too, for its
    own reasons, and checks through its library)."""
    cfg = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(4,) * 6, d_model=d_model,
                                     n_layer=1, n_head=n_head, d_inner=16)
    dp = tlt.make_decode_params(tlt.init_params(cfg, seed=0, device="cpu"), cfg)
    st = tdk4.init_state(cfg, 2, torch.float32, "cpu")
    h = torch.zeros((2, d_model))
    if ok:
        assert tdk4._check_inputs(tdk4.layer_weights(dp), h, st.s, st.z, n_head)[2] == d_model
    else:
        with pytest.raises(ValueError, match="head width"):
            tdk4._check_inputs(tdk4.layer_weights(dp), h, st.s, st.z, n_head)


def test_v6_params_match_jax_fold_and_heads(both):
    jp, tp = both
    pe = jcm.sinusoidal_table(CFG.max_len, CFG.d_model, jnp.float32)
    jv = dk6.make_v6_params(jp, CFG, pe, dtype=jnp.float32)
    tv = tdk6.make_v6_params(tp, TCFG)
    n = sum(VOCAB)
    np.testing.assert_allclose(tv.m.numpy(), np.asarray(jv.membT).T[:n], rtol=1e-5, atol=1e-5)
    assert tv.field_off == tuple(np.cumsum((0,) + VOCAB[:-1]).tolist())
    np.testing.assert_array_equal(tv.b_in.numpy(), np.asarray(jv.binrT)[:, 0])
    np.testing.assert_array_equal(tv.head_w.numpy(), np.asarray(jv.whpT).T)
    np.testing.assert_array_equal(tv.head_b.numpy(), np.asarray(jv.bhpT)[:, 0])
    np.testing.assert_array_equal(tv.fls.numpy(), np.asarray(jv.flsT)[:, 0])
    np.testing.assert_allclose(tv.pe.numpy(), np.asarray(jv.pe), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.99, float("inf")])
def test_nucleus_keep_matches_jax(top_p):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(3, 37, 5)).astype(np.float32) * 2
    p = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    ref = np.asarray(dk6.nucleus_keep_sub(jnp.asarray(p), jnp.full((3, 1, 1), top_p)))
    ours = tdk6.nucleus_keep(torch.from_numpy(p.transpose(0, 2, 1).copy()),
                             torch.full((3, 1, 1), top_p))
    np.testing.assert_array_equal(ours.numpy(), ref.transpose(0, 2, 1))


def test_argmax_first_matches_jax():
    x = np.asarray([[[1.0, 5.0], [3.0, 2.0], [3.0, 5.0], [0.0, 1.0]]], np.float32)
    ref = np.asarray(dk6.argmax_first_sub(jnp.asarray(x)))[:, 0, :]
    ours = tdk6.argmax_first(torch.from_numpy(x.transpose(0, 2, 1).copy()))
    np.testing.assert_array_equal(ours.numpy(), ref)
    np.testing.assert_array_equal(ours.numpy(), [[1, 0]])


def test_gumbel_from_bits_matches_jax():
    bits = np.random.default_rng(3).integers(0, 2 ** 32, size=4096, dtype=np.uint64)
    bits[:2] = (0, 2 ** 32 - 1)
    ref = np.asarray(jdc.gumbel_from_bits(jnp.asarray(bits.astype(np.uint32))))
    ours = tdc.gumbel_from_bits(torch.from_numpy(bits.astype(np.int64))).numpy()
    # the top bits round u to 1.0 in f32 and give +inf on both sides
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)
    assert np.isinf(ours[1]) and np.isfinite(ours[2:]).all()


def _philox_ref(ctr, key):
    """Philox4x32-10 on Python ints: the Random123 definition."""
    m0, m1, w0, w1, mask = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85, 0xFFFFFFFF
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + w0) & mask, (k1 + w1) & mask
        p0, p1 = m0 * c0, m1 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & mask, (p0 >> 32) ^ c3 ^ k1, p0 & mask)
    return c0, c1, c2, c3


def test_philox_known_answers_and_torch_bits():
    """The reference against Random123's known-answer vectors, then the
    torch integer version (the plain side of the chunk kernel's bits)
    against the reference."""
    kat = [((0, 0, 0, 0), (0, 0), 0x6627E8D5),
           ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, 0x408F276D),
           ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
            0xD16CFE09)]
    for ctr, key, first in kat:
        assert _philox_ref(ctr, key)[0] == first
    rng = np.random.default_rng(4)
    ctrs = rng.integers(0, 2 ** 32, size=(64, 4), dtype=np.uint64).astype(np.int64)
    seed = 123456789
    got = tdc.philox_bits(seed, *(torch.from_numpy(ctrs[:, i]) for i in range(4))).numpy()
    ref = [_philox_ref(tuple(int(c) for c in row), (seed, tdc.PHILOX_KEY1))[0] for row in ctrs]
    np.testing.assert_array_equal(got, ref)


def test_plain_v6_greedy_chunk_matches_jax_scan(both):
    """Kernel B's plain version, greedy, f32 state: the same tokens as a
    JAX decode_step + per-field argmax scan over 32 steps."""
    jp, tp = both
    b, T = 4, 32
    tok0 = _tokens(5, 1, b)[0]
    tv = tdk6.make_v6_params(tp, TCFG)
    st = tdk4.init_state(TCFG, b, torch.float32, "cpu")
    ours, _, _ = tdk6.fused_decode_v6(
        tv, torch.from_numpy(tok0), st.s, st.z, 0, 0, n_head=2, max_tokens=T,
        vocab_sizes=VOCAB, temps=(1.0,) * 6, topps=(float("inf"),) * 6, greedy=True,
        eps=CFG.attn_eps)
    js, tok, ref = lt.init_decode_state(CFG, b), jnp.asarray(tok0), []
    for _ in range(T):
        h, js = lt.decode_step(jp, CFG, tok, js)
        tok = jnp.stack([jnp.argmax(lg, -1) for lg in lt.forward_output(jp, CFG, h)], -1)
        ref.append(np.asarray(tok))
    np.testing.assert_array_equal(ours.numpy(), np.stack(ref))


def test_plain_v6_chunk_invariance_and_sampling_support(both):
    _, tp = both
    b = 3
    tv = tdk6.make_v6_params(tp, TCFG)
    tok0 = torch.from_numpy(_tokens(6, 1, b)[0])
    kw = dict(n_head=2, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS, eps=CFG.attn_eps)
    s1 = tdk4.init_state(TCFG, b, device="cpu")
    s2 = tdk4.init_state(TCFG, b, device="cpu")
    one, _, _ = tdk6.fused_decode_v6(tv, tok0, s1.s, s1.z, 0, 11, max_tokens=12, **kw)
    first, _, _ = tdk6.fused_decode_v6(tv, tok0, s2.s, s2.z, 0, 11, max_tokens=5, **kw)
    rest, _, _ = tdk6.fused_decode_v6(tv, first[-1], s2.s, s2.z, 5, 11, max_tokens=7, **kw)
    assert torch.equal(one, torch.cat([first, rest]))
    assert torch.equal(s1.s, s2.s) and torch.equal(s1.z, s2.z)
    assert (one >= 0).all() and (one < torch.tensor(VOCAB, dtype=torch.int32)).all()


def test_plain_heads_sample_follows_nucleus_and_temperature(both):
    """The plain heads + sample pass samples from the nucleus of the
    tempered softmax: every draw lies in the JAX nucleus_mask, and the
    draw frequencies follow the kept, renormalized probabilities."""
    _, tp = both
    tv = tdk6.make_v6_params(tp, TCFG)
    h = torch.from_numpy(np.random.default_rng(7).normal(size=(1, 32)).astype(np.float32))
    hb = h.expand(2000, -1).contiguous()
    draws = tdk6.heads_sample(tv, hb, seed=3, pos=0, temps=CP_TEMPS, topps=CP_TOPPS).numpy()
    logits = (tdc.ln(h, tv.fls, tv.flb) @ tv.head_w + tv.head_b).reshape(6, -1)
    for f, (v, st) in enumerate(zip(VOCAB, tsmp.CP_SAMPLING)):
        probs = np.asarray(jsmp.softmax_with_temperature(
            jnp.asarray(logits[f, :v].numpy()), st.temperature))
        keep = np.ones(v, bool) if st.top_p is None else \
            np.asarray(jsmp.nucleus_mask(jnp.asarray(probs), st.top_p))
        assert keep[draws[:, f]].all(), f
        expect = np.where(keep, probs, 0) / probs[keep].sum()
        freq = np.bincount(draws[:, f], minlength=v) / len(draws)
        assert np.abs(freq - expect).max() < 0.05, f


@pytest.mark.parametrize("greedy", [False, True])
def test_sample_fields_fused_matches_jax_with_shared_uniforms(greedy):
    rng = np.random.default_rng(8)
    cat = rng.normal(size=(64, sum(VOCAB))).astype(np.float32) * 2
    u = rng.random(size=(64, 6)).astype(np.float32)
    ref = np.asarray(jsmp.sample_fields_fused(None, jnp.asarray(cat), VOCAB, jsmp.CP_SAMPLING,
                                              greedy=greedy, uniforms=jnp.asarray(u)))
    ours = tsmp.sample_fields_fused(None, torch.from_numpy(cat), VOCAB, tsmp.CP_SAMPLING,
                                    greedy=greedy, uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(ours.numpy(), ref)
    per_field = torch.split(torch.from_numpy(cat), list(VOCAB), dim=-1)
    np.testing.assert_array_equal(
        tsmp.sample_fields(None, per_field, tsmp.CP_SAMPLING, greedy=greedy,
                           uniforms=torch.from_numpy(u)).numpy(), ref)


def test_softmax_and_nucleus_mask_match_jax():
    rng = np.random.default_rng(9)
    logits = rng.normal(size=(8, 40)).astype(np.float32) * 3
    for t in (1.0, 1.2, 5.0):
        np.testing.assert_allclose(
            tsmp.softmax_with_temperature(torch.from_numpy(logits), t).numpy(),
            np.asarray(jsmp.softmax_with_temperature(jnp.asarray(logits), t)),
            rtol=1e-5, atol=1e-7)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    for p in (0.5, 0.9, 0.99):
        np.testing.assert_array_equal(
            tsmp.nucleus_mask(torch.from_numpy(probs), p).numpy(),
            np.asarray(jsmp.nucleus_mask(jnp.asarray(probs), p)))
