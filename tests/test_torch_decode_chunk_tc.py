"""Kernel B's tensor-core route and the split of its plain twin, on the CPU.

Kernel B (``csrc/decode_chunk.cu`` + ``decode_chunk_tc.cuh``) computes JAX
v6's arithmetic: every product's input activations are rounded to the
weights' type, the sums stay f32 (JAX ``ops/decode_kernel_v6.py`` :255,
:286, :292, :296, :331).  With f32 weights that rounding is a no-op and the
kernel takes each product at f32 grade, from three bf16 planes of each
operand (``weight_planes``; six bf16 products a product).  Its plain twin ``fused_decode_v6_plain``
does the same, and so do the twins of v8, v7 and v5, which round where
JAX's v8, v7 and v5 round (v8 and v7 also the folded embedding).  The kernel
itself runs only on a card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py`` phase 2b); here the twins are held against the JAX
package: a JAX composition of v6's products from the JAX ``make_v6_params``,
and JAX's XLA ``decode_step``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.ops import decode_common as tdc
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v6 as tdk6
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_torch.ops.experimental import (
    decode_kernel_v5 as tdk5, decode_kernel_v7 as tdk7, decode_kernel_v8 as tdk8)
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt
from reinforcement_learning_in_music_generation_tpu.ops import decode_kernel_v3 as dk3
from reinforcement_learning_in_music_generation_tpu.ops import decode_kernel_v6 as dk6

VOCAB = (56, 135, 18, 87, 18, 25)
KW = dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=64, n_layer=3, n_head=2, d_inner=128,
          max_len=256)
CFG = C.LinearTransformerConfig(**KW)
TCFG = TC.LinearTransformerConfig(**KW)
GREEDY = dict(temps=(1.0,) * 6, topps=(float("inf"),) * 6, greedy=True)
CP = dict(temps=tuple(s.temperature for s in tsmp.CP_SAMPLING),
          topps=tuple(s.top_p if s.top_p is not None else float("inf")
                      for s in tsmp.CP_SAMPLING))
BF16 = torch.bfloat16


@pytest.fixture(scope="module")
def both():
    """(JAX params rounded to bf16 values and held in f32, the same as torch
    tensors): both sides then read identical bf16 weights, and JAX's
    make_v6_params keeps the biases and LN vectors at those same values."""
    jp = lt.init_params(jax.random.PRNGKey(3), CFG)
    jp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16).astype(jnp.float32), jp)
    return jp, tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")


def _tokens(seed, steps, b):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, v, size=(steps, b)) for v in VOCAB], -1).astype(np.int32)


def _state(seed, b, dtype=torch.float32):
    """A nonzero decode state: S normal, z positive (a sum of phi(k) > 0)."""
    rng = np.random.default_rng(seed)
    e = TCFG.d_model // TCFG.n_head
    s = rng.normal(size=(TCFG.n_layer, b, TCFG.n_head, e, e)).astype(np.float32)
    z = rng.uniform(0.5, 2.0, size=(TCFG.n_layer, b, TCFG.n_head, e)).astype(np.float32)
    return torch.from_numpy(s).to(dtype), torch.from_numpy(z).to(dtype)


@pytest.mark.parametrize("greedy", [True, False])
def test_f32_weights_keep_the_twin_bit_for_bit(both, greedy):
    """(a) With f32 weights v6's casts are no-ops: the v6 twin equals v4's
    arithmetic composed from the plain per-token pieces (embedding, the
    unrounded layer stack, heads and sampling), and so does the latency
    twin, whose embedding rounding is a no-op too: same tokens and state,
    bit for bit (0 tolerance)."""
    _, tp = both
    tv = tdk6.make_v6_params(tp, TCFG, dtype=torch.float32)
    tok0 = torch.from_numpy(_tokens(1, 1, 4)[0])
    mode = GREEDY if greedy else CP
    s1, z1 = _state(2, 4)
    s2, z2 = s1.clone(), z1.clone()
    s3, z3 = s1.clone(), z1.clone()
    a, _, _ = tdk6.fused_decode_v6_plain(tv, tok0, s1, z1, 3, 9, n_head=2, max_tokens=6, **mode)
    c, _, _ = tdk8.latency_decode_plain(tv, tok0, s3, z3, 3, 9, n_head=2, max_tokens=6, **mode)
    tok, rows = tok0, []
    for t in range(6):
        h, s2, z2 = tdk4.fused_stack_step_plain(tv.layers, tdk6.embed_plain(tv, tok, 3 + t), s2,
                                                z2, n_head=2)
        tok = tdk6.heads_sample_plain(tv, h, seed=9, pos=3 + t, **mode)
        rows.append(tok)
    b = torch.stack(rows)
    assert torch.equal(a, b) and torch.equal(s1, s2) and torch.equal(z1, z2)
    assert torch.equal(c, b) and torch.equal(s3, s2) and torch.equal(z3, z2)


def _jax_v6_step(jv, tok, s, z, pos, n_head, eps):
    """One token of v6's arithmetic composed in JAX from the JAX
    make_v6_params (transposed weights, (rows, 128) lane-replicated
    columns), batch-major: every product jnp.dot(x.astype(bf16), w,
    preferred_element_type=f32).  Returns (h after the layer stack, logits
    (B, NF*VF_PAD), s, z)."""
    f32, bf = jnp.float32, jnp.bfloat16
    col = lambda slab: slab[..., 0]
    dot = lambda x, wT: jnp.dot(x.astype(bf), wT.T, preferred_element_type=f32)
    ln = lambda x, sc, bi: dk6._lnT(x.T, sc[:, None], bi[:, None]).T
    offs = np.concatenate([[0], np.cumsum(VOCAB)[:-1]])
    m = jv.membT.T
    h = sum(m[offs[f] + tok[:, f]] for f in range(len(VOCAB))) + col(jv.binrT) + jv.pe[pos]
    b, d = h.shape
    e = d // n_head
    s_out, z_out = [], []
    for l in range(jv.qkvwT.shape[0]):
        qkv = dot(h, jv.qkvwT[l]) + col(jv.qkvbT[l])
        q = dk3._phi(qkv[:, :d]).reshape(b, n_head, e)
        k = dk3._phi(qkv[:, d:2 * d]).reshape(b, n_head, e)
        v = qkv[:, 2 * d:].reshape(b, n_head, e)
        sn = s[l] + k[..., :, None] * v[..., None, :]
        zn = z[l] + k
        s_out.append(sn)
        z_out.append(zn)
        num = jnp.einsum("bhj,bhju->bhu", q, sn)
        den = (q * zn).sum(-1) + eps
        att = (num / den[..., None]).reshape(b, d)
        h1 = ln(h + dot(att, jv.wowT[l]) + col(jv.wobT[l]), col(jv.l1sT[l]), col(jv.l1bT[l]))
        y = dk3._gelu_exact(dot(h1, jv.f1wT[l]) + col(jv.f1bT[l]))
        h = ln(h1 + dot(y, jv.f2wT[l]) + col(jv.f2bT[l]), col(jv.l2sT[l]), col(jv.l2bT[l]))
    hf = ln(h, col(jv.flsT), col(jv.flbT))
    logits = dot(hf, jv.whpT) + col(jv.bhpT)
    return h, logits, jnp.stack(s_out), jnp.stack(z_out)


def test_bf16_twin_step_matches_a_jax_composition_of_v6(both):
    """(b) One decode step with bf16 weights: the twin's layer stack output
    within 1e-5 of max|h| of the JAX composition of v6's products (both
    round the same f32 activations to bf16 and sum exact bf16 products in
    f32, in another order: the reorder is the only difference), the state
    within 1e-5 of its magnitude, and the greedy tokens equal."""
    jp, tp = both
    b, pos = 4, 5
    tv = tdk6.make_v6_params(tp, TCFG, dtype=BF16)
    jv = dk6.make_v6_params(jp, CFG, jnp.asarray(tv.pe.numpy()), dtype=jnp.bfloat16)
    tok = _tokens(7, 1, b)[0]
    s0, z0 = _state(8, b)
    jh, jlog, js, jz = _jax_v6_step(jv, jnp.asarray(tok), jnp.asarray(s0.numpy()),
                                    jnp.asarray(z0.numpy()), pos, 2, CFG.attn_eps)
    s1, z1 = s0.clone(), z0.clone()
    h0 = tdk6.embed_plain(tv, torch.from_numpy(tok), pos)
    th, _, _ = tdk4.fused_stack_step_plain(tv.layers, h0, s1, z1, n_head=2, eps=CFG.attn_eps,
                                           round_to=BF16)
    jh = np.asarray(jh)
    assert np.abs(th.numpy() - jh).max() <= 1e-5 * np.abs(jh).max()
    for ours, ref in ((s1, js), (z1, jz)):
        ref = np.asarray(ref)
        assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    s2, z2 = s0.clone(), z0.clone()
    toks, _, _ = tdk6.fused_decode_v6_plain(tv, torch.from_numpy(tok), s2, z2, pos, 0, n_head=2,
                                            max_tokens=1, eps=CFG.attn_eps, **GREEDY)
    ref_tok = np.asarray(jnp.argmax(jlog.reshape(b, len(VOCAB), tdc.VF_PAD), -1))
    np.testing.assert_array_equal(toks[0].numpy(), ref_tok)


def test_bf16_twin_agrees_with_the_jax_xla_decode_step(both):
    """(c) Teacher-forced greedy next tokens over 32 steps (8 songs, 6
    fields): the twin with bf16 weights against JAX's XLA decode_step on
    bf16 params agree on at least 98% of the (step, song, field)
    decisions, the rate JAX v6's contract states for v6 against the XLA
    path (ops/decode_kernel_v6.py:33-43).  The XLA path carries its
    activations in bf16, the twin in f32 with bf16 product inputs, so
    near-ties may flip."""
    jp, tp = both
    b, T = 8, 32
    jp16 = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    tv = tdk6.make_v6_params(tp, TCFG, dtype=BF16)
    toks = _tokens(11, T, b)
    st = tdk4.init_state(TCFG, b, torch.float32, "cpu")
    js = lt.init_decode_state(CFG, b)
    agree = 0
    for t in range(T):
        ours, _, _ = tdk6.fused_decode_v6_plain(tv, torch.from_numpy(toks[t]), st.s, st.z, t, 0,
                                                n_head=2, max_tokens=1, eps=CFG.attn_eps,
                                                **GREEDY)
        h, js = lt.decode_step(jp16, CFG, jnp.asarray(toks[t]), js)
        ref = np.stack([np.asarray(jnp.argmax(lg, -1)) for lg in lt.forward_output(jp16, CFG, h)],
                       -1)
        agree += int((ours[0].numpy() == ref).sum())
    rate = agree / (T * b * len(VOCAB))
    assert rate >= 0.98, f"teacher-forced greedy agreement {rate:.4f}"


def _count(monkeypatch, module, name):
    calls, real = [], getattr(module, name)

    def wrapped(*a, **k):
        calls.append(a)
        return real(*a, **k)

    monkeypatch.setattr(module, name, wrapped)
    return calls


def test_cpu_routes_of_v8_v7_and_v5_reach_the_repaired_twins(both, monkeypatch):
    """(d) On the CPU v8 and v7 reach latency_decode_plain and v5 reaches
    fused_decode_v6_plain: with bf16 weights all three round their product
    inputs as kernel B's twin does (JAX's v8, v7 and v5 do), and none keeps
    v4's arithmetic.  v5's tokens and state equal kernel B's twin bit for
    bit (M stays f32 in both); v8's and v7's equal it on embedding rows
    rounded to bf16, and end in another state than v4's arithmetic."""
    _, tp = both
    rp = tdk8.make_resident_params(tp, TCFG, dtype=BF16)
    tok0 = torch.from_numpy(_tokens(4, 1, 8)[0])     # v5 takes batches of 8
    kw = dict(n_head=2, max_tokens=4, vocab_sizes=VOCAB, eps=CFG.attn_eps, **CP)
    twin = dict(n_head=2, max_tokens=4, eps=CFG.attn_eps, **CP)
    lat_s, lat_z = _state(5, 8)
    lat, _, _ = tdk6.fused_decode_v6_plain(rp._replace(m=rp.m.to(BF16).float()), tok0, lat_s,
                                           lat_z, 0, 13, **twin)
    v5_s, v5_z = _state(5, 8)
    v5_ref, _, _ = tdk6.fused_decode_v6_plain(rp, tok0, v5_s, v5_z, 0, 13, **twin)
    v4_s, v4_z = _state(5, 8)
    tdk6._chunk_plain(rp, tok0, v4_s, v4_z, 0, 13, round_to=None, greedy=False, **twin)
    calls = {"v8": _count(monkeypatch, tdk8, "latency_decode_plain"),
             "v7": _count(monkeypatch, tdk7, "latency_decode_plain"),
             "v5": _count(monkeypatch, tdk5, "fused_decode_v6_plain")}
    for fn in (tdk8.fused_decode_v8, tdk7.fused_decode_v7):
        s, z = _state(5, 8)
        out, _, _ = fn(rp, tok0, s, z, 0, 13, **kw)
        assert torch.equal(out, lat) and torch.equal(s, lat_s) and torch.equal(z, lat_z)
        assert not torch.equal(s, v4_s)
    s, z = _state(5, 8)
    s5, z5 = tdk5.pack_state(s, z)
    v5p = tdk5.make_v5_params(tp, TCFG)
    out, s5, z5 = tdk5.fused_decode_v5(v5p, tok0, s5, z5, v5p.pe[:4].contiguous(), 13, **kw)
    s5u, z5u = tdk5.unpack_state(s5, z5, 2)
    assert torch.equal(out, v5_ref) and torch.equal(s5u, v5_s) and torch.equal(z5u, v5_z)
    assert not torch.equal(s5u, v4_s)
    assert [len(calls[k]) for k in ("v8", "v7", "v5")] == [1, 1, 1]


@pytest.mark.parametrize("f32_weights", [False, True])
@pytest.mark.parametrize("d_model,n_head,d_inner,ok_bf16,ok_f32", [
    (512, 8, 2048, True, True), (64, 2, 128, True, True), (32, 2, 64, True, True),
    (48, 3, 96, True, True), (96, 2, 192, True, True), (64, 8, 128, True, True),
    (4096, 32, 128, False, False), (12, 3, 64, False, True), (64, 2, 100, False, True),
    (256, 1, 512, False, False)])
def test_tc_route_names_the_shapes_it_refuses(d_model, n_head, d_inner, ok_bf16, ok_f32,
                                              f32_weights):
    """The tensor-core route takes head widths up to 128 (16, 32, 64 and 128
    in 16-byte pieces, the others by a plainer state pass) and d_model up to
    2048; bf16 weights, read in place, also need d_model and d_inner in
    multiples of 8, while f32 weights reach the products as padded planes
    and take any; the wrapper raises with the reason (``tc_shape_error``)
    on a card for anything else."""
    why = tdk6.tc_shape_error(d_model, n_head, d_inner, f32_weights)
    assert (why is None) == (ok_f32 if f32_weights else ok_bf16), why


@pytest.mark.parametrize("shape", [(2, 5, 13), (64, 96), (3, 8, 1)])
def test_weight_planes_hold_the_f32_weights(shape):
    """An f32 weight as three bf16 planes, rows padded to a multiple of 8
    with zeros: hi = bf16(w), mid and lo the rounded remainders, and
    hi + mid + lo gives w back exactly (its 24 bits)."""
    rng = np.random.default_rng(5)
    w = torch.from_numpy(rng.normal(scale=0.05, size=shape).astype(np.float32))
    p = tdk6.weight_planes(w)
    n = shape[-1]
    assert p.dtype == BF16 and tuple(p.shape) == (3,) + shape[:-1] + (n + (-n) % 8,)
    assert torch.equal(p[0, ..., :n], w.to(BF16))
    assert torch.equal((p[0].float() + p[1].float()) + p[2].float(),
                       torch.nn.functional.pad(w, (0, (-n) % 8)))
    assert not p[..., n:].any()
    with pytest.raises(TypeError):
        tdk6.weight_planes(w.to(BF16))


def _six_products(x: np.ndarray, planes: torch.Tensor) -> np.ndarray:
    """The kernel's product at f32 grade, in numpy: x split into planes as
    the passes write them, and per depth of 16 the six plane products
    (each bf16 product exact in f32, summed in f32), added to the running
    f32 sum."""
    xp = tdk6.weight_planes(torch.from_numpy(x))[..., :x.shape[1]].float().numpy()
    wp = planes.float().numpy()
    acc = np.zeros((x.shape[0], wp.shape[-1]), dtype=np.float32)
    for k0 in range(0, x.shape[1], 16):
        a, w = xp[:, :, k0:k0 + 16], wp[:, k0:k0 + 16]
        c = sum(a[i] @ w[j] for i, j in ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0)))
        acc = acc + c.astype(np.float32)
    return acc


def test_six_plane_products_match_the_jax_f32_product():
    """With f32 weights JAX's v6 takes its products in f32 (the cast to the
    weights' type is a no-op): the kernel's arithmetic, six bf16 plane
    products a depth of 16 from ``weight_planes``, agrees with JAX's f32
    product to 1e-6 of its magnitude at the decode's qkv shape, where the
    product of the hi planes alone (bf16 inputs) misses by far more."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(16, 96)).astype(np.float32)
    w = rng.normal(scale=0.1, size=(96, 3 * 40)).astype(np.float32)
    ref = np.asarray(jnp.dot(jnp.asarray(x), jnp.asarray(w), preferred_element_type=jnp.float32,
                             precision=jax.lax.Precision.HIGHEST))
    planes = tdk6.weight_planes(torch.from_numpy(w))
    got = _six_products(x, planes)[:, :w.shape[1]]
    mag = np.abs(ref).max()
    hi = torch.from_numpy(x).to(BF16).float().numpy() @ planes[0, :, :w.shape[1]].float().numpy()
    assert np.abs(got - ref).max() <= 1e-6 * mag
    assert np.abs(hi - ref).max() > 1e-3 * mag


def test_make_v6_params_packs_planes_for_the_card_only(both):
    """make_v6_params packs the products' planes only for f32 weights on a
    card (none on the CPU, whose twin reads the weights); the wrapper's
    check takes the packed shapes and refuses others."""
    _, tp = both
    v32 = tdk6.make_v6_params(tp, TCFG, dtype=torch.float32)
    assert v32.planes is None and tdk6.make_v6_params(tp, TCFG, dtype=BF16).planes is None
    ws = tdk4.layer_weights(v32.layers)
    planes = tuple(tdk6.weight_planes(t) for t in
                   [ws[i] for i in tdk6.PLANE_WEIGHTS] + [v32.head_w])
    tdk6._check_planes(v32._replace(planes=planes), ws, torch.device("cpu"))
    with pytest.raises(ValueError, match="planes"):
        tdk6._check_planes(v32, ws, torch.device("cpu"))
    with pytest.raises(ValueError, match="planes"):
        tdk6._check_planes(v32._replace(planes=planes[1:] + planes[:1]), ws,
                           torch.device("cpu"))
