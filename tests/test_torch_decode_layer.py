"""The port's per-layer v1/v2 decode steps
(``ops/experimental/decode_kernel.py``) against the JAX package, on the CPU.

The CUDA kernel cannot run here: ``fused_layer_step`` and
``fused_layer_step_v2`` take their plain twins for CPU tensors, and those
are held against the JAX Pallas kernels run with ``interpret=True``, through
``fused_decode_step`` over every layer, at the tolerances of the JAX
package's ``tests/test_decode_kernel_v3.py``.
``tests/test_torch_kernels_gpu.py`` holds the kernels against the twins on a
card."""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch import weights as tw
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import decode_common as tdc
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops.experimental import (
    decode_kernel as tdk)
from reinforcement_learning_in_music_generation_tpu import config as C
from reinforcement_learning_in_music_generation_tpu.models import linear_transformer as lt

dk = importlib.import_module(
    "reinforcement_learning_in_music_generation_tpu.ops.experimental.decode_kernel")

VOCAB = (8, 10, 6, 12, 6, 7)
SHAPES = [(32, 2), (48, 3)]


def _kw(d_model, n_head):
    return dict(vocab_sizes=VOCAB, emb_sizes=(8,) * 6, d_model=d_model, n_head=n_head,
                n_layer=2, d_inner=64, dropout=0.0, max_len=128)


@pytest.mark.parametrize("variant", ["v1", "v2"])
@pytest.mark.parametrize("d_model,n_head", SHAPES)
def test_fused_decode_step_matches_jax_interpret(variant, d_model, n_head):
    """Five teacher-forced tokens at B=4, f32 weights: h within rtol 2e-4 /
    atol 2e-5 and the augmented state within 1e-4 / 1e-5."""
    cfg = C.LinearTransformerConfig(**_kw(d_model, n_head), dtype="float32")
    tcfg = TC.LinearTransformerConfig(**_kw(d_model, n_head))
    jp = lt.init_params(jax.random.PRNGKey(1), cfg)
    tp = tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    b = 4
    rng = np.random.default_rng(2)
    toks = np.stack([rng.integers(0, v, size=(5, b)) for v in VOCAB], -1).astype(np.int32)
    jst = lt.DecodeState(dk.aug_state_init(cfg, b), jnp.zeros((1,), jnp.float32),
                         jnp.zeros((), jnp.int32))
    tst = tlt.DecodeState(tdk.aug_state_init(tcfg, b, "cpu"), torch.zeros(1), 0)
    for t in range(toks.shape[0]):
        jh, jst = dk.fused_decode_step(jp, cfg, jnp.asarray(toks[t]), jst, interpret=True,
                                       variant=variant)
        th, tst = tdk.fused_decode_step(tp, tcfg, torch.from_numpy(toks[t]), tst,
                                        variant=variant)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tst.s.numpy(), np.asarray(jst.s), rtol=1e-4, atol=1e-5)


def test_fused_decode_step_refuses_an_unknown_variant():
    tcfg = TC.LinearTransformerConfig(**_kw(32, 2))
    tp = tlt.init_params(tcfg, seed=0, device="cpu")
    st = tlt.DecodeState(tdk.aug_state_init(tcfg, 1, "cpu"), torch.zeros(1), 0)
    with pytest.raises(ValueError, match="variant"):
        tdk.fused_decode_step(tp, tcfg, torch.zeros((1, 6), dtype=torch.int32), st,
                              variant="v3")


def test_head_major_layer_params_equal_jax():
    cfg = C.LinearTransformerConfig(**_kw(48, 3), dtype="float32")
    jp = lt.init_params(jax.random.PRNGKey(3), cfg)
    tp = tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    for li in range(cfg.n_layer):
        jl = jax.tree_util.tree_map(lambda a: a[li], jp["layers"])
        tl = {k: {kk: vv[li] for kk, vv in v.items()} for k, v in tp["layers"].items()}
        jh, th = dk.head_major_layer_params(jl, 3), tdk.head_major_layer_params(tl, 3)
        for k in ("qkvw", "qkvb", "wow"):
            np.testing.assert_array_equal(th[k].numpy(), np.asarray(jh[k]), err_msg=k)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_v2_packed_operands_unpack_to_jax_head_major_weights(dtype):
    """v2's packed operands (``v2_pack_plain``, what ``rlmg_v2_pack`` writes
    on the card) unpack to the JAX ``head_major_layer_params`` of the same
    layer: qkv's (D, 3D) columns [q_h k_h v_h] head by head, Wo row for row,
    W1 and W2, in the weights' type, and the f32 vectors in the token
    kernel's order."""
    cfg = C.LinearTransformerConfig(**_kw(48, 3), dtype="float32")
    jp = lt.init_params(jax.random.PRNGKey(5), cfg)
    tp = tw.from_jax_params(jax.tree_util.tree_map(np.asarray, jp), device="cpu")
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    tp = {**tp, "layers": jax.tree_util.tree_map(lambda t: t.to(tdt), tp["layers"])}
    for li in range(cfg.n_layer):
        jl = jax.tree_util.tree_map(lambda a: a[li].astype(jnp.float32), jp["layers"])
        jl = jax.tree_util.tree_map(lambda a: np.asarray(jnp.asarray(a).astype(
            jnp.bfloat16 if dtype == "bfloat16" else jnp.float32).astype(jnp.float32)), jl)
        tl = {k: {kk: vv[li] for kk, vv in v.items()} for k, v in tp["layers"].items()}
        mats, vecs = tdk.v2_pack_plain(tl, 3)
        jh = dk.head_major_layer_params(jl, 3)
        d = 48
        want = [np.asarray(jh["qkvw"]).transpose(1, 0, 2).reshape(d, 3 * d),
                np.asarray(jh["wow"]).reshape(d, d), jl["ffn1"]["w"], jl["ffn2"]["w"]]
        for m, w in zip(mats, want):
            assert m.dtype == tdt
            np.testing.assert_array_equal(tdk.unpack_fragments(m, w.shape[0])[0].float().numpy(),
                                          w)
        want_v = [np.asarray(jh["qkvb"]).reshape(-1), jl["wo"]["b"], jl["ln1"]["scale"],
                  jl["ln1"]["bias"], jl["ffn1"]["b"], jl["ffn2"]["b"], jl["ln2"]["scale"],
                  jl["ln2"]["bias"]]
        for v, w in zip(vecs, want_v):
            assert v.dtype == torch.float32
            np.testing.assert_array_equal(v[0].numpy(), w)


def _v1_head_major_columns(d: int, n_head: int) -> torch.Tensor:
    """The packing's column map: head-major column h 3E + j E + e (j = 0, 1,
    2 for q, k, v) is column j D + h E + e of v1's [q | k | v] weight."""
    e = d // n_head
    h, j, u = torch.meshgrid(torch.arange(n_head), torch.arange(3), torch.arange(e),
                             indexing="ij")
    return (j * d + h * e + u).reshape(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d_model,n_head", [(48, 3), (128, 2)])
def test_v1_weights_pack_to_the_operands_the_kernel_reads(dtype, d_model, n_head):
    """v1 reads v2's packed operands: its (D, 3D) [q | k | v] weight (the
    JAX kernel's concatenation, :101-102), its columns taken through the
    head-major column map, packs (``pack_fragments``) to ``v2_pack_plain``'s
    qkv bit for bit; its bias through the same map is the packed bias; its
    Wo, W1, W2 and the other vectors are v2's as they are."""
    tcfg = TC.LinearTransformerConfig(**{**_kw(d_model, n_head), "d_inner": 2 * d_model})
    params = tlt.init_params(tcfg, seed=4, device="cpu")
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    gen = torch.Generator().manual_seed(9)
    for li in range(tcfg.n_layer):
        lp = {k: {kk: (torch.randn(vv[li].shape, generator=gen) if kk == "b" else vv[li])
                  .to(tdt) for kk, vv in v.items()} for k, v in params["layers"].items()}
        qkv_w, qkv_b, wo_w = tdk._v1_weights(lp)[:3]
        cols = _v1_head_major_columns(d_model, n_head)
        assert sorted(cols.tolist()) == list(range(3 * d_model))
        mats, vecs = tdk.v2_pack_plain(lp, n_head)
        assert torch.equal(mats[0], tdk4.pack_fragments(qkv_w[:, cols][None]))
        assert torch.equal(vecs[0][0], qkv_b[cols])
        assert torch.equal(mats[1], tdk4.pack_fragments(wo_w[None]))
        assert torch.equal(mats[2], tdk4.pack_fragments(lp["ffn1"]["w"][None]))
        assert torch.equal(mats[3], tdk4.pack_fragments(lp["ffn2"]["w"][None]))
        tail_vecs = [t for t in tdk._tail_weights(lp) if t.dim() == 1]
        assert len(tail_vecs) == len(vecs) - 1
        for got, want in zip(vecs[1:], tail_vecs):
            assert torch.equal(got[0], want)


def _ln1_inputs(monkeypatch, fn, h, lp, s, n_head):
    """The LN1 input of one call of a plain twin (its first ``ln``) and the
    attention it formed (``aug_attention_plain``'s (H, B, E) result)."""
    seen, att = [], []
    real_ln, real_att = tdk.ln, tdk.aug_attention_plain
    with monkeypatch.context() as m:
        m.setattr(tdk, "ln", lambda x, *a: seen.append(x.clone()) or real_ln(x, *a))
        m.setattr(tdk, "aug_attention_plain", lambda *a: att.append(real_att(*a)) or att[-1])
        fn(h, lp, s, n_head=n_head)
    assert len(seen) == 2 and len(att) == 1
    b, d = h.shape
    return seen[0], att[0].transpose(0, 1).reshape(b, d)


def test_v1_twin_sums_ln1_as_the_jax_kernel(monkeypatch):
    """v1's LN1 input is h + (att Wo + bo), JAX v1's ``h + ao`` with ``ao =
    att @ wow + wob`` (:76-78), bit for bit, on values where the other order
    differs: Wo the identity (so att Wo is att exactly in both packages), h
    near 1e3, bo near 1e-3.  v2's twin forms (h + att Wo) + bo there
    (JAX ``_layer_kernel_v2``), which differs."""
    d, n_head, b = 32, 2, 64
    tcfg = TC.LinearTransformerConfig(**_kw(d, n_head))
    params = tlt.init_params(tcfg, seed=6, device="cpu")
    lp = {k: {kk: vv[0].clone() for kk, vv in v.items()} for k, v in params["layers"].items()}
    rng = np.random.default_rng(13)
    lp["wo"]["w"] = torch.eye(d)
    lp["wo"]["b"] = torch.from_numpy(rng.normal(size=(d,)).astype(np.float32) * 1e-3)
    h = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32) * 1e3)
    s = torch.from_numpy(rng.normal(size=(n_head, b, d // n_head, d // n_head + 1))
                         .astype(np.float32))
    x1, att1 = _ln1_inputs(monkeypatch, tdk.fused_layer_step_plain, h, lp, s.clone(), n_head)
    ao = jnp.dot(jnp.asarray(att1.numpy()), jnp.asarray(lp["wo"]["w"].numpy()),
                 preferred_element_type=jnp.float32) + jnp.asarray(lp["wo"]["b"].numpy())
    np.testing.assert_array_equal(x1.numpy(), np.asarray(jnp.asarray(h.numpy()) + ao))
    other = (h + att1) + lp["wo"]["b"]
    assert (other != x1).any()                 # the orders can be told apart here
    x2, att2 = _ln1_inputs(monkeypatch, tdk.fused_layer_step_v2_plain, h, lp, s.clone(), n_head)
    assert torch.equal(x2, (h + att2) + lp["wo"]["b"])
    assert not torch.equal(x2, h + (att2 + lp["wo"]["b"]))


def test_unpack_fragments_inverts_pack_fragments():
    w = torch.randn(2, 40, 24, generator=torch.Generator().manual_seed(7))
    p = tdk4.pack_fragments(w)
    assert tuple(p.shape) == (2, 3, 2, 32, 8) and not p.flatten()[-1:].any()
    assert torch.equal(tdk.unpack_fragments(p, 40), w)


def test_v2_pack_cache_repacks_after_an_in_place_update_and_not_otherwise():
    """``cached_layer`` (v2's packed layers): a layer indexed afresh out of
    the same stacked leaves finds its entry; an in-place update of one leaf
    builds again; another batch or head count is another entry; the entry
    goes when the weights do."""
    tcfg = TC.LinearTransformerConfig(**_kw(32, 2))
    params = tlt.init_params(tcfg, seed=0, device="cpu")
    built = []

    def layer(li):
        return {k: {kk: vv[li] for kk, vv in v.items()} for k, v in params["layers"].items()}

    def get(li, b=4, n_head=2):
        lv = tdk.v2_leaves(layer(li))
        value, packed = tdk.cached_layer(lv, (n_head, b), lambda: built.append(li) or len(built))
        return value, packed
    tdk._V2_CACHE.clear()
    assert get(0) == (1, True)
    assert get(0) == (1, False)
    assert get(1) == (2, True) and get(0) == (1, False)
    with torch.no_grad():
        params["layers"]["ffn2"]["w"].mul_(1.0)             # a version moves
    assert get(0) == (3, True)
    assert get(0) == (3, False)
    assert get(0, b=8) == (4, True) and get(0, n_head=1) == (5, True)
    assert len(tdk._V2_CACHE) == 4
    params["layers"] = {k: {kk: vv.clone() for kk, vv in v.items()}
                        for k, v in params["layers"].items()}
    assert len(tdk._V2_CACHE) == 0                          # the old leaves are gone
    assert get(0) == (6, True)


@pytest.mark.parametrize("d_model,n_head", [(48, 3), (128, 1), (128, 2)])
@pytest.mark.parametrize("bf16_layers", [False, True])
@pytest.mark.parametrize("variant", ["v2", "v1"])
def test_exact_gelu_control_lands_above_the_layer_gate(d_model, n_head, bf16_layers, variant):
    """The control of the card's v1 and v2 gates, on the plain twins: five
    tokens through the layers on the exact-erf gelu (v3's layer,
    ``decode_kernel_v3.fused_stack_step_plain`` a layer at a time) end above
    test_layer_kernels_match_plain's h gate (rtol 1e-4, atol 1e-4) against
    the variant's twin, at the card test's shapes and weights (f32, and bf16
    layers under f32 activations)."""
    from reinforcement_learning_in_music_generation_torch.models import common as tcm
    from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v3 as tdk3
    vocab = (56, 135, 18, 87, 18, 25)
    cfg = TC.LinearTransformerConfig(vocab_sizes=vocab, emb_sizes=(16,) * 6, d_model=d_model,
                                     n_layer=2, n_head=n_head, d_inner=2 * d_model,
                                     max_len=512)
    params = tlt.init_params(cfg, seed=1, device="cpu")
    if bf16_layers:
        params = dict(params, layers={k: {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                                      for k, v in params["layers"].items()})
    wdt = torch.bfloat16 if bf16_layers else torch.float32
    v3p = tdk3.make_v3_params(params, cfg, dtype=wdt)
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(np.stack([rng.integers(0, v, size=(5, 4)) for v in vocab], -1)
                            .astype(np.int32))
    kw = dict(n_head=n_head, eps=cfg.attn_eps)

    def run(step):
        s = tdk.aug_state_init(cfg, 4, "cpu")
        for t in range(5):
            h = tlt.embed_input(params, cfg, toks[t], t, None)
            for li in range(cfg.n_layer):
                lp = {k: {kk: vv[li] for kk, vv in v.items()} for k, v in params["layers"].items()}
                h = step(h, lp, s[li], li)
            h = tcm.layernorm(params["final_ln"], h)
        return h

    plain = tdk.fused_layer_step_plain if variant == "v1" else tdk.fused_layer_step_v2_plain
    hp = run(lambda h, lp, s, li: plain(h, lp, s, **kw)[0])
    hc = run(lambda h, lp, s, li: tdk3.fused_stack_step_plain(
        {k: v[li:li + 1] for k, v in v3p.items()}, h.float(), s[None], **kw)[0])
    excess = ((hc - hp).abs() / (1e-4 + 1e-4 * hp.abs())).max().item()
    assert excess > 1.0, f"the exact gelu lands at {excess:.3f} of the gate"


def test_state_aug_round_trips_equal_jax():
    rng = np.random.default_rng(4)
    s = rng.normal(size=(2, 3, 4, 5, 5)).astype(np.float32)     # (L, B, H, E, F)
    z = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    ja = dk.state_to_aug(jnp.asarray(s), jnp.asarray(z))
    ta = tdk.state_to_aug(torch.from_numpy(s), torch.from_numpy(z))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    js, jz = dk.aug_to_state(ja)
    ts, tz = tdk.aug_to_state(ta)
    for ours, ref, orig in ((ts, js, s), (tz, jz, z)):
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
        np.testing.assert_array_equal(ours.numpy(), orig)
    cfg = C.LinearTransformerConfig(**_kw(48, 3), dtype="float32")
    tcfg = TC.LinearTransformerConfig(**_kw(48, 3))
    init = tdk.aug_state_init(tcfg, 2, "cpu")
    assert init.dtype == torch.float32 and not init.any()
    assert tuple(init.shape) == tuple(dk.aug_state_init(cfg, 2).shape)


def test_gelu_tanh_equals_jax():
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True))
    ours = tdc.gelu_tanh(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
