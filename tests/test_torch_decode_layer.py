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
