"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one.  The file imports neither jax nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v6 as tdk6
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp

VOCAB = (56, 135, 18, 87, 18, 25)
CP_TEMPS = tuple(s.temperature for s in tsmp.CP_SAMPLING)
CP_TOPPS = tuple(s.top_p if s.top_p is not None else float("inf") for s in tsmp.CP_SAMPLING)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _setup(dev, d_model, n_head, wdt):
    cfg = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=d_model,
                                     n_layer=2, n_head=n_head, d_inner=2 * d_model,
                                     max_len=512)
    params = tlt.cast_params(tlt.init_params(cfg, seed=1, device=dev), wdt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    return cfg, params, gen


def _tokens(gen, dev, b):
    return torch.stack([torch.randint(0, v, (b,), generator=gen, device=dev) for v in VOCAB],
                       -1).to(torch.int32)


# (d_model, n_head): an even head count, and an odd one (the TPU kernel
# needed head pairs; the port's state kernel takes any head width dividing 256)
SHAPES = [(32, 2), (48, 3)]


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head", SHAPES)
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_decode_step_kernel_matches_plain(dev, d_model, n_head, wdt):
    cfg, params, gen = _setup(dev, d_model, n_head, wdt)
    dp = tlt.make_decode_params(params, cfg)
    b = 5
    sk = tdk4.init_state(cfg, b, torch.float32, dev)
    sp = tdk4.init_state(cfg, b, torch.float32, dev)
    before = tdk4.fused_stack_step.launches
    for t in range(6):
        h0 = tlt.embed_input(params, cfg, _tokens(gen, dev, b), t, None).float()
        hk, _, _ = tdk4.fused_stack_step(dp, h0, sk.s, sk.z, n_head=n_head)
        hp, _, _ = tdk4.fused_stack_step_plain(dp, h0, sp.s, sp.z, n_head=n_head)
        torch.testing.assert_close(hk, hp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sk.s, sp.s, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(sk.z, sp.z, rtol=1e-4, atol=1e-4)
    assert tdk4.fused_stack_step.launches == before + 6


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head", SHAPES)
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_decode_chunk_kernel_matches_plain(dev, d_model, n_head, wdt):
    cfg, params, gen = _setup(dev, d_model, n_head, wdt)
    v6p = tdk6.make_v6_params(params, cfg)
    b = 7
    tok0 = _tokens(gen, dev, b)
    kw = dict(n_head=n_head, max_tokens=24, temps=(1.0,) * 6, topps=(float("inf"),) * 6,
              greedy=True, eps=cfg.attn_eps)
    s1 = tdk4.init_state(cfg, b, torch.float32, dev)
    s2 = tdk4.init_state(cfg, b, torch.float32, dev)
    ok, _, _ = tdk6.fused_decode_v6(v6p, tok0, s1.s, s1.z, 0, 1, vocab_sizes=VOCAB, **kw)
    op, _, _ = tdk6.fused_decode_v6_plain(v6p, tok0, s2.s, s2.z, 0, 1, **kw)
    assert (ok == op).float().mean() >= 0.95
    h = torch.randn((b, d_model), generator=gen, device=dev)
    for greedy in (False, True):
        hk = tdk6.heads_sample(v6p, h, seed=9, pos=4, temps=CP_TEMPS, topps=CP_TOPPS,
                               greedy=greedy)
        hp = tdk6.heads_sample_plain(v6p, h, seed=9, pos=4, temps=CP_TEMPS, topps=CP_TOPPS,
                                     greedy=greedy)
        assert (hk == hp).float().mean() >= 0.95


@pytest.mark.gpu
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    cfg, params, gen = _setup(dev, 32, 2, torch.float32)
    dp = tlt.make_decode_params(params, cfg)
    st = tdk4.init_state(cfg, 2, torch.float32, dev)
    with pytest.raises(TypeError, match="h0"):
        tdk4.fused_stack_step(dp, torch.zeros((2, 32), device=dev, dtype=torch.float64),
                              st.s, st.z, n_head=2)
    with pytest.raises(TypeError, match="state"):
        tdk4.fused_stack_step(dp, torch.zeros((2, 32), device=dev), st.s.double(),
                              st.z.double(), n_head=2)
    v6p = tdk6.make_v6_params(params, cfg)
    with pytest.raises(ValueError, match="tok0"):
        tdk6.fused_decode_v6(v6p, _tokens(gen, dev, 2).long(), st.s, st.z, 0, 0, n_head=2,
                             max_tokens=1, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS)
