"""The port's CUDA kernels against their plain PyTorch versions, and its CUDA
graphs (the per-step token, the rollout episodes) against their eager loops,
on a card.

Every test here needs a CUDA card (the kernels have no CPU mode) and skips
without one.  The file imports neither jax nor the JAX package, so it also
runs where only PyTorch is installed:

    python -m pytest --noconftest -q -m gpu tests/test_torch_kernels_gpu.py
"""

import pytest
import torch

from reinforcement_learning_in_music_generation_torch import config as TC
from reinforcement_learning_in_music_generation_torch.models import common as tcm
from reinforcement_learning_in_music_generation_torch.models import linear_transformer as tlt
from reinforcement_learning_in_music_generation_torch.ops import attention_block as tab
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v3 as tdk3
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v4 as tdk4
from reinforcement_learning_in_music_generation_torch.ops import decode_kernel_v6 as tdk6
from reinforcement_learning_in_music_generation_torch.ops import ffn_block as tfb
from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
from reinforcement_learning_in_music_generation_torch.ops.experimental import (
    decode_kernel as tdk, decode_kernel_v5 as tdk5, decode_kernel_v7 as tdk7,
    decode_kernel_v8 as tdk8)

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


# -- kernel A and v3 on the token kernel (csrc/decode_stack_tc.cuh) -----------

def _stack_setup(dev, n_head=8):
    """agent_config's width (d_model 512, d_inner 2048) cut to 2 layers."""
    cfg = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=512,
                                     n_layer=2, n_head=n_head, d_inner=2048, max_len=512)
    params = tlt.init_params(cfg, seed=3, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    return cfg, params, gen


def _greedy(params, cfg, dp, h):
    logits = tlt.fused_logits(dp, cfg, tcm.layernorm(params["final_ln"], h))
    return torch.stack([lg.argmax(-1) for lg in logits], -1)


STACK_BATCHES = [1, 5, 32, 64, 128]


@pytest.mark.gpu
@pytest.mark.parametrize("b", STACK_BATCHES)
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
def test_decode_step_tc_keeps_the_twins_arithmetic(dev, b, wdt, sdt, capsys):
    """Kernel A against its twin, 8 teacher-forced tokens: with an f32 state
    max|dh| <= 1e-3 (chip_smoke phase 2a's gate), with a bf16 state >= 99%
    equal greedy tokens.  The control, the same tokens through the twin
    with every product's input rounded to bf16 (v6's arithmetic), ends above
    the f32-state gate: the gate tells f32-grade activations from rounded
    ones."""
    cfg, params, gen = _stack_setup(dev)
    dp = tlt.make_decode_params(params, cfg, wdt)
    dp32 = tlt.make_decode_params(params, cfg)
    sk, sp, sc = (tdk4.init_state(cfg, b, sdt, dev) for _ in range(3))
    dh = dc = 0.0
    agree = total = 0
    for t in range(8):
        h0 = tlt.embed_input(params, cfg, _tokens(gen, dev, b), t, None).float()
        hk = tdk4.fused_stack_step(dp, h0, sk.s, sk.z, n_head=cfg.n_head)[0].clone()
        hp, _, _ = tdk4.fused_stack_step_plain(dp, h0, sp.s, sp.z, n_head=cfg.n_head)
        hc, _, _ = tdk4.fused_stack_step_plain(dp, h0, sc.s, sc.z, n_head=cfg.n_head,
                                               round_to=torch.bfloat16)
        dh = max(dh, (hk - hp).abs().max().item())
        dc = max(dc, (hc - hp).abs().max().item())
        gk, gp = _greedy(params, cfg, dp32, hk), _greedy(params, cfg, dp32, hp)
        agree += (gk == gp).sum().item()
        total += gk.numel()
    with capsys.disabled():
        print(f"\n[gate] A B={b} w {wdt} s {sdt}: max|dh| {dh:.3e}, control {dc:.3e}, "
              f"greedy agreement {agree / total:.4f}")
    assert dc > 1e-3
    if sdt == torch.float32:
        assert dh <= 1e-3
    else:
        assert agree / total >= 0.99


@pytest.mark.gpu
@pytest.mark.parametrize("b", STACK_BATCHES)
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_head", [8, 1])
def test_v3_tc_keeps_the_twins_arithmetic(dev, b, wdt, n_head, capsys):
    """v3 against its twin, 8 teacher-forced tokens on the f32 augmented
    state (8 heads of 64 and one head of 512): max|dh| <= 1e-3; the control
    (A's twin rounding every product's input to bf16, on the same weights)
    ends above it."""
    cfg, params, gen = _stack_setup(dev, n_head)
    v3p = tdk3.make_v3_params(params, cfg, dtype=wdt)
    dp = tlt.make_decode_params(params, cfg, wdt)
    sk, sp = tdk3.init_aug_state(cfg, b, dev), tdk3.init_aug_state(cfg, b, dev)
    sc = tdk4.init_state(cfg, b, torch.float32, dev)
    sa = tdk4.init_state(cfg, b, torch.float32, dev)
    dh = dc = 0.0
    for t in range(8):
        h0 = tlt.embed_input(params, cfg, _tokens(gen, dev, b), t, None).float()
        hk = tdk3.fused_stack_step(v3p, h0, sk, n_head=n_head)[0].clone()
        hp, _ = tdk3.fused_stack_step_plain(v3p, h0, sp, n_head=n_head)
        ha, _, _ = tdk4.fused_stack_step_plain(dp, h0, sa.s, sa.z, n_head=n_head)
        hc, _, _ = tdk4.fused_stack_step_plain(dp, h0, sc.s, sc.z, n_head=n_head,
                                               round_to=torch.bfloat16)
        dh = max(dh, (hk - hp).abs().max().item())
        dc = max(dc, (hc - ha).abs().max().item())
    with capsys.disabled():
        print(f"\n[gate] v3 H={n_head} B={b} w {wdt}: max|dh| {dh:.3e}, control {dc:.3e}")
    assert dh <= 1e-3 < dc


@pytest.mark.gpu
def test_decode_step_tc_is_bit_reproducible_and_allocates_nothing(dev):
    """Two runs of the same tokens give the same h and state bit for bit; a
    call with a workspace allocates nothing, returns the workspace's buffer,
    issues one launch and the kernel counts one run."""
    cfg, params, gen = _stack_setup(dev)
    dp = tlt.make_decode_params(params, cfg, torch.bfloat16)
    work = tdk4.workspace(dp, 5)
    toks = [_tokens(gen, dev, 5) for _ in range(4)]
    outs = []
    for _ in range(2):
        st = tdk4.init_state(cfg, 5, torch.bfloat16, dev)
        hs = []
        for t, tok in enumerate(toks):
            h0 = tlt.embed_input(params, cfg, tok, t, None).float()
            torch.cuda.synchronize()
            mem = torch.cuda.memory_allocated()
            n0 = tdk4.fused_stack_step.cuda_launches
            tdk4.kernel_runs(reset=True)
            out = tdk4.fused_stack_step(None, h0, st.s, st.z, n_head=cfg.n_head, work=work)[0]
            assert torch.cuda.memory_allocated() == mem
            assert out.data_ptr() == work.h_out.data_ptr()
            assert tdk4.fused_stack_step.cuda_launches == n0 + 1
            assert tdk4.kernel_runs() == 1
            hs.append(out.clone())
        outs.append((torch.stack(hs), st.s.clone(), st.z.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def _eager_reference(params, cfg, init, *, max_tokens, greedy, settings, generator, bar_cond):
    """generate_tokens' eager loop on the same step function as its graph:
    the prompt's steps, then sampler._eager_loop, kernel A (v3 at odd
    heads) a token."""
    from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
    b, t0, _ = init.shape
    dev = init.device
    dtype = params["in_linear"]["w"].dtype
    pe = tcm.sinusoidal_table(cfg.max_len, cfg.d_model, dtype, dev)
    if cfg.n_head % 2 == 0:
        dp = tlt.make_decode_params(params, cfg)
        state = tdk4.init_state(cfg, b, device=dev)

        def step_fn(tok, st):
            return tdk4.decode_step_v4(params, dp, cfg, tok, st, pe_table=pe)
    else:
        v3p = tdk3.make_v3_params(params, cfg, dtype=dtype)
        state = tlt.DecodeState(tdk3.init_aug_state(cfg, b, dev),
                                torch.zeros((1,), device=dev), 0)

        def step_fn(tok, st):
            return tdk3.decode_step_v3(params, v3p, cfg, tok, st, pe_table=pe)
    for t in range(t0):
        h, state = step_fn(init[:, t], state)
    bars = (init[..., 2] == 1).sum(1).to(torch.int32)
    done = bars >= bar_cond if bar_cond is not None else torch.zeros(b, dtype=torch.bool,
                                                                          device=dev)
    toks, valid, bars = tsam._eager_loop(
        params, cfg, h, state, step_fn, done, bars, generator=generator, max_tokens=max_tokens,
        bar_cond=bar_cond, barbeat_field=2, bar_token_id=1, greedy=greedy, settings=settings,
        fused_sampling=True)
    return toks, valid, bars, state


@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("n_head", [8, 1])
def test_graphed_generate_tokens_equals_the_eager_loop(dev, greedy, n_head, monkeypatch):
    """generate_tokens(fused, fused_sampling) on CUDA replays one graph a
    token (RLMG_FUSED_DECODE=1 RLMG_FUSED_SAMPLING=1, bf16 weights): its
    tokens, validity and bar counts equal the eager loop's bit for bit,
    greedy and sampling at one generator seed, and it leaves the generator
    where the eager loop does."""
    from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
    monkeypatch.setenv("RLMG_FUSED_DECODE", "1")
    monkeypatch.setenv("RLMG_FUSED_SAMPLING", "1")
    cfg, params, _ = _stack_setup(dev, n_head)
    params = tlt.cast_params(params, torch.bfloat16)
    init = torch.tensor([[0, 0, 1, 0, 0, 0], [1, 2, 1, 3, 4, 5]], dtype=torch.int32,
                        device=dev)[None].expand(5, 2, 6).contiguous()
    settings = tsmp.GREEDY if greedy else tsmp.CP_SAMPLING
    g1, g2 = torch.Generator(device=dev), torch.Generator(device=dev)
    g1.manual_seed(11)
    g2.manual_seed(11)
    kern = tdk4 if n_head % 2 == 0 else tdk3
    c0, r0 = tsam.generate_tokens.graph_captures, tsam.generate_tokens.graph_replays
    e0 = kern.fused_stack_step.launches
    kern.kernel_runs(reset=True)
    res = tsam.generate_tokens(params, cfg, init, generator=g1, max_tokens=40, bar_cond=3,
                               greedy=greedy, settings=settings, fused=True,
                               fused_sampling=True)
    replays = tsam.generate_tokens.graph_replays - r0
    assert tsam.generate_tokens.graph_captures - c0 <= 1 and replays > 0
    # one run of the kernel a replay, as the kernel counts them
    assert kern.kernel_runs() == replays + kern.fused_stack_step.launches - e0
    toks, valid, bars, _ = _eager_reference(params, cfg, init, max_tokens=40, greedy=greedy,
                                            settings=settings, generator=g2, bar_cond=3)
    assert torch.equal(res.tokens[:, 2:], toks)
    assert torch.equal(res.valid[:, 2:], valid)
    assert torch.equal(res.n_bars, bars)
    assert torch.equal(g1.get_state(), g2.get_state())


@pytest.mark.gpu
def test_token_graph_captures_again_for_new_params_or_batch(dev):
    """A second call with the same params and batch replays the cached graph;
    new params (another object, or the same one updated in place) and a new
    batch size capture again, and each result equals the eager loop's."""
    from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
    cfg, params, _ = _stack_setup(dev)
    p1 = tlt.cast_params(params, torch.bfloat16)
    p2 = tlt.cast_params(tlt.init_params(cfg, seed=9, device=dev), torch.bfloat16)
    kw = dict(max_tokens=24, bar_cond=None, greedy=True, settings=tsmp.GREEDY)

    def run(p, b):
        init = torch.zeros((b, 1, 6), dtype=torch.int32, device=dev)
        c0 = tsam.generate_tokens.graph_captures
        res = tsam.generate_tokens(p, cfg, init, fused=True, fused_sampling=True, **kw)
        toks, _, _, _ = _eager_reference(p, cfg, init, generator=None, **kw)
        assert torch.equal(res.tokens[:, 1:], toks)
        return tsam.generate_tokens.graph_captures - c0

    run(p1, 5)
    assert run(p1, 5) == 0                    # cached
    assert run(p2, 5) == 1                    # new params
    assert run(p1, 3) == 1                    # new batch
    with torch.no_grad():
        p1["final_ln"]["scale"].mul_(0.5)     # updated in place
    assert run(p1, 5) == 1


@pytest.mark.gpu
def test_token_graph_goes_with_its_weights(dev):
    """The cached token graph keeps none of the caller's tensors: once the
    params are dropped its entry and its memory go."""
    import gc

    from reinforcement_learning_in_music_generation_torch.generate import sampler as tsam
    cfg, params, _ = _stack_setup(dev)
    init = torch.zeros((5, 1, 6), dtype=torch.int32, device=dev)
    kw = dict(max_tokens=8, greedy=True, settings=tsmp.GREEDY, fused=True, fused_sampling=True)
    p = tlt.cast_params(params, torch.bfloat16)
    tsam.generate_tokens(p, cfg, init, **kw)
    del p
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    keys = set(tsam._TOKEN_GRAPHS)
    p = tlt.cast_params(params, torch.bfloat16)
    tsam.generate_tokens(p, cfg, init, **kw)
    assert len(set(tsam._TOKEN_GRAPHS) - keys) == 1
    del p
    torch.cuda.synchronize()
    assert set(tsam._TOKEN_GRAPHS) <= keys
    assert torch.cuda.memory_allocated() <= base + (1 << 20)    # the graph's 12 MB went


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
    f = tdk6.fused_decode_v6
    calls, cuda, positions = f.tc_calls, f.cuda_launches, f.positions
    ok, _, _ = tdk6.fused_decode_v6(v6p, tok0, s1.s, s1.z, 0, 1, vocab_sizes=VOCAB, **kw)
    op, _, _ = tdk6.fused_decode_v6_plain(v6p, tok0, s2.s, s2.z, 0, 1, **kw)
    assert (ok == op).float().mean() >= 0.95
    # both weight types reach the tensor-core route: one kernel and T graph
    # launches a call
    assert (f.tc_calls, f.cuda_launches, f.positions) == (calls + 1, cuda + 25, positions + 24)
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


# kernel B's tensor-core route: (d_model, n_head, d_inner) at the tests'
# small width and at agent_config's (depth cut to 2 layers), and heads of 8
# (the state pass without 16-byte pieces); f32 weights also at widths bf16
# weights cannot take (rows not a multiple of 8: the products read padded
# planes)
TC_WIDTHS = [(64, 2, 128), (512, 8, 2048), (32, 4, 64)]
TC_CASES = ([w + (torch.bfloat16,) for w in TC_WIDTHS]
            + [w + (torch.float32,) for w in TC_WIDTHS + [(12, 3, 100), (20, 5, 36)]])


def _tc_setup(dev, d_model, n_head, d_inner, wdt=torch.bfloat16):
    cfg = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=d_model,
                                     n_layer=2, n_head=n_head, d_inner=d_inner, max_len=512)
    params = tlt.init_params(cfg, seed=4, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    return cfg, tdk6.make_v6_params(params, cfg, dtype=wdt), gen


def _teacher_forced(v6p, cfg, gen, dev, b, sdt, n_head, steps=16, twin=None):
    """The route and the twin (of ``twin`` params, default the route's)
    fed the same random tokens one a call, greedy, from zero states:
    (agreeing decisions, decisions, route's state, twin's state)."""
    twin = v6p if twin is None else twin
    kw = dict(n_head=n_head, max_tokens=1, temps=(1.0,) * 6, topps=(float("inf"),) * 6,
              greedy=True, eps=cfg.attn_eps)
    sk = tdk4.init_state(cfg, b, sdt, dev)
    sp = tdk4.init_state(cfg, b, sdt, dev)
    agree = total = 0
    for t in range(steps):
        tok = _tokens(gen, dev, b)
        ok, _, _ = tdk6.fused_decode_v6(v6p, tok, sk.s, sk.z, t, 3, vocab_sizes=VOCAB, **kw)
        op, _, _ = tdk6.fused_decode_v6_plain(twin, tok, sp.s, sp.z, t, 3, **kw)
        agree += int((ok == op).sum())
        total += ok.numel()
    return agree, total, sk, sp


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head,d_inner,wdt", TC_CASES)
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
def test_decode_chunk_tc_matches_its_twin(dev, d_model, n_head, d_inner, wdt, sdt):
    """The tensor-core route against its twin of v6's arithmetic,
    teacher-forced, one token a call, 16 tokens, at B = 1, 65, 100, 128 and
    200 (ragged row tiles): greedy next tokens equal on >= 99% of all the
    (token, song, field) decisions (with bf16 weights both round the same
    f32 activations to bf16; the sums' order differs, so near-ties may
    flip); with an f32 state, S within 1e-4 of max|S| at every B.  Every
    call takes the tensor-core route: one kernel and one graph launch a
    token."""
    cfg, v6p, gen = _tc_setup(dev, d_model, n_head, d_inner, wdt)
    agree = total = 0
    for b in (1, 65, 100, 128, 200):
        calls, cuda = tdk6.fused_decode_v6.tc_calls, tdk6.fused_decode_v6.cuda_launches
        a, n, sk, sp = _teacher_forced(v6p, cfg, gen, dev, b, sdt, n_head)
        agree += a
        total += n
        assert tdk6.fused_decode_v6.tc_calls == calls + 16
        assert tdk6.fused_decode_v6.cuda_launches == cuda + 2 * 16
        if sdt == torch.float32:
            _close(sk.s, sp.s, 1e-4, f"S at B={b}")
    assert agree / total >= 0.99, f"agreement {agree / total}"


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head,d_inner", TC_WIDTHS)
def test_decode_chunk_f32_gate_holds_bf16_weights_above_it(dev, d_model, n_head, d_inner):
    """The control of the f32 weights' gate: at an f32 state the route on
    the weights rounded to bf16, teacher-forced against the twin on the f32
    weights, ends above 1e-4 of max|S| at B = 128, where the route on the
    f32 weights ends below it (``-s`` prints both shares)."""
    cfg, v6p, gen = _tc_setup(dev, d_model, n_head, d_inner, torch.float32)
    v6b = _tc_setup(dev, d_model, n_head, d_inner, torch.bfloat16)[1]
    seed = int(torch.randint(0, 2 ** 31, (1,), generator=gen, device=dev))
    shares = []
    for route in (v6p, v6b):
        gen.manual_seed(seed)
        _, _, sk, sp = _teacher_forced(route, cfg, gen, dev, 128, torch.float32, n_head,
                                       twin=v6p)
        shares.append(_share(sk.s, sp.s))
    print(f"[gate] decode_chunk f32 weights ({d_model}, {n_head}, {d_inner}): route "
          f"{shares[0]:.3e}, bf16-weights control {shares[1]:.3e} of max|S| (gate 1e-4)")
    assert shares[0] <= 1e-4 < shares[1]


@pytest.mark.gpu
@pytest.mark.parametrize("greedy", [True, False])
@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32])
def test_decode_chunk_tc_is_chunk_invariant(dev, greedy, wdt):
    """One call of 64 tokens equals two of 32, tokens and state bit for bit
    (no float atomics; the splits and the Philox counter depend on the
    shapes and the position only), at a ragged batch, at both weight
    types."""
    cfg, v6p, gen = _tc_setup(dev, 64, 2, 128, wdt)
    b = 65
    kw = dict(n_head=2, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS, greedy=greedy,
              eps=cfg.attn_eps)
    tok0 = _tokens(gen, dev, b)
    s1 = tdk4.init_state(cfg, b, device=dev)
    s2 = tdk4.init_state(cfg, b, device=dev)
    one, _, _ = tdk6.fused_decode_v6(v6p, tok0, s1.s, s1.z, 3, 17, max_tokens=64, **kw)
    first, _, _ = tdk6.fused_decode_v6(v6p, tok0, s2.s, s2.z, 3, 17, max_tokens=32, **kw)
    rest, _, _ = tdk6.fused_decode_v6(v6p, first[-1].contiguous(), s2.s, s2.z, 35, 17,
                                      max_tokens=32, **kw)
    assert torch.equal(one, torch.cat([first, rest]))
    assert torch.equal(s1.s, s2.s) and torch.equal(s1.z, s2.z)
    assert (one >= 0).all() and (one < torch.tensor(VOCAB, device=dev)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("wdt", [torch.bfloat16, torch.float32])
def test_decode_chunk_tc_graph_serves_every_call(dev, wdt):
    """One token graph a shape and weight type.  The seed, the sampling
    mode and the position reach it through a block on the card: calls that
    change them instantiate nothing, and each call's tokens are the ones
    its own values give (seed 2 again after seed 1 repeats seed 2's tokens
    bit for bit; seed 1's differ).  A call on another state tensor updates
    the graph in place and decodes as a call on the first one does."""
    cfg, v6p, gen = _tc_setup(dev, 64, 2, 128, wdt)
    b = 65
    kw = dict(n_head=2, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS, max_tokens=8,
              eps=cfg.attn_eps)
    f = tdk6.fused_decode_v6
    tok0 = _tokens(gen, dev, b)
    st = tdk4.init_state(cfg, b, device=dev)

    def run(state, seed, t0=0, greedy=False):
        state.s.zero_()
        state.z.zero_()
        out, _, _ = f(v6p, tok0, state.s, state.z, t0, seed, greedy=greedy, **kw)
        return out

    x2 = run(st, 2)
    captures = f.captures
    x1 = run(st, 1)
    assert torch.equal(run(st, 2), x2) and not torch.equal(x1, x2)
    assert not torch.equal(run(st, 2, t0=5), x2)
    g = run(st, 2, greedy=True)
    assert f.captures == captures
    other = tdk4.init_state(cfg, b, device=dev)
    updates = f.updates
    assert torch.equal(run(other, 2, greedy=True), g) and torch.equal(run(other, 2), x2)
    assert f.updates > updates and f.captures == captures
    sp = tdk4.init_state(cfg, b, device=dev)
    gp, _, _ = tdk6.fused_decode_v6_plain(v6p, tok0, sp.s, sp.z, 0, 2, n_head=2, max_tokens=1,
                                          temps=CP_TEMPS, topps=CP_TOPPS, greedy=True,
                                          eps=cfg.attn_eps)
    assert (g[0] == gp[0]).float().mean().item() >= 0.99


@pytest.mark.gpu
def test_decode_chunk_tc_rejects_what_it_does_not_take(dev):
    """bf16 weights at a d_model f32 weights take but the bf16 products do
    not (12: their operand rows are read in place in 16-byte pieces) raise;
    there is no other route for them.  f32 weights without the planes
    make_v6_params packs raise too."""
    cfg, v6p, gen = _tc_setup(dev, 12, 3, 64)
    st = tdk4.init_state(cfg, 3, device=dev)
    before = tdk6.fused_decode_v6.launches
    kw = dict(n_head=3, max_tokens=4, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS)
    with pytest.raises(ValueError, match="multiples of 8"):
        tdk6.fused_decode_v6(v6p, _tokens(gen, dev, 3), st.s, st.z, 0, 0, **kw)
    v6f = _tc_setup(dev, 12, 3, 64, torch.float32)[1]
    with pytest.raises(ValueError, match="planes"):
        tdk6.fused_decode_v6(v6f._replace(planes=None), _tokens(gen, dev, 3), st.s, st.z, 0, 0,
                             **kw)
    assert tdk6.fused_decode_v6.launches == before


def _share(a, b):
    """max |a - b| / max(1, max |b|)."""
    err = (a.float() - b.float()).abs().max().item()
    return err / max(1.0, b.float().abs().max().item())


def _close(a, b, tol, what):
    """max |a - b| <= tol * max(1, max |b|)."""
    err = (a.float() - b.float()).abs().max().item()
    mag = max(1.0, b.float().abs().max().item())
    assert err <= tol * mag, f"{what}: max |diff| {err} vs {tol} x {mag}"


def _fwd_bwd(fn, inputs, g):
    ts = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, g)
    return out.detach(), grads


# (sequences, rows each, heads, d_model, chunk, dtype): row counts that are
# not multiples of the kernel's 64-row tile, and bfloat16; heads of 64 (the
# model's) at S <= 64 (one launch a pass), S = 512 (the state pass) and
# 120 rows
QKV_CASES = [(3, 40, 2, 32, 8, torch.float32), (2, 200, 4, 64, 40, torch.float32),
             (2, 72, 2, 32, 8, torch.bfloat16), (2, 64, 1, 64, 16, torch.float32),
             (2, 64, 1, 64, 16, torch.bfloat16), (2, 512, 8, 512, 128, torch.float32),
             (2, 512, 8, 512, 128, torch.bfloat16), (3, 40, 2, 128, 8, torch.float32),
             (3, 40, 2, 128, 8, torch.bfloat16)]


def _smoke():
    """chip_smoke.py as a module (its main is guarded): the gates and
    helpers the card tests share with it."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


@pytest.mark.gpu
@pytest.mark.parametrize("n_seq,s,n_head,d,chunk,dtype", QKV_CASES)
def test_qkv_attention_kernel_matches_plain(dev, n_seq, s, n_head, d, chunk, dtype):
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    rnd = lambda *shape, sc=1.0: (torch.randn(shape, generator=gen, device=dev) * sc).to(dtype)
    h, w, b = rnd(n_seq * s, d), rnd(d, 3 * d, sc=0.2), rnd(3 * d, sc=0.1)
    g = rnd(n_seq * s, d)
    before = (tab.qkv_attention_block.launches_fwd, tab.qkv_attention_block.launches_bwd)
    if dtype == torch.bfloat16:
        # the twin computes JAX's arithmetic (f32 projection and attention,
        # stores rounded): every tensor within chip_smoke's C_BF16_GATES,
        # and the kernel with its attention on the rounded residual (the
        # parent kernel's fault) above their mean limits
        smoke = _smoke()
        readings = smoke.qkv_bf16_readings(tab, h, w, b, g, n_seq, n_head, chunk)
        for name, r in readings.items():
            print(f"[gate] C bf16 {(n_seq, s, n_head, d)} {name}: kernel max / mean "
                  f"{r['kernel'][0]:.3e} / {r['kernel'][1]:.3e}, rounded-residual control "
                  f"{r['control'][0]:.3e} / {r['control'][1]:.3e}, gate "
                  f"{smoke.C_BF16_GATES[name][0]:.3e} / {smoke.C_BF16_GATES[name][1]:.3e}")
        assert not smoke.qkv_bf16_gate_failures(readings)
    else:
        ok, gk = _fwd_bwd(lambda *a: tab.qkv_attention_block(*a, n_seq, n_head, chunk=chunk),
                          (h, w, b), g)
        op, gp = _fwd_bwd(lambda *a: tab.qkv_attention_block_plain(*a, n_seq, n_head,
                                                                   chunk=chunk), (h, w, b), g)
        # both sides sum in f32 in another order
        assert ok.dtype == dtype and all(x.dtype == dtype for x in gk)
        _close(ok, op, 1e-4, "att")
        for name, x, y in zip(("dh", "dw", "db"), gk, gp):
            assert torch.isfinite(x.float()).all(), name
            _close(x, y, 1e-3, name)
    assert (tab.qkv_attention_block.launches_fwd, tab.qkv_attention_block.launches_bwd) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_qkv_attention_counts_its_runs(dev, dtype):
    """C's attention passes count each call that ran on the card: one
    forward and one backward run a call, at S <= 64 and past it."""
    for n_seq, s in ((2, 64), (2, 200)):
        h = torch.randn((n_seq * s, 64), device=dev).to(dtype)
        w = (torch.randn((64, 192), device=dev) * 0.2).to(dtype)
        b = torch.zeros(192, device=dev, dtype=dtype)
        tab.kernel_runs(reset=True)
        for i in range(1, 3):
            _fwd_bwd(lambda *a: tab.qkv_attention_block(*a, n_seq, 2, chunk=8), (h, w, b),
                     torch.ones_like(h))
            assert tab.kernel_runs() == (i, i)


@pytest.mark.gpu
def test_qkv_projection_runs_on_wgmma(dev):
    """The projection kernel's SASS holds warpgroup MMA (HGMMA) at both
    arithmetics (chip_smoke.py's mma_counts over cuobjdump -sass)."""
    import subprocess

    from reinforcement_learning_in_music_generation_torch.ops import _build

    smoke = _smoke()
    tool = smoke.cuobjdump_path()
    if tool is None:
        pytest.skip("no cuobjdump (CUDA toolkit or Triton) to read the SASS")
    _build.load("attention_block")
    sass = subprocess.run([tool, "-sass", str(_build._target("attention_block"))],
                          capture_output=True, text=True, timeout=300)
    assert sass.returncode == 0, sass.stderr[-500:]
    # the listing's function headers and its HGMMA lines alone: mma_counts
    # then counts warpgroup MMA only (not mma.sync's HMMA)
    hgmma = "\n".join(line for line in sass.stdout.splitlines()
                      if "Function :" in line or "HGMMA" in line)
    counts = smoke.mma_counts(hgmma, "wg_gemm_kernel")
    assert len(counts) == 2 and all(n > 0 for n in counts.values()), counts


@pytest.mark.gpu
@pytest.mark.parametrize("n,d,di", [(100, 32, 64), (300, 64, 256)])
@pytest.mark.parametrize("p,mid_drop", [(0.0, True), (0.1, True), (0.1, False)])
def test_attn_tail_kernel_matches_plain(dev, n, d, di, p, mid_drop):
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rnd = lambda *shape, sc=1.0: torch.randn(shape, generator=gen, device=dev) * sc
    inputs = (rnd(n, d), rnd(n, d), rnd(d, d, sc=0.2), rnd(d, sc=0.1), 1 + rnd(d, sc=0.1),
              rnd(d, sc=0.1), rnd(d, di, sc=0.2), rnd(di, sc=0.1), rnd(di, d, sc=0.1),
              rnd(d, sc=0.1), 1 + rnd(d, sc=0.1), rnd(d, sc=0.1))
    g = rnd(n, d)
    seed = torch.tensor(123457, dtype=torch.int32, device=dev)
    before = (tfb.attn_tail_block.launches_fwd, tfb.attn_tail_block.launches_bwd)
    ok, gk = _fwd_bwd(lambda *a: tfb.attn_tail_block(*a, seed, p, mid_drop), inputs, g)
    op, gp = _fwd_bwd(lambda *a: tfb.attn_tail_block_plain(*a, seed, p, mid_drop), inputs, g)
    _close(ok, op, 1e-4, "out")
    names = ("dh_in", "da_pre", "dwo_w", "dwo_b", "dln1_s", "dln1_b", "dw1", "db1", "dw2",
             "db2", "dln2_s", "dln2_b")
    for name, x, y in zip(names, gk, gp):
        _close(x, y, 1e-3, name)
    assert (tfb.attn_tail_block.launches_fwd, tfb.attn_tail_block.launches_bwd) == \
        (before[0] + 1, before[1] + 1)


@pytest.mark.gpu
def test_attn_tail_kernel_is_deterministic(dev):
    """No atomics: two backward launches give bit-equal gradients."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    n, d, di = 1000, 64, 128
    rnd = lambda *shape: torch.randn(shape, generator=gen, device=dev) * 0.2
    ws = [rnd(d, d), rnd(d), 1 + rnd(d), rnd(d), rnd(d, di), rnd(di), rnd(di, d), rnd(d),
          1 + rnd(d), rnd(d)]
    h, a, dout = rnd(n, d), rnd(n, d), rnd(n, d)
    seed = torch.tensor(9, dtype=torch.int32, device=dev)
    g1 = tfb.backward_kernel(h, a, ws, dout, seed, 0.1, True)
    g2 = tfb.backward_kernel(h, a, ws, dout, seed, 0.1, True)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


def _band_inputs(dev, b, h, s, d, tail, layout, seed=6):
    """q, k, v (B, H, S, D) in the layout the Longformer passes ("bshd":
    transposed views of (B, S, H, D) tensors) or contiguous; mask with the
    last ``tail`` rows of song 0 padded; dO zero on padded rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (b, s, h, d) if layout == "bshd" else (b, h, s, d)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    if layout == "bshd":
        q, k, v, g = (t.transpose(1, 2) for t in (q, k, v, g))
    mask = torch.ones((b, s), device=dev)
    mask[0, s - tail:] = 0.0
    return q, k, v, mask, g * mask[:, None, :, None]


# (B, H, S, D, window, padding tail, layout): a ragged last tile, a window
# wider than a tile, a padding tail longer than w (rows that see no kept
# key), narrow heads
BAND_CASES = [(2, 2, 200, 64, 50, 17, "bhsd"), (1, 3, 300, 64, 300, 40, "bshd"),
              (2, 2, 256, 32, 64, 100, "bshd"), (1, 2, 130, 8, 16, 0, "bhsd")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d,window,tail,layout", BAND_CASES)
def test_window_attention_kernel_matches_plain(dev, b, h, s, d, window, tail, layout):
    from reinforcement_learning_in_music_generation_torch.ops import (
        window_attention_kernel as twk)
    q, k, v, mask, g = _band_inputs(dev, b, h, s, d, tail, layout)
    before = (twk.window_attention_band.launches_fwd, twk.window_attention_band.launches_bwd)
    ok, gk = _fwd_bwd(lambda *a: twk.window_attention_band(*a, mask, window), (q, k, v), g)
    op, gp = _fwd_bwd(lambda *a: twk.window_attention_band_plain(*a, mask, window)[0],
                      (q, k, v), g)
    assert (twk.window_attention_band.launches_fwd, twk.window_attention_band.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    _close(ok, op, 1e-5, "out")
    for name, x, y in zip(("dq", "dk", "dv"), gk, gp):
        assert torch.isfinite(x).all(), name
        _close(x, y, 1e-4, name)
    lse = twk.forward_kernel(q, k, v, mask, window)[1].sum(0)
    _close(lse, twk.window_attention_band_plain(q, k, v, mask, window)[1], 1e-5, "lse")


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d,window,tail,layout", BAND_CASES)
def test_window_attention_gates_hold_bf16_inputs_above_them(dev, b, h, s, d, window, tail,
                                                             layout):
    """The control of the kernel's gates: the plain twin on q, k, v rounded
    to bf16 ends above 1e-5 of out's magnitude and 1e-4 of each gradient's
    from the twin on the f32 inputs, where the kernel ends below them
    (``-s`` prints both)."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        window_attention_kernel as twk)
    q, k, v, mask, g = _band_inputs(dev, b, h, s, d, tail, layout)
    plain = lambda *a: twk.window_attention_band_plain(*a, mask, window)[0]
    ok, gk = _fwd_bwd(lambda *a: twk.window_attention_band(*a, mask, window), (q, k, v), g)
    op, gp = _fwd_bwd(plain, (q, k, v), g)
    oc, gc = _fwd_bwd(plain, [t.bfloat16().float() for t in (q, k, v)], g)
    kern = [_share(ok, op)] + [_share(x, y) for x, y in zip(gk, gp)]
    ctl = [_share(oc, op)] + [_share(x, y) for x, y in zip(gc, gp)]
    print(f"[gate] window_attention {(b, h, s, d, window, tail)}: kernel (out, dq, dk, dv) "
          + ", ".join(f"{x:.2e}" for x in kern) + "; bf16-input control "
          + ", ".join(f"{x:.2e}" for x in ctl) + " (gates 1e-5, 1e-4)")
    assert kern[0] <= 1e-5 < ctl[0]
    assert all(x <= 1e-4 < y for x, y in zip(kern[1:], ctl[1:]))


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d,window,tail,layout", BAND_CASES)
def test_window_attention_bf16_kernel_holds_its_gates(dev, b, h, s, d, window, tail, layout):
    """bf16 tensors against the twin of JAX's bf16 arithmetic: out (kept
    rows) and every gradient within chip_smoke's E_BF16_GATES, the twin
    with P and dS rounded before their products above the mean limits
    (``-s`` prints both); two bf16 backward runs bit-equal."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        window_attention_kernel as twk)
    smoke = _smoke()
    q, k, v, mask, g = (t.bfloat16() if t.ndim == 4 else t
                        for t in _band_inputs(dev, b, h, s, d, tail, layout))
    readings, ok = smoke.band_bf16_readings(twk, q, k, v, mask, window, g)
    print(f"[gate] window_attention bf16 {(b, h, s, d, window, tail)}: " + "; ".join(
        f"{n} {r['kernel'][0]:.2e} / {r['kernel'][1]:.2e} (control {r['control'][1]:.2e})"
        for n, r in readings.items()))
    assert all(x.dtype == torch.bfloat16 for x in ok)
    assert not smoke.bf16_gate_failures(readings, smoke.E_BF16_GATES, {"control": "control"})
    out, stats = twk.forward_kernel(q, k, v, mask, window)
    g1 = twk.backward_kernel(q, k, v, mask, out, stats, g, window)
    g2 = twk.backward_kernel(q, k, v, mask, out, stats, g, window)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


def _padded(t, extra=4):
    """t (B, H, S, D) as a view of rows padded by ``extra`` elements (row
    stride D + extra: a multiple of 4, not of 8 where D is)."""
    b, h, s, d = t.shape
    full = torch.zeros((b, h, s, d + extra), dtype=t.dtype, device=t.device)
    full[..., :d] = t
    return full[..., :d]


@pytest.mark.gpu
def test_zero_plane_products_leave_an_f32_sum_bit_equal(dev):
    """The premise of the bf16 routes of kernels E and F: on bf16-valued
    operands, a sum taken with the six plane products (mma6: the zero mid
    and lo planes included) equals, bit for bit, the one with only the
    products of planes both operands hold (three or one: mma_pl); an
    mma.sync of a zero operand leaves a nonzero f32 accumulator's bits.
    Operands span 2^-20 .. 2^20 a row, so the tensor cores truncate what
    they add.  The control: an f32 operand (nonzero mid and lo planes) read
    as one plane differs."""
    import ctypes

    from reinforcement_learning_in_music_generation_torch.ops import _build
    lib = _build.load("causal_product")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rlmg_causal_product_mma_probe.argtypes = [p, p, p, p, i, i, i, i, p]
    lib.rlmg_causal_product_mma_probe.restype = i
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    n, k = 512, 64
    scale = lambda *s: torch.exp2(torch.randint(-20, 21, s, generator=gen, device=dev).float())
    a = torch.randn((n, 16, k), generator=gen, device=dev) * scale(n, 16, 1)
    b = torch.randn((n, 8, k), generator=gen, device=dev) * scale(n, 8, 1)
    c0 = torch.randn((n, 16, 8), generator=gen, device=dev) * scale(n, 16, 1)

    def probe(x, y, pa, pb):
        c = torch.empty_like(c0)
        rc = lib.rlmg_causal_product_mma_probe(x.data_ptr(), y.data_ptr(), c0.data_ptr(),
                                               c.data_ptr(), n, k, pa, pb,
                                               torch.cuda.current_stream().cuda_stream)
        assert rc == 0, rc
        torch.cuda.synchronize()
        return c.view(torch.int32)

    ab, bb = a.bfloat16().float(), b.bfloat16().float()
    assert torch.equal(probe(a, b, 0, 3), c0.view(torch.int32))
    assert torch.equal(probe(a, bb, 3, 3), probe(a, bb, 3, 1))
    assert torch.equal(probe(ab, b, 3, 3), probe(ab, b, 1, 3))
    assert torch.equal(probe(ab, bb, 3, 3), probe(ab, bb, 1, 1))
    assert (probe(a, b, 3, 3) != probe(a, b, 1, 3)).sum() > n * 64


# (B, H, S, E, layout): head widths that are multiples of 4 but not of 8
# (the 8-byte copies), 64 in the model's layout (16-byte copies) and in
# padded rows (8-byte copies), one tile and several
EXACT_PRODUCT_CASES = [(2, 3, 130, 20, "bhse"), (2, 2, 67, 36, "bshe"), (1, 8, 50, 64, "bshe"),
                       (2, 8, 300, 64, "bshe"), (2, 2, 200, 64, "pad"), (3, 2, 40, 36, "pad")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,e,layout", EXACT_PRODUCT_CASES)
def test_causal_product_bf16_equals_its_f32_route_rounded(dev, b, h, s, e, layout):
    """Kernel F's bf16 forward (one plane a bf16 tile, one or three
    products a product) equals, bit for bit, its f32 route on the widened
    inputs, its out and den rounded to bf16 (chip_smoke phase 11's exact
    gate); the control (A and the state rounded: a dropped plane of each)
    differs in both.  Two bf16 backward runs bit-equal."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention_kernel as tlk)
    smoke = _smoke()
    pq, pk, v, g = _product_inputs(dev, b, h, s, e, "bshe" if layout == "bshe" else "bhse")
    pq, pk, v, g = (t.bfloat16() for t in (pq, pk, v, g))
    pq, pk, v, g = (_padded(t) if layout == "pad" else t for t in (pq, pk, v, g))
    got = tlk.forward_kernel(pq, pk, v, 1e-6)
    readings = smoke.product_exact_readings(tlk.forward_kernel, pq, pk, v, 1e-6, got, 128)
    print(f"[gate] causal_product bf16 exact {(b, h, s, e, layout)}: {readings}")
    assert not smoke.exact_gate_failures(readings), readings
    g1 = tlk.backward_kernel(pq, pk, v, *got, g, 1e-6)
    g2 = tlk.backward_kernel(pq, pk, v, *got, g, 1e-6)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


EXACT_BAND_CASES = [(2, 2, 300, 20, 100, 40, "bshd"), (1, 3, 260, 36, 64, 100, "bhsd"),
                    (2, 2, 200, 64, 50, 17, "bshd"), (1, 2, 330, 64, 300, 0, "pad"),
                    (2, 2, 140, 36, 16, 70, "pad")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,d,window,tail,layout", EXACT_BAND_CASES)
def test_window_attention_bf16_equals_its_f32_route_rounded(dev, b, h, s, d, window, tail,
                                                             layout):
    """Kernel E's bf16 forward and backward (one plane a bf16 tile, one or
    three products a product) equal, bit for bit, its f32 route on the
    widened operands, rounded to bf16, the stored bf16 out handed to the
    f32 backward (chip_smoke phase 7's exact gate), and the row statistics
    equal the f32 route's; the control (P and dS rounded: a dropped plane
    of each) differs in every tensor."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        window_attention_kernel as twk)
    smoke = _smoke()
    q, k, v, mask, g = _band_inputs(dev, b, h, s, d, tail, "bshd" if layout == "bshd" else "bhsd")
    q, k, v, g = (t.bfloat16() for t in (q, k, v, g))
    q, k, v, g = (_padded(t) if layout == "pad" else t for t in (q, k, v, g))
    out, stats = twk.forward_kernel(q, k, v, mask, window)
    got = (out, *twk.backward_kernel(q, k, v, mask, out, stats, g, window))
    readings = smoke.band_exact_readings(twk, twk.forward_kernel, twk.backward_kernel, q, k, v,
                                         mask, window, g, got)
    print(f"[gate] window_attention bf16 exact {(b, h, s, d, window, tail, layout)}: {readings}")
    assert not smoke.exact_gate_failures(readings), readings
    stats32 = twk.forward_kernel(q.float(), k.float(), v.float(), mask, window)[1]
    assert smoke.bit_diffs(stats, stats32) == 0


@pytest.mark.gpu
def test_window_attention_kernel_is_deterministic(dev):
    """No atomics: two backward launches give bit-equal gradients."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        window_attention_kernel as twk)
    q, k, v, mask, g = _band_inputs(dev, 2, 4, 640, 64, 300, "bshd")
    out, stats = twk.forward_kernel(q, k, v, mask, 512)
    g1 = twk.backward_kernel(q, k, v, mask, out, stats, g, 512)
    g2 = twk.backward_kernel(q, k, v, mask, out, stats, g, 512)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.gpu
def test_window_attention_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from reinforcement_learning_in_music_generation_torch.ops import (
        window_attention_kernel as twk)
    x = torch.zeros((1, 2, 64, 16), device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        twk.window_attention_band(x.half(), x.half(), x.half(), None, 16)
    wide = torch.zeros((1, 2, 64, 72), device=dev)
    with pytest.raises(ValueError, match="head width"):
        twk.window_attention_band(wide, wide, wide, None, 16)
    with pytest.raises(ValueError, match="strides"):
        y = torch.zeros((1, 2, 64, 20), device=dev)[..., 1:17]
        twk.window_attention_band(y, y, y, None, 16)
    with pytest.raises(ValueError, match="mask"):
        twk.window_attention_band(x, x, x, torch.ones((1, 63), device=dev), 16)


@pytest.mark.gpu
def test_training_wrappers_reject_what_the_kernels_do_not_take(dev):
    h = torch.zeros((2 * 24, 32), device=dev)
    w, b = torch.zeros((32, 96), device=dev), torch.zeros(96, device=dev)
    with pytest.raises(ValueError, match="not divisible by chunk"):
        tab.qkv_attention_block(h, w, b, 2, 2, chunk=16)
    with pytest.raises(TypeError):
        tab.qkv_attention_block(h.double(), w.double(), b.double(), 2, 2, chunk=8)
    with pytest.raises(ValueError, match="contiguous"):
        tab.qkv_attention_block(h, w.T.contiguous().T, b, 2, 2, chunk=8)
    # heads of 72: wider than the kernel's 64, an error and not the plain version
    h144 = torch.zeros((2 * 24, 144), device=dev)
    with pytest.raises(ValueError, match="head width"):
        tab.qkv_attention_block(h144, torch.zeros((144, 432), device=dev),
                                torch.zeros(432, device=dev), 2, 2, chunk=8)
    ws = [torch.zeros(s, device=dev) for s in ((32, 32), (32,), (32,), (32,), (32, 64), (64,),
                                               (64, 32), (32,), (32,), (32,))]
    with pytest.raises(TypeError, match="like the input"):     # one dtype for every tensor
        tfb.attn_tail_block(h.bfloat16(), h.bfloat16(), *ws, 0, 0.0)
    with pytest.raises(ValueError, match="shape"):
        tfb.attn_tail_block(h, h[:, :16].contiguous(), *ws, 0, 0.0)


# kernels D and G on bf16 tensors against their twins, which compute JAX's
# bf16 arithmetic (operands rounded to bf16, f32 sums, f32 elementwise):
# every tensor within 2^-7 of its magnitude, one bf16 step at it (the two
# differ only in the order of f32 sums, which can move a rounding)
BF16_TOL = 2 ** -7
TAIL_GRADS = ("dh_in", "da_pre", "dwo_w", "dwo_b", "dln1_s", "dln1_b", "dw1", "db1", "dw2",
              "db2", "dln2_s", "dln2_b")
FFN_GRADS = ("dh", "dw1", "db1", "dw2", "db2", "dln_s", "dln_b")


def _tail_inputs(dev, n, d, di, seed=4):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape, sc=1.0: torch.randn(shape, generator=gen, device=dev) * sc
    inputs = (rnd(n, d), rnd(n, d), rnd(d, d, sc=0.2), rnd(d, sc=0.1), 1 + rnd(d, sc=0.1),
              rnd(d, sc=0.1), rnd(d, di, sc=0.2), rnd(di, sc=0.1), rnd(di, d, sc=0.1),
              rnd(d, sc=0.1), 1 + rnd(d, sc=0.1), rnd(d, sc=0.1))
    return inputs, rnd(n, d)


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 50, 300])
@pytest.mark.parametrize("p,mid_drop", [(0.0, True), (0.1, True), (0.1, False)])
def test_attn_tail_kernel_matches_plain_bf16(dev, n, p, mid_drop):
    inputs, g = _tail_inputs(dev, n, 64, 256)
    inputs, g = tuple(t.bfloat16() for t in inputs), g.bfloat16()
    seed = torch.tensor(123457, dtype=torch.int32, device=dev)
    ok, gk = _fwd_bwd(lambda *a: tfb.attn_tail_block(*a, seed, p, mid_drop), inputs, g)
    op, gp = _fwd_bwd(lambda *a: tfb.attn_tail_block_plain(*a, seed, p, mid_drop), inputs, g)
    assert ok.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in gk)
    _close(ok, op, BF16_TOL, "out")
    for name, x, y in zip(TAIL_GRADS, gk, gp):
        assert torch.isfinite(x).all(), name
        _close(x, y, BF16_TOL, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_attn_tail_kernel_is_deterministic_at_each_dtype(dev, dt):
    inputs, g = _tail_inputs(dev, 1000, 64, 128, seed=5)
    (h, a, *ws), g = [t.to(dt) for t in inputs], g.to(dt)
    seed = torch.tensor(9, dtype=torch.int32, device=dev)
    g1 = tfb.backward_kernel(h, a, ws, g, seed, 0.1, True)
    g2 = tfb.backward_kernel(h, a, ws, g, seed, 0.1, True)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


def _layout_operands(dev, m, n, k, layout, dt, seed=6):
    """(a, b, a_t, b_t) of op(a) @ op(b) at (M, N, K) in ``layout``: "nn"
    (forward products), "nt" (x @ W^T), "tn" (X^T @ dY, K = rows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    a_t, b_t = layout == "tn", layout == "nt"
    a = torch.randn((k, m) if a_t else (m, k), generator=gen, device=dev).to(dt)
    b = torch.randn((n, k) if b_t else (k, n), generator=gen, device=dev).to(dt)
    return a, b, a_t, b_t


# (M, N, K) per layout: the ragged dimension is the one stored as rows (M for
# nn and nt, K, the rows of X and dY, for tn); the last case of each is past
# 2^28 multiply-adds, so it takes the 128 x 128 tiles and a K split
TILE_CASES = ([("nn", m, 40, 72) for m in (1, 50, 100, 1500)]
              + [("nt", m, 56, 72) for m in (1, 50, 100, 1500)]
              + [("tn", 40, 72, k) for k in (1, 50, 100, 1500)]
              + [("nn", 1500, 256, 1024), ("nt", 1500, 256, 1024), ("tn", 512, 512, 1500)])


@pytest.mark.gpu
@pytest.mark.parametrize("layout,m,n,k", TILE_CASES)
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16])
def test_tile_product_matches_plain(dev, layout, m, n, k, dt):
    """Within 1e-5 of the result's magnitude of the f32 product of the same
    values: f32 operands on the split arithmetic (three bf16 planes, about
    2^-24 of a term dropped), bf16 operands exactly (the order of the sums
    differs)."""
    a, b, a_t, b_t = _layout_operands(dev, m, n, k, layout, dt)
    before = tfb.tile_product.cuda_launches
    c = tfb.tile_product(a, b, a_t, b_t)
    assert tfb.tile_product.cuda_launches > before
    ref = (a.T if a_t else a).float() @ (b.T if b_t else b).float()
    assert c.shape == (m, n) and torch.isfinite(c).all()
    _close(c, ref, 1e-5, f"{layout} {m}x{n}x{k}")


@pytest.mark.gpu
def test_tile_product_rejects_what_the_tile_does_not_take(dev):
    a, b, _, _ = _layout_operands(dev, 8, 16, 16, "nn", torch.float32)
    with pytest.raises(TypeError):
        tfb.tile_product(a, b.bfloat16())
    with pytest.raises(ValueError):
        tfb.tile_product(a.T.contiguous(), b.T.contiguous(), True, True)   # (A^T, B^T)
    with pytest.raises(ValueError, match="multiples of 8"):
        tfb.tile_product(a[:, :12].contiguous(), b[:12].contiguous())


def _product_inputs(dev, b, h, s, e, layout, seed=7):
    """phi(q), phi(k) (elu+1 of normals), v and dO (B, H, S, E) in the layout
    the model passes ("bshe": transposed views of (B, S, H, E) tensors) or
    contiguous."""
    from reinforcement_learning_in_music_generation_torch.ops import linear_attention as tla
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    shape = (b, s, h, e) if layout == "bshe" else (b, h, s, e)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev) for _ in range(4))
    if layout == "bshe":
        q, k, v, g = (t.transpose(1, 2) for t in (q, k, v, g))
    return tla.feature_map(q), tla.feature_map(k), v, g


# (B, H, S, E, layout): one row, DQN's one ragged tile, a ragged second tile,
# several tiles with a ragged last one, narrow heads, a rollout episode, the
# tile edge (one full tile; one row past it)
PRODUCT_CASES = [(2, 2, 1, 64, "bhse"), (3, 8, 50, 64, "bshe"), (2, 4, 67, 64, "bhse"),
                 (2, 8, 300, 64, "bshe"), (1, 2, 130, 8, "bhse"), (1, 8, 50, 64, "bshe"),
                 (2, 8, 64, 64, "bhse"), (2, 8, 65, 64, "bshe")]


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,e,layout", PRODUCT_CASES)
def test_causal_product_kernel_matches_plain(dev, b, h, s, e, layout):
    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention_kernel as tlk)
    pq, pk, v, g = _product_inputs(dev, b, h, s, e, layout)
    before = (tlk.causal_product.launches_fwd, tlk.causal_product.launches_bwd)
    ok, gk = _fwd_bwd(lambda *a: tlk.causal_product(*a)[0], (pq, pk, v), g)
    op, gp = _fwd_bwd(lambda *a: tlk.causal_product_plain(*a)[0], (pq, pk, v), g)
    assert (tlk.causal_product.launches_fwd, tlk.causal_product.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    assert ok.stride() == pq.stride()
    _close(ok, op, 1e-4, "out")
    den_k = tlk.causal_product(pq, pk, v)[1]
    _close(den_k, tlk.causal_product_plain(pq, pk, v)[1], 1e-4, "den")
    for name, x, y in zip(("dq", "dk", "dv"), gk, gp):
        assert torch.isfinite(x).all(), name
        _close(x, y, 1e-3, name)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,s,e,layout", [c for c in PRODUCT_CASES if c[2] > 1])
def test_causal_product_bf16_kernel_holds_its_gates(dev, b, h, s, e, layout):
    """bf16 tensors against the twin of JAX's bf16 arithmetic: out, den and
    every gradient within chip_smoke's F_BF16_GATES, the bf16 composition
    and (gradients) F's f32 route with den unrounded above the mean limits
    (``-s`` prints them); out and the gradients in the inputs' layout; two
    bf16 backward runs bit-equal.  Not at one row: den is then one product
    a row, which the bf16 composition rounds as the twin does."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention as tla, linear_attention_kernel as tlk)
    smoke = _smoke()
    pq, pk, v, g = (t.bfloat16() for t in _product_inputs(dev, b, h, s, e, layout))
    readings, ok = smoke.product_bf16_readings(tlk, tla, pq, pk, v, g, 1e-6, 128)
    print(f"[gate] causal_product bf16 {(b, h, s, e)}: " + "; ".join(
        f"{n} {r['kernel'][0]:.2e} / {r['kernel'][1]:.2e} (controls {r['control'][1]:.2e}"
        + (f", {r['control_f32_route'][1]:.2e}" if "control_f32_route" in r else "") + ")"
        for n, r in readings.items()))
    assert all(x.dtype == torch.bfloat16 for x in ok) and ok[0].stride() == pq.stride()
    assert not smoke.bf16_gate_failures(readings, smoke.F_BF16_GATES,
                                        {"control": "A", "control_f32_route": "B"})
    out, den = tlk.forward_kernel(pq, pk, v, 1e-6)
    g1 = tlk.backward_kernel(pq, pk, v, out, den, g, 1e-6)
    g2 = tlk.backward_kernel(pq, pk, v, out, den, g, 1e-6)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_remat_step_on_the_kernel_route_equals_the_step_without_it(dev, dtype, monkeypatch):
    """Kernels C and D (forced at a small shape), dropout 0.1: with remat
    the loss is bit-equal, the gradients within rtol 1e-4 / atol 1e-6, the
    generator ends in the same state, and C's and D's forward wrappers run
    twice a layer (the recompute), their backward once."""
    from reinforcement_learning_in_music_generation_torch.train import pretrain as tpre
    monkeypatch.setenv("RLMG_FFN_MIN_ROWS", "1")
    for k in ("RLMG_FFN_BACKEND", "RLMG_ATTN_BACKEND"):
        monkeypatch.delenv(k, raising=False)
    kw = dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=64, n_layer=2, n_head=2,
              d_inner=128, dropout=0.1, dtype=dtype)
    params = tlt.init_params(TC.LinearTransformerConfig(**kw), seed=0, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    x = torch.stack([torch.randint(0, v_, (2, 64), generator=gen, device=dev) for v_ in VOCAB],
                    -1)
    mask = torch.ones((2, 64), device=dev)
    out = {}
    for remat in (False, True):
        cfg = TC.LinearTransformerConfig(**kw, remat=remat)
        step_gen = torch.Generator(device=dev)
        step_gen.manual_seed(7)
        counts0 = (tab.qkv_attention_block.launches_fwd, tab.qkv_attention_block.launches_bwd,
                   tfb.attn_tail_block.launches_fwd, tfb.attn_tail_block.launches_bwd)
        grads, (loss, _) = tpre.agent_grad_step(params, cfg, x, x, mask, step_gen)
        counts = (tab.qkv_attention_block.launches_fwd, tab.qkv_attention_block.launches_bwd,
                  tfb.attn_tail_block.launches_fwd, tfb.attn_tail_block.launches_bwd)
        out[remat] = (loss, grads, step_gen.get_state(),
                      tuple(c - c0 for c, c0 in zip(counts, counts0)))
    (l0, g0, s0, c0), (l1, g1, s1, c1) = out[False], out[True]
    assert c0 == (2, 2, 2, 2) and c1 == (4, 2, 4, 2)
    assert torch.equal(l0, l1) and torch.equal(s0, s1)

    def leaves(t):
        return [y for v_ in t.values() for y in leaves(v_)] if isinstance(t, dict) else [t]
    for a, b_ in zip(leaves(g1), leaves(g0)):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=1e-6)


@pytest.mark.gpu
def test_causal_product_kernel_is_deterministic(dev):
    """No atomics: two backward launches give bit-equal gradients."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention_kernel as tlk)
    pq, pk, v, g = _product_inputs(dev, 4, 8, 300, 64, "bshe")
    out, den = tlk.forward_kernel(pq, pk, v, 1e-6)
    g1 = tlk.backward_kernel(pq, pk, v, out, den, g, 1e-6)
    g2 = tlk.backward_kernel(pq, pk, v, out, den, g, 1e-6)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.gpu
def test_causal_product_wrapper_rejects_what_the_kernel_does_not_take(dev):
    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention_kernel as tlk)
    x = torch.ones((1, 2, 50, 64), device=dev)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tlk.causal_product(x.double(), x.double(), x.double())
    wide = torch.ones((1, 2, 50, 72), device=dev)
    with pytest.raises(ValueError, match="head width"):
        tlk.causal_product(wide, wide, wide)
    with pytest.raises(ValueError, match="unit stride"):
        y = torch.ones((1, 2, 64, 50), device=dev).transpose(2, 3)
        tlk.causal_product(y, y, y)
    with pytest.raises(ValueError, match="as wide"):
        tlk.causal_product(x, x, x[..., :32])


def _rl_setup(dev):
    """A small agent (two layers, d_model 64, heads of 32) and three songs."""
    cfg = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=64,
                                     n_layer=2, n_head=2, d_inner=128, dropout=0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    songs = [torch.stack([torch.randint(0, v, (160,), generator=gen, device=dev) for v in VOCAB],
                         -1).to(torch.int32) for _ in range(3)]
    masks = [(torch.rand(160, generator=gen, device=dev) > 0.1).float() for _ in range(3)]
    return cfg, gen, songs, masks


@pytest.mark.gpu
@pytest.mark.parametrize("attn", ["xla", "pallas"])
def test_graphed_dqn_rollout_equals_the_eager_loop(dev, attn, monkeypatch):
    """dqn_rollout_song on CUDA replays one graph an episode: its
    transitions equal the eager loop's bit for bit on both attention routes,
    and after an in-place Adam step the replay sees the new weights."""
    from reinforcement_learning_in_music_generation_torch.rl import dqn as tdqn
    from reinforcement_learning_in_music_generation_torch.rl import env as tenv
    from reinforcement_learning_in_music_generation_torch.rl import episode_graph as teg
    monkeypatch.setenv("RLMG_ATTN_BACKEND", attn)
    cfg, _, songs, masks = _rl_setup(dev)
    qcfg = TC.DQNConfig(lr=1e-3, n_states=20, n_actions=10, episodes=6)
    st = tdqn.init_state(cfg, qcfg, tlt.init_params(cfg, seed=5, device=dev))
    kw = dict(episodes=6, n_states=20, n_actions=10)

    def both(i):
        g = tenv.dqn_rollout_song(st.eval_params, cfg, songs[i], songs[i], masks[i], **kw)
        e = tenv.dqn_rollout_song(st.eval_params, cfg, songs[i], songs[i], masks[i],
                                  graph=False, **kw)
        for ours, ref in zip(g, e):
            for k in ref:
                assert torch.equal(ours[k], ref[k]), k
        return g[0]

    c0 = teg.EpisodeLoop.captures
    for i in range(3):
        agent = both(i)
    assert teg.EpisodeLoop.captures == c0 + 1          # one capture serves every song
    batch = {k: agent[k] for k in ("state", "action", "reward", "next_state", "done")}
    ebatch = {"state": agent["state"], "next_state": agent["next_state"],
              "mask_next_state": torch.ones(agent["state"].shape[:2], device=dev)}
    wq = st.eval_params["layers"]["wq"]["w"]
    w0, ptr = wq.clone(), wq.data_ptr()
    st, _ = tdqn.update(st, cfg, qcfg, tdqn.make_optimizer(qcfg), batch, ebatch, None)
    assert not torch.equal(wq, w0) and wq.data_ptr() == ptr    # updated in place
    both(2)                                            # the replay against the new weights
    assert teg.EpisodeLoop.captures == c0 + 1          # the same storage: replayed


@pytest.mark.gpu
@pytest.mark.parametrize("ffn", ["xla", "pallas"])
def test_graphed_ppo_rollout_equals_the_eager_loop(dev, ffn, monkeypatch):
    """ppo.rollout_song on CUDA replays one graph an episode: states and
    actions equal the eager loop's bit for bit, log-probs, values and
    rewards within 1e-6 of their magnitude, on both FFN routes, also after
    an in-place update step of the actor and the critic."""
    from reinforcement_learning_in_music_generation_torch.rl import ppo as tppo
    monkeypatch.setenv("RLMG_FFN_BACKEND", ffn)
    cfg, _, songs, masks = _rl_setup(dev)
    acfg = TC.actor_config(VOCAB, emb_sizes=(16,) * 6, d_model=64, n_layer=2, n_head=2,
                           d_inner=128, dropout=0.0)
    ccfg = TC.critic_config(VOCAB, emb_sizes=(16,) * 6, d_model=64, n_layer=2, n_head=2,
                            d_inner=128, dropout=0.0)
    rcfg = TC.ppo_reward_config(VOCAB, emb_sizes=(16,) * 6, d_model=64, n_layer=1, n_head=2,
                                d_inner=128, attention_window=16, dropout=0.0)
    pcfg = TC.PPOConfig(lr=1e-3, n_states=20, n_actions=10, episodes=5)
    st = tppo.init_state(acfg, ccfg, rcfg, pcfg, seed=3, device=dev)
    txs = tppo.make_optimizers(pcfg)
    kw = dict(episodes=5, n_states=20, n_actions=10)

    def both(i):
        g, _ = tppo.rollout_song(st, (acfg, ccfg, rcfg), songs[i], songs[i], masks[i], **kw)
        e, _ = tppo.rollout_song(st, (acfg, ccfg, rcfg), songs[i], songs[i], masks[i],
                                 graph=False, **kw)
        for k in ("state", "action", "next_state"):
            assert torch.equal(g[k], e[k]), k
        for k in ("log_action", "value", "reward"):
            _close(g[k], e[k], 1e-6, k)
        return e

    for i in range(3):
        agent = both(i)
    ret = tppo.calculate_returns(agent["reward"][:, 0], pcfg.discount)
    adv = tppo.calculate_advantages(ret, agent["value"])
    expert = {"state": agent["state"], "mask_state": torch.ones(agent["state"].shape[:2],
                                                                device=dev)}
    st, _ = tppo.update_policy_step(st, (acfg, ccfg, rcfg), pcfg, txs, agent, expert, adv, ret)
    both(1)


@pytest.mark.gpu
def test_rollout_graph_goes_with_its_weights(dev):
    """The cached episode graph holds none of the weights: once they are
    dropped its entry and its memory go."""
    import gc

    from reinforcement_learning_in_music_generation_torch.rl import env as tenv
    from reinforcement_learning_in_music_generation_torch.rl import episode_graph as teg
    cfg, _, songs, masks = _rl_setup(dev)
    kw = dict(episodes=4, n_states=20, n_actions=10)
    p = tlt.init_params(cfg, seed=6, device=dev)
    tenv.dqn_rollout_song(p, cfg, songs[0], songs[0], masks[0], **kw)
    del p
    gc.collect()
    torch.cuda.synchronize()
    base, keys = torch.cuda.memory_allocated(), set(teg._LOOPS)
    p = tlt.init_params(cfg, seed=7, device=dev)
    with_params = torch.cuda.memory_allocated()
    tenv.dqn_rollout_song(p, cfg, songs[0], songs[0], masks[0], **kw)
    assert len(set(teg._LOOPS) - keys) == 1
    del p
    gc.collect()
    torch.cuda.synchronize()
    assert set(teg._LOOPS) <= keys
    assert torch.cuda.memory_allocated() <= base + (with_params - base) // 100 + (1 << 16)


@pytest.mark.gpu
def test_causal_product_counts_its_replayed_runs(dev, monkeypatch):
    """Under RLMG_ATTN_BACKEND=pallas kernel F counts its own runs: captured
    calls x replays + eager calls; the wrapper counts only the eager calls
    (the capture records, and a replay does not reach the host)."""
    from reinforcement_learning_in_music_generation_torch.ops import (
        linear_attention_kernel as tlk)
    from reinforcement_learning_in_music_generation_torch.rl import env as tenv
    monkeypatch.setenv("RLMG_ATTN_BACKEND", "pallas")
    cfg, _, songs, masks = _rl_setup(dev)
    kw = dict(episodes=5, n_states=20, n_actions=10)
    p = tlt.init_params(cfg, seed=8, device=dev)
    tlk.kernel_runs(reset=True)
    f0 = tlk.causal_product.launches_fwd
    for i in range(2):            # song 0: one eager episode, a capture, 4 replays; song 1: 5
        tenv.dqn_rollout_song(p, cfg, songs[i], songs[i], masks[i], **kw)
    tenv.dqn_rollout_song(p, cfg, songs[2], songs[2], masks[2], graph=False, **kw)   # eager
    captured = eager = cfg.n_layer                     # F calls an episode
    want = captured * (4 + 5) + eager * (1 + 5)
    assert tlk.kernel_runs() == (want, 0)
    assert tlk.causal_product.launches_fwd - f0 == eager * (1 + 5)


def _ffn_inputs(dev, n, d, di, seed=8):
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rnd = lambda *shape, sc=1.0: torch.randn(shape, generator=gen, device=dev) * sc
    inputs = (rnd(n, d), rnd(d, di, sc=0.2), rnd(di, sc=0.1), rnd(di, d, sc=0.1),
              rnd(d, sc=0.1), 1 + rnd(d, sc=0.1), rnd(d, sc=0.1))
    return inputs, rnd(n, d)


# rows: one rollout state (50) and ragged counts (100, 300) for the 128-row tiles
@pytest.mark.gpu
@pytest.mark.parametrize("n", [50, 100, 300])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_ffn_block_kernel_matches_plain(dev, n, p):
    inputs, g = _ffn_inputs(dev, n, 64, 256)
    seed = torch.tensor(31337, dtype=torch.int32, device=dev)
    before = (tfb.ffn_block.launches_fwd, tfb.ffn_block.launches_bwd)
    ok, gk = _fwd_bwd(lambda *a: tfb.ffn_block(*a, seed, p), inputs, g)
    op, gp = _fwd_bwd(lambda *a: tfb.ffn_block_plain(*a, seed, p), inputs, g)
    assert (tfb.ffn_block.launches_fwd, tfb.ffn_block.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    _close(ok, op, 1e-4, "out")
    for name, x, y in zip(("dh", "dw1", "db1", "dw2", "db2", "dln_s", "dln_b"), gk, gp):
        assert torch.isfinite(x).all(), name
        _close(x, y, 1e-3, name)


@pytest.mark.gpu
def test_ffn_block_kernel_is_deterministic(dev):
    """No atomics: two backward launches give bit-equal gradients."""
    (h, *ws), dout = _ffn_inputs(dev, 1000, 64, 128, seed=9)
    seed = torch.tensor(9, dtype=torch.int32, device=dev)
    g1 = tfb.ffn_backward_kernel(h, ws, dout, seed, 0.1)
    g2 = tfb.ffn_backward_kernel(h, ws, dout, seed, 0.1)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 50, 100, 1500])
@pytest.mark.parametrize("p", [0.0, 0.1])
def test_ffn_block_kernel_matches_plain_bf16(dev, n, p):
    inputs, g = _ffn_inputs(dev, n, 64, 256)
    inputs, g = tuple(t.bfloat16() for t in inputs), g.bfloat16()
    seed = torch.tensor(31337, dtype=torch.int32, device=dev)
    before = (tfb.ffn_block.launches_fwd, tfb.ffn_block.launches_bwd)
    ok, gk = _fwd_bwd(lambda *a: tfb.ffn_block(*a, seed, p), inputs, g)
    op, gp = _fwd_bwd(lambda *a: tfb.ffn_block_plain(*a, seed, p), inputs, g)
    assert (tfb.ffn_block.launches_fwd, tfb.ffn_block.launches_bwd) == \
        (before[0] + 1, before[1] + 1)
    assert ok.dtype == torch.bfloat16 and all(x.dtype == torch.bfloat16 for x in gk)
    _close(ok, op, BF16_TOL, "out")
    for name, x, y in zip(FFN_GRADS, gk, gp):
        assert torch.isfinite(x).all(), name
        _close(x, y, BF16_TOL, name)


@pytest.mark.gpu
def test_ffn_block_kernel_is_deterministic_in_bf16(dev):
    (h, *ws), dout = _ffn_inputs(dev, 1000, 64, 128, seed=9)
    h, ws, dout = h.bfloat16(), [w.bfloat16() for w in ws], dout.bfloat16()
    seed = torch.tensor(9, dtype=torch.int32, device=dev)
    g1 = tfb.ffn_backward_kernel(h, ws, dout, seed, 0.1)
    g2 = tfb.ffn_backward_kernel(h, ws, dout, seed, 0.1)
    assert all(torch.equal(x, y) for x, y in zip(g1, g2))


@pytest.mark.gpu
def test_ffn_block_wrapper_rejects_what_the_kernel_does_not_take(dev):
    (h, *ws), _ = _ffn_inputs(dev, 40, 32, 64)
    with pytest.raises(TypeError, match="like the input"):     # one dtype for every tensor
        tfb.ffn_block(h.bfloat16(), *ws, 0, 0.0)
    (hw, *wide), _ = _ffn_inputs(dev, 8, 1028, 64)
    with pytest.raises(ValueError, match="d_model"):
        tfb.ffn_block(hw, *wide, 0, 0.0)
    with pytest.raises(ValueError, match="contiguous"):
        tfb.ffn_block(h, ws[0].T.contiguous().T, *ws[1:], 0, 0.0)
    with pytest.raises(ValueError, match="shape"):
        tfb.ffn_block(h, ws[0], ws[1][:32].contiguous(), *ws[2:], 0, 0.0)


# -- the latency kernels (csrc/latency_decode.cu): v8 one launch per chunk, v7
# L + 2 launches a token; the plain twin is latency_decode_plain (JAX v8's
# rounding of the product inputs and the embedding rows to the weights' type)

LATENCY = {7: tdk7.fused_decode_v7, 8: tdk8.fused_decode_v8}


def _latency_setup(dev, wdt, b):
    cfg, params, gen = _setup(dev, 128, 2, wdt)       # d_model 128, heads of 64, FFN 256
    rp = tdk8.make_resident_params(params, cfg)
    return cfg, rp, gen, [_tokens(gen, dev, b) for _ in range(8)]


@pytest.mark.gpu
@pytest.mark.parametrize("version", [7, 8])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 5, 16])
def test_latency_kernel_matches_plain(dev, version, wdt, b):
    """Teacher-forced, one token a call, f32 state: with f32 weights the
    state within 1e-4 (rtol) / 1e-3 (atol) of the plain twin's (summation
    order only); with bf16 weights, where both round the same product
    inputs to bf16 and an input the two sums leave near a rounding boundary
    can round either way, S within 1e-4 of max|S| (kernel B's gate for the
    same arithmetic, test_decode_chunk_tc_matches_its_twin); the greedy and
    the sampled tokens (same Philox bits) equal but at near-ties.  A
    control shows that gate rejects other arithmetic: v4's (f32 product
    inputs and embedding rows) fed the same tokens ends above it.  Each
    call issues one CUDA launch (v8) or L + 2 (v7)."""
    cfg, rp, gen, toks = _latency_setup(dev, wdt, b)
    fn = LATENCY[version]
    per_call = 1 if version == 8 else cfg.n_layer + 2
    for greedy, temps, topps in ((True, (1.0,) * 6, (float("inf"),) * 6),
                                 (False, CP_TEMPS, CP_TOPPS)):
        kw = dict(n_head=2, max_tokens=1, temps=temps, topps=topps, greedy=greedy,
                  eps=cfg.attn_eps)
        sk = tdk4.init_state(cfg, b, torch.float32, dev)
        sp = tdk4.init_state(cfg, b, torch.float32, dev)
        sc = tdk4.init_state(cfg, b, torch.float32, dev)
        before, cuda_before, agree = fn.launches, fn.cuda_launches, 0
        for t, tok in enumerate(toks):
            ok, _, _ = fn(rp, tok, sk.s, sk.z, t, 3, vocab_sizes=VOCAB, **kw)
            op, _, _ = tdk8.latency_decode_plain(rp, tok, sp.s, sp.z, t, 3, **kw)
            tdk6._chunk_plain(rp, tok, sc.s, sc.z, t, 3, round_to=None, **kw)
            agree += int((ok == op).sum())
        assert fn.launches == before + len(toks)
        assert fn.cuda_launches == cuda_before + per_call * len(toks)
        assert agree / (len(toks) * b * 6) >= 0.97
        if wdt == torch.float32:
            torch.testing.assert_close(sk.s, sp.s, rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(sk.z, sp.z, rtol=1e-4, atol=1e-4)
        else:
            _close(sk.s, sp.s, 1e-4, f"S at B={b}")
            _close(sk.z, sp.z, 1e-4, f"z at B={b}")
            ctl = _share(sk.s, sc.s)
            print(f"[gate] v{version} B={b} greedy={greedy}: max|dS| / max|S| against the "
                  f"twin {_share(sk.s, sp.s):.3e}, against v4's arithmetic {ctl:.3e}")
            assert ctl > 1e-4, f"the 1e-4 gate would pass v4's arithmetic ({ctl})"


@pytest.mark.gpu
@pytest.mark.parametrize("sdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("greedy", [True, False])
def test_latency_v7_equals_v8_and_is_chunk_invariant(dev, sdt, greedy):
    """v7 and v8 run the same device functions in the same order: tokens and
    states bit-equal; 16 tokens in one v8 call equal 8 + 8."""
    b = 5
    cfg, rp, gen, toks = _latency_setup(dev, torch.bfloat16, b)
    kw = dict(n_head=2, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS, greedy=greedy,
              eps=cfg.attn_eps)
    st = {v: tdk4.init_state(cfg, b, sdt, dev) for v in (7, 8, 0)}
    out = {v: LATENCY[v](rp, toks[0], st[v].s, st[v].z, 2, 11, max_tokens=16, **kw)[0]
           for v in (7, 8)}
    first, _, _ = tdk8.fused_decode_v8(rp, toks[0], st[0].s, st[0].z, 2, 11, max_tokens=8,
                                      **kw)
    rest, _, _ = tdk8.fused_decode_v8(rp, first[-1].contiguous(), st[0].s, st[0].z, 10, 11,
                                     max_tokens=8, **kw)
    assert torch.equal(out[7], out[8])
    assert torch.equal(st[7].s, st[8].s) and torch.equal(st[7].z, st[8].z)
    assert torch.equal(out[8], torch.cat([first, rest]))
    assert torch.equal(st[8].s, st[0].s) and torch.equal(st[8].z, st[0].z)
    assert (out[8] >= 0).all() and (out[8] < torch.tensor(VOCAB, device=dev)).all()


@pytest.mark.gpu
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_latency_v8_repeated_calls_are_bit_equal(dev, wdt):
    """Fixed summation orders, no atomics in any sum: two identical v8 calls
    (16 tokens, CP sampling, f32 state) give the same tokens and states,
    bit for bit."""
    b = 5
    cfg, rp, gen, toks = _latency_setup(dev, wdt, b)
    kw = dict(n_head=2, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS, eps=cfg.attn_eps)
    outs = []
    for _ in range(2):
        st = tdk4.init_state(cfg, b, torch.float32, dev)
        tok, _, _ = tdk8.fused_decode_v8(rp, toks[0], st.s, st.z, 4, 21, max_tokens=16, **kw)
        outs.append((tok, st.s, st.z))
    assert all(torch.equal(x, y) for x, y in zip(*outs))


@pytest.mark.gpu
def test_latency_v7_one_graph_serves_every_call(dev):
    """v7 keeps one token graph a shape: four calls of one shape with new
    seeds, positions and states instantiate it at most once and update it
    in place otherwise (``captures`` / ``updates``), and each call's tokens
    and state equal v8's."""
    b = 5
    cfg, rp, gen, toks = _latency_setup(dev, torch.bfloat16, b)
    kw = dict(n_head=2, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS, eps=cfg.attn_eps)
    fn = tdk7.fused_decode_v7
    tdk8.reset(fn)
    for i in range(4):
        st = {v: tdk4.init_state(cfg, b, torch.float32, dev) for v in (7, 8)}
        out = {v: LATENCY[v](rp, toks[i], st[v].s, st[v].z, i, 30 + i, max_tokens=4, **kw)[0]
               for v in (7, 8)}
        assert torch.equal(out[7], out[8]) and torch.equal(st[7].s, st[8].s)
    assert fn.launches == 4 and fn.captures <= 1 and fn.captures + fn.updates == 4


@pytest.mark.gpu
def test_latency_wrappers_reject_what_the_kernels_do_not_take(dev):
    cfg, rp, gen, _ = _latency_setup(dev, torch.float32, 1)
    kw = dict(n_head=2, max_tokens=1, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS)
    big = tdk8.MAX_BATCH + 1
    st = tdk4.init_state(cfg, big, torch.float32, dev)
    for fn in LATENCY.values():
        with pytest.raises(ValueError, match="batch"):
            fn(rp, _tokens(gen, dev, big), st.s, st.z, 0, 0, **kw)
        with pytest.raises(ValueError, match="tok0"):
            fn(rp, _tokens(gen, dev, big).long(), st.s, st.z, 0, 0, **kw)
        with pytest.raises(ValueError, match="no kernel"):
            fn(rp, _tokens(gen, dev, big).to("meta"), st.s, st.z, 0, 0, **kw)


# -- v3, v1, v2 (csrc/decode_aug.cu) and v5 (csrc/latency_decode.cu) -----------

# (d_model, n_head): 3 heads of 16, one head of 128, 2 heads of 64
AUG_SHAPES = [(48, 3), (128, 1), (128, 2)]


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head", AUG_SHAPES)
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_v3_kernel_matches_plain(dev, d_model, n_head, wdt):
    """Six tokens, f32 augmented state: h within 1e-4 and the state within
    1e-4 (rtol) / 1e-3 (atol) of the plain twin (summation order only); one
    wrapper call a token, one CUDA launch a call (every layer in it)."""
    cfg, params, gen = _setup(dev, d_model, n_head, wdt)
    v3p = tdk3.make_v3_params(params, cfg, dtype=wdt)
    b = 5
    sk, sp = tdk3.init_aug_state(cfg, b, dev), tdk3.init_aug_state(cfg, b, dev)
    before, cuda_before = tdk3.fused_stack_step.launches, tdk3.fused_stack_step.cuda_launches
    for t in range(6):
        h0 = tlt.embed_input(params, cfg, _tokens(gen, dev, b), t, None).float()
        hk, _ = tdk3.fused_stack_step(v3p, h0, sk, n_head=n_head)
        hp, _ = tdk3.fused_stack_step_plain(v3p, h0, sp, n_head=n_head)
        torch.testing.assert_close(hk, hp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-3)
    assert tdk3.fused_stack_step.launches == before + 6
    assert tdk3.fused_stack_step.cuda_launches - cuda_before == 6


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head", AUG_SHAPES)
@pytest.mark.parametrize("variant", ["v1", "v2"])
def test_layer_kernels_match_plain(dev, d_model, n_head, variant):
    """fused_decode_step over 5 tokens, f32: h and the state as for v3; one
    wrapper call a layer."""
    cfg, params, gen = _setup(dev, d_model, n_head, torch.float32)
    fn = tdk.fused_layer_step if variant == "v1" else tdk.fused_layer_step_v2
    plain = tdk.fused_layer_step_plain if variant == "v1" else tdk.fused_layer_step_v2_plain
    b = 4
    sk = tlt.DecodeState(tdk.aug_state_init(cfg, b, dev), None, 0)
    sp = tdk.aug_state_init(cfg, b, dev)
    before = fn.launches
    for t in range(5):
        tok = _tokens(gen, dev, b)
        hk, sk = tdk.fused_decode_step(params, cfg, tok, sk, variant=variant)
        hp = tlt.embed_input(params, cfg, tok, t, None)
        for li in range(cfg.n_layer):
            lp = {k: {kk: vv[li] for kk, vv in v.items()} for k, v in params["layers"].items()}
            hp, _ = plain(hp, lp, sp[li], n_head=n_head, eps=cfg.attn_eps)
        hp = tcm.layernorm(params["final_ln"], hp)
        torch.testing.assert_close(hk, hp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sk.s, sp, rtol=1e-4, atol=1e-3)
    assert fn.launches == before + 5 * cfg.n_layer


def _gate_excess(a, b, rtol, atol):
    """max |a - b| / (atol + rtol |b|): at most 1 where assert_close(a, b,
    rtol, atol) passes."""
    a, b = a.float(), b.float()
    return ((a - b).abs() / (atol + rtol * b.abs())).max().item()


def _bf16_layers(params):
    """params with the layer leaves in bf16 and the rest (embedding,
    in_linear, final LN) f32: bf16 weights under f32 activations, so the
    layers' h stays f32 (with every leaf bf16, h itself would be bf16)."""
    return dict(params, layers={k: {kk: vv.to(torch.bfloat16) for kk, vv in v.items()}
                                for k, v in params["layers"].items()})


def _layer_run(params, cfg, toks, step):
    """fused_decode_step's loop over toks with ``step(h, layer, s, li)`` as
    each layer: (the last token's h after the final LN, the state)."""
    b = toks.shape[1]
    s = tdk.aug_state_init(cfg, b, toks.device)
    for t in range(toks.shape[0]):
        h = tlt.embed_input(params, cfg, toks[t], t, None)
        for li in range(cfg.n_layer):
            lp = {k: {kk: vv[li] for kk, vv in v.items()} for k, v in params["layers"].items()}
            h = step(h, lp, s[li], li)
        h = tcm.layernorm(params["final_ln"], h)
    return h, s


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head", AUG_SHAPES)
def test_v2_kernel_matches_plain_with_bf16_weights(dev, d_model, n_head):
    """v2 on bf16 weights (JAX casts them up to f32: the token kernel's three
    products of the f32 activation planes): h and the state against the
    plain twin on the same bf16 weights, test_layer_kernels_match_plain's
    gates."""
    cfg, params, gen = _setup(dev, d_model, n_head, torch.float32)
    params = _bf16_layers(params)
    toks = torch.stack([_tokens(gen, dev, 4) for _ in range(5)])
    kw = dict(n_head=n_head, eps=cfg.attn_eps)
    hk, sk = _layer_run(params, cfg, toks,
                        lambda h, lp, s, li: tdk.fused_layer_step_v2(h, lp, s, **kw)[0])
    hp, sp = _layer_run(params, cfg, toks,
                        lambda h, lp, s, li: tdk.fused_layer_step_v2_plain(h, lp, s, **kw)[0])
    torch.testing.assert_close(hk.float(), hp.float(), rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("d_model,n_head", AUG_SHAPES)
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_v2_gate_sees_the_exact_gelu(dev, d_model, n_head, wdt, capsys):
    """A control for test_layer_kernels_match_plain's h gate (rtol 1e-4,
    atol 1e-4): the same five tokens with each layer on the exact-erf gelu
    (v3's token kernel on the layer, its one difference from v2) end
    above the gate against v2's twin, while v2's kernel stays within it.
    Prints both as multiples of the gate (1 = at the gate)."""
    cfg, params, gen = _setup(dev, d_model, n_head, torch.float32)
    if wdt == torch.bfloat16:
        params = _bf16_layers(params)
    toks = torch.stack([_tokens(gen, dev, 4) for _ in range(5)])
    v3p = tdk3.make_v3_params(params, cfg, dtype=wdt)
    kw = dict(n_head=n_head, eps=cfg.attn_eps)

    def exact(h, lp, s, li):
        one = {k: v[li:li + 1] for k, v in v3p.items()}
        return tdk3.fused_stack_step(one, h.float().contiguous(), s[None], **kw)[0].clone()
    hp, _ = _layer_run(params, cfg, toks,
                       lambda h, lp, s, li: tdk.fused_layer_step_v2_plain(h, lp, s, **kw)[0])
    hk, _ = _layer_run(params, cfg, toks,
                       lambda h, lp, s, li: tdk.fused_layer_step_v2(h, lp, s, **kw)[0])
    hc, _ = _layer_run(params, cfg, toks, exact)
    kern, ctl = _gate_excess(hk, hp, 1e-4, 1e-4), _gate_excess(hc, hp, 1e-4, 1e-4)
    with capsys.disabled():
        print(f"[gate] v2 d_model {d_model}, {n_head} head(s), {str(wdt)[6:]} weights: h "
              f"against the twin at {kern:.3g} of the gate, the exact-gelu control at "
              f"{ctl:.3g}")
    assert kern <= 1.0
    assert ctl > 1.0, f"the h gate does not see the exact gelu ({ctl:.3g} of it)"


@pytest.mark.gpu
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_v2_packing_kernel_equals_its_plain_version(dev, wdt):
    """rlmg_v2_pack's operands, bit for bit, are v2_pack_plain's: the
    head-major matrices in pack_fragments order in the kernel's type and the
    f32 vectors; the row-tile counters zero."""
    cfg, params, _ = _setup(dev, 48, 3, wdt)
    lp = {k: {kk: vv[1] for kk, vv in v.items()} for k, v in params["layers"].items()}
    work = tdk._v2_pack(tdk.v2_leaves(lp), 3, 20, lp["wq"]["w"].device)
    mats, vecs = tdk.v2_pack_plain(lp, 3)
    for got, want in zip(work.mats + work.vecs, mats + vecs):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert work.cnt.numel() == 2 and not work.cnt.any()


@pytest.mark.gpu
def test_v2_issues_one_launch_a_call_once_packed(dev):
    """The first call on a layer packs it (two CUDA launches), the next
    ones find it packed (one launch, as a profile of the call counts the
    kernels), an in-place update of a leaf repacks, and a new batch too."""
    cfg, params, gen = _setup(dev, 128, 2, torch.float32)
    lp = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params["layers"].items()}
    fn = tdk.fused_layer_step_v2
    h = tlt.embed_input(params, cfg, _tokens(gen, dev, 8), 0, None).float().contiguous()
    s = tdk.aug_state_init(cfg, 8, dev)[0]

    def call():
        c0, p0 = fn.cuda_launches, fn.packs
        fn(h, lp, s, n_head=2)
        torch.cuda.synchronize()
        return fn.cuda_launches - c0, fn.packs - p0
    tdk._V2_CACHE.clear()
    assert call() == (2, 1)
    assert call() == (1, 0)
    lp2 = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params["layers"].items()}
    c0 = fn.cuda_launches
    fn(h, lp2, s, n_head=2)            # the same leaves indexed afresh: still packed
    assert fn.cuda_launches - c0 == 1
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        assert call() == (1, 0)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(kernels) == 1, [e.name for e in kernels]
    with torch.no_grad():
        params["layers"]["ffn1"]["w"].mul_(1.0)
    assert call() == (2, 1)
    assert call() == (1, 0)
    s4 = tdk.aug_state_init(cfg, 4, dev)[0]
    c0, p0 = fn.cuda_launches, fn.packs
    fn(h[:4].contiguous(), lp, s4, n_head=2)
    assert (fn.cuda_launches - c0, fn.packs - p0) == (2, 1)


@pytest.mark.gpu
def test_v2_wrapper_rejects_what_the_kernel_does_not_take(dev):
    """v2 raises for a state of the wrong shape or type, leaves on another
    device than h, and a device with no kernel."""
    cfg, params, gen = _setup(dev, 48, 3, torch.float32)
    lp = {k: {kk: vv[0] for kk, vv in v.items()} for k, v in params["layers"].items()}
    h = tlt.embed_input(params, cfg, _tokens(gen, dev, 4), 0, None).float()
    s = tdk.aug_state_init(cfg, 4, dev)[0]
    with pytest.raises(ValueError, match="state"):
        tdk.fused_layer_step_v2(h, lp, s.double(), n_head=3)
    with pytest.raises(ValueError, match="state"):
        tdk.fused_layer_step_v2(h, lp, s[:, :2].contiguous(), n_head=3)
    cpu = {k: {kk: vv.cpu() for kk, vv in v.items()} for k, v in lp.items()}
    with pytest.raises(ValueError, match="expected a contiguous"):
        tdk.fused_layer_step_v2(h, cpu, s, n_head=3)
    with pytest.raises(ValueError, match="no kernel"):
        tdk.fused_layer_step_v2(h.to("meta"), lp, s, n_head=3)


@pytest.mark.gpu
def test_a_and_v3_keep_the_exact_gelu(dev, monkeypatch):
    """The gelu switch of the shared token kernel leaves A and v3 on
    gelu_exact: at one shape each their h is within the 1e-4 gate (rtol,
    atol) of their exact-gelu twins', at least ten times nearer to it than
    to the same twins' with the tanh gelu, which end above the gate."""
    from reinforcement_learning_in_music_generation_torch.ops import decode_common as tdc
    b = 5
    cfg, params, gen = _setup(dev, 128, 2, torch.float32)
    h0 = tlt.embed_input(params, cfg, _tokens(gen, dev, b), 0, None).float()
    dparams = tlt.make_decode_params(params, cfg)
    st = [tdk4.init_state(cfg, b, torch.float32, dev) for _ in range(3)]
    ha = tdk4.fused_stack_step(dparams, h0, st[0].s, st[0].z, n_head=2)[0].clone()
    hp = tdk4.fused_stack_step_plain(dparams, h0, st[1].s, st[1].z, n_head=2)[0]
    monkeypatch.setattr(tdk4, "gelu_exact", tdc.gelu_tanh)
    ht = tdk4.fused_stack_step_plain(dparams, h0, st[2].s, st[2].z, n_head=2)[0]
    monkeypatch.undo()
    assert _gate_excess(ha, hp, 1e-4, 1e-4) <= 1.0 < _gate_excess(ht, hp, 1e-4, 1e-4)
    assert 10 * _share(ha, hp) < _share(ha, ht)
    cfg3, params3, gen3 = _setup(dev, 48, 3, torch.float32)
    v3p = tdk3.make_v3_params(params3, cfg3, dtype=torch.float32)
    h3 = tlt.embed_input(params3, cfg3, _tokens(gen3, dev, b), 0, None).float()
    s3 = [tdk3.init_aug_state(cfg3, b, dev) for _ in range(3)]
    hk = tdk3.fused_stack_step(v3p, h3, s3[0], n_head=3)[0].clone()
    hp3 = tdk3.fused_stack_step_plain(v3p, h3, s3[1], n_head=3)[0]
    monkeypatch.setattr(tdk3, "gelu_exact", tdc.gelu_tanh)
    ht3 = tdk3.fused_stack_step_plain(v3p, h3, s3[2], n_head=3)[0]
    assert _gate_excess(hk, hp3, 1e-4, 1e-4) <= 1.0 < _gate_excess(ht3, hp3, 1e-4, 1e-4)
    assert 10 * _share(hk, hp3) < _share(hk, ht3)


@pytest.mark.gpu
def test_aug_wrappers_reject_what_the_kernel_does_not_take(dev):
    cfg, params, gen = _setup(dev, 48, 3, torch.float32)
    v3p = tdk3.make_v3_params(params, cfg, dtype=torch.float32)
    h0 = torch.zeros((2, 48), device=dev)
    s = tdk3.init_aug_state(cfg, 2, dev)
    with pytest.raises(ValueError, match="state"):
        tdk3.fused_stack_step(v3p, h0, s.to(torch.bfloat16), n_head=3)
    with pytest.raises(ValueError, match="state"):
        tdk3.fused_stack_step(v3p, h0, s[:, :, :1].contiguous(), n_head=3)
    with pytest.raises(TypeError, match="h0"):
        tdk3.fused_stack_step(v3p, h0.double(), s, n_head=3)
    with pytest.raises(ValueError, match="qkvb"):
        tdk3.fused_stack_step(dict(v3p, qkvb=v3p["qkvb"].to(torch.bfloat16)), h0, s, n_head=3)
    with pytest.raises(ValueError, match="no kernel"):
        tdk3.fused_stack_step(v3p, h0.to("meta"), s, n_head=3)


def _v5_setup(dev, b):
    cfg, params, gen = _setup(dev, 128, 2, torch.bfloat16)
    v5p = tdk5.make_v5_params(params, cfg)
    pe = tcm.sinusoidal_table(cfg.max_len, cfg.d_model, torch.float32, dev)
    return cfg, v5p, gen, pe


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 32])
def test_v5_kernel_matches_plain(dev, b):
    """bf16 weights, f32 state, bb 8: teacher-forced one-token calls from the
    twin's state agree on the greedy and the sampled tokens but at
    near-ties; after the same 8 fed tokens S and z agree within 1e-4 of
    their magnitude (kernel and twin round the same product inputs to bf16,
    JAX v5's arithmetic; an input near a rounding boundary can round either
    way, so kernel B's gate for that arithmetic).  A control, v4's
    arithmetic (f32 product inputs) fed the same tokens, ends above that
    gate.  One launch a call."""
    cfg, v5p, gen, pe = _v5_setup(dev, b)
    for greedy, temps, topps in ((True, (1.0,) * 6, (float("inf"),) * 6),
                                 (False, CP_TEMPS, CP_TOPPS)):
        kw = dict(n_head=2, max_tokens=1, temps=temps, topps=topps, greedy=greedy,
                  eps=cfg.attn_eps)
        st = tlt.init_decode_state(cfg, b, device=dev)
        sk, zk = tdk5.pack_state(st.s, st.z)
        sp, zp = tdk5.pack_state(st.s, st.z)
        sc, zc = st.s.clone(), st.z.clone()
        before, agree = tdk5.fused_decode_v5.launches, 0
        for t in range(8):
            tok = _tokens(gen, dev, b)
            ok, _, _ = tdk5.fused_decode_v5(v5p, tok, sk, zk, pe[t:t + 1], 3 + t, bb=8,
                                            vocab_sizes=VOCAB, **kw)
            op, _, _ = tdk5.fused_decode_v5_plain(v5p, tok, sp, zp, pe[t:t + 1], 3 + t, **kw)
            _, sc, zc = tdk6._chunk_plain(v5p._replace(pe=pe[t:t + 1]), tok, sc, zc, 0, 3 + t,
                                          round_to=None, **kw)
            agree += int((ok == op).sum())
        assert tdk5.fused_decode_v5.launches == before + 8
        assert agree / (8 * b * 6) >= 0.97
        _close(sk, sp, 1e-4, f"S at B={b}")
        _close(zk, zp, 1e-4, f"z at B={b}")
        ctl = _share(sk, tdk5.pack_state(sc, zc)[0])
        print(f"[gate] v5 B={b} greedy={greedy}: max|dS| / max|S| against the twin "
              f"{_share(sk, sp):.3e}, against v4's arithmetic {ctl:.3e}")
        assert ctl > 1e-4, f"the 1e-4 gate would pass v4's arithmetic ({ctl})"


@pytest.mark.gpu
@pytest.mark.parametrize("b", [8, 32])
def test_v5_kernel_matches_plain_with_f32_weights(dev, b):
    """f32 weights (the kernel's products at f32 grade: both operands as
    three bf16 planes, the weights' planes from make_v5_params): as the bf16
    case, teacher-forced one-token calls agree with the twin (v4's
    arithmetic, every rounding a no-op) on >= 97% of the tokens, and after 8
    fed tokens S and z lie within 1e-4 of their magnitude."""
    cfg, params, gen = _setup(dev, 128, 2, torch.float32)
    v5p = tdk5.make_v5_params(params, cfg, dtype=torch.float32)
    assert v5p.planes is not None
    pe = tcm.sinusoidal_table(cfg.max_len, cfg.d_model, torch.float32, dev)
    for greedy, temps, topps in ((True, (1.0,) * 6, (float("inf"),) * 6),
                                 (False, CP_TEMPS, CP_TOPPS)):
        kw = dict(n_head=2, max_tokens=1, temps=temps, topps=topps, greedy=greedy,
                  eps=cfg.attn_eps)
        st = tlt.init_decode_state(cfg, b, device=dev)
        sk, zk = tdk5.pack_state(st.s, st.z)
        sp, zp = tdk5.pack_state(st.s, st.z)
        agree = 0
        for t in range(8):
            tok = _tokens(gen, dev, b)
            s_tf, z_tf = sp.clone(), zp.clone()
            ok = tdk5.fused_decode_v5(v5p, tok, s_tf, z_tf, pe[t:t + 1], 3 + t, bb=8,
                                      vocab_sizes=VOCAB, **kw)[0]
            tdk5.fused_decode_v5(v5p, tok, sk, zk, pe[t:t + 1], 3 + t, bb=8, vocab_sizes=VOCAB,
                                 **kw)
            op = tdk5.fused_decode_v5_plain(v5p, tok, sp, zp, pe[t:t + 1], 3 + t, **kw)[0]
            agree += int((ok == op).sum())
        assert agree / (8 * b * 6) >= 0.97
        _close(sk, sp, 1e-4, f"S at B={b}, f32 weights")
        _close(zk, zp, 1e-4, f"z at B={b}, f32 weights")


@pytest.mark.gpu
def test_v5_bb_does_not_change_the_result(dev):
    """A song's sums do not depend on how many songs a product item
    carries: bb 8, 16 and 32 give the same tokens and state, bit for bit."""
    b = 32
    cfg, v5p, gen, pe = _v5_setup(dev, b)
    tok = _tokens(gen, dev, b)
    outs = []
    for bb in (8, 16, 32):
        st = tlt.init_decode_state(cfg, b, device=dev)
        s5, z5 = tdk5.pack_state(st.s, st.z)
        toks, _, _ = tdk5.fused_decode_v5(v5p, tok, s5, z5, pe[:6], 5, n_head=2, max_tokens=6,
                                          bb=bb, vocab_sizes=VOCAB, temps=CP_TEMPS,
                                          topps=CP_TOPPS, eps=cfg.attn_eps)
        outs.append((toks, s5, z5))
    for toks, s5, z5 in outs[1:]:
        assert torch.equal(toks, outs[0][0])
        assert torch.equal(s5, outs[0][1]) and torch.equal(z5, outs[0][2])
    assert (outs[0][0] >= 0).all() and (outs[0][0] < torch.tensor(VOCAB, device=dev)).all()


@pytest.mark.gpu
def test_v5_wrapper_rejects_what_the_kernel_does_not_take(dev):
    b = 8
    cfg, v5p, gen, pe = _v5_setup(dev, b)
    st = tlt.init_decode_state(cfg, b, device=dev)
    s5, z5 = tdk5.pack_state(st.s, st.z)
    kw = dict(n_head=2, max_tokens=1, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS)
    tok = _tokens(gen, dev, b)
    for bb in (16, 12):
        with pytest.raises(ValueError, match="bb="):
            tdk5.fused_decode_v5(v5p, tok, s5, z5, pe, 0, bb=bb, **kw)
    with pytest.raises(ValueError, match="s5"):
        tdk5.fused_decode_v5(v5p, tok, s5.to(torch.bfloat16), z5, pe, 0, bb=8, **kw)
    with pytest.raises(ValueError, match="s5"):
        tdk5.fused_decode_v5(v5p, tok, st.s.contiguous(), z5, pe, 0, bb=8, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        tdk5.fused_decode_v5(v5p, tok.to("meta"), s5, z5, pe, 0, bb=8, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("ablate", ["state", "attn"])
def test_v5_ablations_stream_the_state_through(dev, ablate, monkeypatch):
    """RLMG_V5_ABLATE (time attribution only): the kernel runs, every token
    is a valid id, and the state is streamed through unchanged; an unknown
    value raises."""
    b = 8
    cfg, v5p, gen, pe = _v5_setup(dev, b)
    st = tlt.init_decode_state(cfg, b, device=dev)
    s5, z5 = tdk5.pack_state(st.s, st.z)
    s5.normal_(generator=gen)
    z5.normal_(generator=gen)
    s0, z0 = s5.clone(), z5.clone()
    kw = dict(n_head=2, max_tokens=4, bb=8, vocab_sizes=VOCAB, temps=CP_TEMPS, topps=CP_TOPPS)
    monkeypatch.setenv("RLMG_V5_ABLATE", ablate)
    toks, _, _ = tdk5.fused_decode_v5(v5p, _tokens(gen, dev, b), s5, z5, pe, 0, **kw)
    assert (toks >= 0).all() and (toks < torch.tensor(VOCAB, device=dev)).all()
    assert torch.equal(s5, s0) and torch.equal(z5, z0)
    monkeypatch.setenv("RLMG_V5_ABLATE", "matmul")
    with pytest.raises(ValueError, match="RLMG_V5_ABLATE"):
        tdk5.fused_decode_v5(v5p, _tokens(gen, dev, b), s5, z5, pe, 0, **kw)


def _serve_setup(dev, wdt):
    cfg = TC.LinearTransformerConfig(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=64,
                                     n_layer=2, n_head=2, d_inner=128)
    params = tlt.cast_params(tlt.init_params(cfg, seed=1, device=dev), wdt)
    return cfg, params


def _serve_gen(dev, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
def test_graphed_serve_loop_equals_the_eager_loop(dev, b, wdt):
    """The continuous batcher with one graph replay a step gives the eager
    loop's songs, steps and songs_done on the same generator, and kernel A
    runs once a replay and once an eager call, as the kernel counts them."""
    from reinforcement_learning_in_music_generation_torch.generate import serving as tsrv
    cfg, params = _serve_setup(dev, wdt)
    kw = dict(n_songs=2 * b + 3, bar_cond=3, batch=b, max_tokens_per_song=96)
    eager = tsrv.generate_songs_continuous(params, cfg, _serve_gen(dev, 5), graph=False, **kw)
    graphed = tsrv.generate_songs_continuous(params, cfg, _serve_gen(dev, 5), **kw)
    assert (graphed.steps, graphed.songs_done) == (eager.steps, eager.songs_done)
    assert len(graphed.songs) == len(eager.songs) == 2 * b + 3
    for x, y in zip(graphed.songs, eager.songs):
        assert (x == y).all() and int((x[:, 2] == 1).sum()) == 3
    tdk4.kernel_runs(reset=True)
    eager0, r0 = tdk4.fused_stack_step.launches, tsrv.generate_songs_continuous.graph_replays
    c0 = tsrv.generate_songs_continuous.graph_captures
    tsrv.generate_songs_continuous(params, cfg, _serve_gen(dev, 6), **kw)
    replays = tsrv.generate_songs_continuous.graph_replays - r0
    assert tsrv.generate_songs_continuous.graph_captures == c0       # one capture serves both
    assert tdk4.kernel_runs() == replays + tdk4.fused_stack_step.launches - eager0
    assert tdk4.fused_stack_step.launches - eager0 == 1             # the init token's step


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 8, 64])
def test_refilled_slot_state_is_a_fresh_ones(dev, b):
    """After the loop, each refilled slot's (s, z) rows equal those of its
    current song teacher-forced from a zero state through kernel A in the
    slot's row of a batch of the same size."""
    from reinforcement_learning_in_music_generation_torch.generate import serving as tsrv
    from reinforcement_learning_in_music_generation_torch.ops import sampling as tsmp
    smoke = _smoke()
    cfg, params = _serve_setup(dev, torch.bfloat16)
    record, loop_fn = {}, tsrv._serve_loop

    def recording(*a, **k):
        out = loop_fn(*a, **k)
        record.update(toks=torch.as_tensor(out[0]), fin=torch.as_tensor(out[1]))
        return out
    tsrv._serve_loop = recording
    try:
        tsrv.generate_songs_continuous(params, cfg, _serve_gen(dev, 7), n_songs=3 * b,
                                       bar_cond=2, batch=b, max_tokens_per_song=64)
    finally:
        tsrv._serve_loop = loop_fn
    max_steps = -(-((3 + 1) * 64) // 1024) * 1024
    loop = tsrv._graphed_loop(params, cfg, b, max_steps, tsmp.CP_SAMPLING, 2, 1)
    errs = smoke.refilled_slot_errors(tdk4, tlt, tcm, params, cfg, dev, loop, record["toks"],
                                      record["fin"])
    assert errs and max(e[1] for e in errs) <= 1e-3, errs


@pytest.mark.gpu
def test_dp_step_and_generate_on_two_ranks_of_one_card(dev, monkeypatch):
    """chip_smoke.py phases 34-35 at a small size (d_model 128, 2 layers,
    2 heads, B 4 x S 128 global, C and D from 256 rows): two gloo ranks on
    the one card; the dp step on C + D within the step gates of the
    one-process step and the mean of the ranks' means outside them, the
    ranks' parameters bit-equal, D's masks apart on the two ranks, greedy
    songs on kernel A equal to one process's, stochastic songs not copies
    (``chip_smoke.dp_gate_failures``)."""
    import os
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    spec = {"cfg": dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=128, n_layer=2,
                        n_head=2, d_inner=256, max_len=512),
            "B": 4, "S": 128, "valid_tail": 20, "min_rows": 256, "songs": 4, "max_tokens": 32,
            "bars": 8}
    res = pm.launch(chip_smoke.dp_rank, 2, (spec,), timeout_s=300)
    assert chip_smoke.dp_gate_failures(res, 2, VOCAB) == []


@pytest.mark.gpu
def test_tp_f_route_step_on_two_ranks_of_one_card(dev, monkeypatch):
    """chip_smoke.py phase 36 at a small size (d_model 128, 2 layers, 4
    heads, B 4 x S 128): dp = 1 x tp = 2, two gloo ranks on the one card,
    each on its shards; the step under RLMG_ATTN_BACKEND=pallas ran kernel
    F once a layer forward and backward on each rank's 2 heads, C, D and G
    no time, and is within the step gates of the one-process step on the
    same route, the losses equal on both ranks (``chip_smoke.tp_gate_failures``)."""
    import os
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    spec = {"cfg": dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=128, n_layer=2,
                        n_head=4, d_inner=256, max_len=512),
            "dp": 1, "tp": 2, "B": 4, "S": 128, "valid_tail": 20, "routes": ("f",)}
    res = pm.launch(chip_smoke.tp_rank, 2, (spec,), timeout_s=300)
    assert chip_smoke.tp_gate_failures(res, 2, VOCAB, spec) == []


@pytest.mark.gpu
def test_sp_f_route_on_two_ranks_of_one_card(dev, monkeypatch):
    """chip_smoke.py phase 42 at a small size ((2, 4, 256, 64)): sp = 2, two
    gloo ranks on the one card, each on its half of the sequence through
    causal_linear_attention_sp(backend="pallas"): kernel F called and run
    once forward and once backward on each rank, the gathered output and
    gradients within phase 11's gates of one process's kernel-F call on the
    whole sequence, both controls outside them (``chip_smoke.sp_gate_failures``)."""
    import os
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    spec = {"sp": 2, "shape": (2, 4, 256, 64), "reps": 2}
    res = pm.launch(chip_smoke.sp_rank, 2, (spec,), timeout_s=300)
    assert chip_smoke.sp_gate_failures(res, spec) == []


@pytest.mark.gpu
def test_pp_d_route_step_on_two_ranks_of_one_card(dev, monkeypatch):
    """chip_smoke.py phase 43 at a small size (d_model 128, 2 layers, 4
    heads, B 4 x S 128): dp = 1 x pp = 2, two gloo ranks on the one card,
    each on its layer, under RLMG_FFN_BACKEND=pallas-tail: kernel D's
    wrapper launched once a microbatch forward and backward on each stage,
    the step within the step gates of one process's on the same route, the
    control outside them, the replicated leaves bit-equal on both ranks
    (``chip_smoke.pp_gate_failures``)."""
    import os
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    spec = {"cfg": dict(vocab_sizes=VOCAB, emb_sizes=(16,) * 6, d_model=128, n_layer=2,
                        n_head=4, d_inner=256, max_len=512),
            "n_layer": 2, "dp": 1, "pp": 2, "B": 4, "S": 128, "valid_tail": 20,
            "control": True}
    res = pm.launch(chip_smoke.pp_rank, 2, (spec,), timeout_s=300)
    assert chip_smoke.pp_gate_failures(res, spec) == []


@pytest.mark.gpu
def test_rl_tp_update_on_two_ranks_of_one_card(dev, monkeypatch):
    """chip_smoke.py phase 39 at two layers (the flagship width; the
    discriminator at one): dp = 1 x tp = 2, two gloo ranks on the one card,
    each on its shards, under RLMG_ATTN_BACKEND=pallas
    RLMG_WINDOW_BACKEND=pallas: one DQN update (kernel F on (30, 4, 50, 64),
    3 forwards and 2 backwards a layer), the discriminator step on 4 x 2048
    (kernel E on (4, 4, 2048, 64) forward and backward) and a rollout song
    (F once a layer an episode), each within the loss and gradient gates of
    one process on the same route, the actions equal, the ranks' parameters
    bit-equal (``chip_smoke.rl_gate_failures``)."""
    import os
    monkeypatch.syspath_prepend(os.path.join(os.path.dirname(__file__), ".."))
    import chip_smoke
    from reinforcement_learning_in_music_generation_torch.parallel import mesh as pm
    spec = {"phase": 39, "dp": 1, "tp": 2, "n_layer": 2, "steps": ("dqn", "disc_long", "rollout")}
    res = pm.launch(chip_smoke.rl_rank, 2, (spec,), timeout_s=600)
    assert chip_smoke.rl_gate_failures(res, spec) == []
