"""Autoregressive CP generation: counterpart of the JAX package's
``generate/sampler.py``.

Two decode paths, chosen as in the JAX package:
  * per-step (``generate_tokens``): one ``decode_step`` per token, through
    the ``decode_kernel_v4`` kernel on CUDA (``fused=True``) or the plain
    ``lt.decode_step`` (``fused=False``), then on-device sampling
    (``ops/sampling.py``);
  * chunked (``generate_tokens_persistent``): stochastic batches of
    ``persistent_min_batch()`` songs or more, through the
    ``decode_kernel_v6`` kernel, which samples on the card and emits up to
    128 tokens per call.

Stop conditions (testing-no-type-cp.py:169-174): a token whose bar-beat
field is 'Bar' counts a bar; a song is done when its count reaches
``bar_cond`` (the final Bar token is kept).  Finished songs emit zero
tokens that are marked invalid.  A fixed token budget (``token_count``)
masks the tail instead.

Out of scope in the port (they raise ``NotImplementedError``): the latency
kernels (v7/v8), mesh sharding, and the parallel prompt prefill that the
JAX package runs for non-greedy prompts of RLMG_PREFILL_MIN (16) tokens
or more.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import GenerateConfig, LinearTransformerConfig
from ..models import common as cm
from ..models import linear_transformer as lt
from ..ops import decode_kernel_v4 as dk4
from ..ops import decode_kernel_v6 as dk6
from ..ops import sampling as smp
from ..ops.decode_common import decode_state_dtype


class GenResult(NamedTuple):
    tokens: torch.Tensor   # (B, T, n_fields) int32, including seed tokens
    valid: torch.Tensor    # (B, T) bool
    n_bars: torch.Tensor   # (B,) int32


# Default seed: the '[0,0,1,0,0,0]' bar row (testing-no-type-cp.py:135-137)
CP_SEED = (0, 0, 1, 0, 0, 0)

# Decode steps between the host's checks of the bar-count stop.  Each check
# waits for the card; the steps run past the stop are masked, so the check
# interval changes the time taken, never the tokens.
STOP_CHECK_EVERY = 16


def use_fused_decode(device) -> bool:
    """The per-step kernel runs on CUDA devices; RLMG_FUSED_DECODE=0/1
    overrides."""
    env = os.environ.get("RLMG_FUSED_DECODE")
    if env is not None:
        return env == "1"
    return torch.device(device).type == "cuda"


def use_fused_sampling() -> bool:
    """One padded sort-free chain for all six fields
    (``sampling.sample_fields_fused``); RLMG_FUSED_SAMPLING=0/1 overrides."""
    env = os.environ.get("RLMG_FUSED_SAMPLING")
    if env is not None:
        return env == "1"
    return True


def persistent_min_batch() -> int:
    """Smallest stochastic batch routed to the chunked kernel (the JAX
    package's v4/v6 crossover).  RLMG_PERSISTENT_MIN_BATCH overrides."""
    return int(os.environ.get("RLMG_PERSISTENT_MIN_BATCH", "65"))


def use_persistent_decode(device, batch: Optional[int] = None) -> bool:
    """The chunked kernel: CUDA, and batch >= persistent_min_batch() when
    given.  RLMG_PERSISTENT_DECODE=0/1 overrides everything."""
    env = os.environ.get("RLMG_PERSISTENT_DECODE")
    if env is not None:
        return env == "1"
    if batch is not None and batch < persistent_min_batch():
        return False
    return torch.device(device).type == "cuda"


def _refuse_unported(batch: int, greedy: bool) -> None:
    """The latency kernels (JAX v7/v8) are not ported: raise where the JAX
    package would dispatch to them."""
    env = os.environ.get("RLMG_LATENCY_DECODE")
    lat_max = int(os.environ.get("RLMG_LATENCY_MAX_BATCH", "0"))
    if env == "1" or (env is None and not greedy and batch <= lat_max):
        raise NotImplementedError(
            "latency decode kernels (v7/v8) are not ported; unset "
            "RLMG_LATENCY_DECODE / RLMG_LATENCY_MAX_BATCH")


def _prompt_prefill_active(t0: int) -> bool:
    """JAX policy: prompts of RLMG_PREFILL_MIN (16) tokens or more seed the
    state through the parallel prefill, unless RLMG_PREFILL=0."""
    return (os.environ.get("RLMG_PREFILL") != "0"
            and t0 >= int(os.environ.get("RLMG_PREFILL_MIN", "16")))


def _refuse_prefill(t0: int) -> None:
    if _prompt_prefill_active(t0):
        raise NotImplementedError(
            f"a {t0}-token prompt takes the parallel prefill, which is not "
            "ported; set RLMG_PREFILL=0 to seed token by token")


def generate_tokens(params: dict, cfg: LinearTransformerConfig,
                    init_tokens: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    max_tokens: int, bar_cond: Optional[int] = None,
                    token_count: Optional[int] = None,
                    barbeat_field: int = 2, bar_token_id: int = 1,
                    greedy: bool = False,
                    settings: Sequence[smp.FieldSampling] = smp.CP_SAMPLING,
                    fused: bool = False, fused_sampling: bool = False
                    ) -> GenResult:
    """init_tokens (B, T0, n_fields) seeds the state (teacher-forced), then
    up to ``max_tokens`` sampled steps.  Returns seed + generated tokens.

    ``fused=True`` runs the layer stack through the ``decode_kernel_v4``
    kernel (state stored in ``decode_state_dtype()``); ``fused=False`` the
    plain ``lt.decode_step`` with an f32 state.  The bar-count stop gives
    the JAX while_loop's tokens and valid mask."""
    b, t0, nf = init_tokens.shape
    if not greedy:
        _refuse_prefill(t0)
    dev = init_tokens.device
    dtype = params["in_linear"]["w"].dtype
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, dtype, dev)
    if fused:
        dparams = lt.make_decode_params(params, cfg)
        state = dk4.init_state(cfg, b, device=dev)

        def step_fn(tok, st):
            return dk4.decode_step_v4(params, dparams, cfg, tok, st, pe_table=pe)
    else:
        state = lt.init_decode_state(cfg, b, device=dev)

        def step_fn(tok, st):
            return lt.decode_step(params, cfg, tok, st, pe_table=pe)

    h = torch.zeros((b, cfg.d_model), dtype=dtype, device=dev)
    for t in range(t0):
        h, state = step_fn(init_tokens[:, t], state)
    init_bars = (init_tokens[..., barbeat_field] == bar_token_id).sum(1).to(torch.int32)
    if fused_sampling:
        hw, hb = cm.fused_head_params(params["heads"], cfg.n_fields)

    toks = torch.zeros((b, max_tokens, nf), dtype=torch.int32, device=dev)
    valid = torch.zeros((b, max_tokens), dtype=torch.bool, device=dev)
    bars = init_bars.clone()
    done = (init_bars >= bar_cond) if bar_cond is not None else \
        torch.zeros((b,), dtype=torch.bool, device=dev)
    for t in range(max_tokens):
        if bar_cond is not None and t % STOP_CHECK_EVERY == 0 and bool(done.all()):
            break
        if fused_sampling:
            tok = smp.sample_fields_fused(generator, h @ hw + hb, cfg.vocab_sizes,
                                          settings, greedy=greedy)
        else:
            tok = smp.sample_fields(generator, lt.forward_output(params, cfg, h),
                                    settings, greedy=greedy)
        tok = torch.where(done[:, None], torch.zeros_like(tok), tok)
        bars += ((tok[:, barbeat_field] == bar_token_id) & ~done).to(torch.int32)
        toks[:, t] = tok
        valid[:, t] = ~done
        if bar_cond is not None:
            done = done | (bars >= bar_cond)
        h, state = step_fn(tok, state)
    if token_count is not None:
        valid &= torch.arange(max_tokens, device=dev)[None, :] < token_count
    tokens = torch.cat([init_tokens.to(torch.int32), toks], dim=1)
    valid = torch.cat([torch.ones((b, t0), dtype=torch.bool, device=dev), valid], dim=1)
    return GenResult(tokens, valid, bars)


def generate_tokens_persistent(params: dict, cfg: LinearTransformerConfig,
                               init_tokens: torch.Tensor, *,
                               generator: Optional[torch.Generator] = None,
                               max_tokens: int, bar_cond: Optional[int] = None,
                               token_count: Optional[int] = None,
                               barbeat_field: int = 2, bar_token_id: int = 1,
                               greedy: bool = False,
                               settings: Sequence[smp.FieldSampling] = smp.CP_SAMPLING,
                               chunk: Optional[int] = None) -> GenResult:
    """generate_tokens through the ``decode_kernel_v6`` kernel, as the JAX
    ``_generate_tokens_chunked``: every init token but the last is
    teacher-forced through the plain ``lt.decode_step``, the last one is the
    kernel's first input, and each call emits up to ``chunk`` tokens.  The
    host checks the bar-count stop between calls; validity and bar counts
    are then derived after the fact with the per-step path's semantics."""
    b, t0, nf = init_tokens.shape
    dev = init_tokens.device
    if chunk is None:
        chunk = min(max_tokens, 256) if bar_cond is None else 128
    _refuse_prefill(t0 - 1)
    dtype = params["in_linear"]["w"].dtype
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, dtype, dev)
    v6p = dk6.make_v6_params(params, cfg)
    state = lt.init_decode_state(cfg, b, device=dev)
    for t in range(t0 - 1):
        _, state = lt.decode_step(params, cfg, init_tokens[:, t], state, pe_table=pe)
    sdt = decode_state_dtype()
    s, z = state.s.to(sdt).contiguous(), state.z.to(sdt).contiguous()
    tok = init_tokens[:, -1].to(torch.int32).contiguous()

    init_bars = (init_tokens[..., barbeat_field] == bar_token_id).sum(1).to(torch.int32)
    if bar_cond is not None and bool((init_bars >= bar_cond).all()):
        return GenResult(init_tokens.to(torch.int32),
                         torch.ones((b, t0), dtype=torch.bool, device=dev), init_bars)
    seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=generator,
                             device=generator.device if generator else "cpu"))
    seed &= 0x3FFFFFFF
    temps = tuple(st.temperature for st in settings)
    topps = tuple(st.top_p if st.top_p is not None else float("inf") for st in settings)
    pieces, done_t, bars = [], 0, init_bars
    while done_t < max_tokens:
        n = min(chunk, max_tokens - done_t)
        toks, s, z = dk6.fused_decode_v6(
            v6p, tok, s, z, t0 - 1 + done_t, seed, n_head=cfg.n_head, max_tokens=n,
            vocab_sizes=cfg.vocab_sizes, temps=temps, topps=topps, greedy=greedy,
            eps=cfg.attn_eps)
        pieces.append(toks)
        tok = toks[-1]
        done_t += n
        if bar_cond is not None:
            bars = bars + (toks[..., barbeat_field] == bar_token_id).sum(0).to(torch.int32)
            if bool((bars >= bar_cond).all()):
                break
    return _assemble(init_tokens, init_bars, torch.cat(pieces).transpose(0, 1),
                     bar_cond, token_count, barbeat_field, bar_token_id)


def _assemble(init_tokens, init_bars, toks, bar_cond, token_count, barbeat_field,
              bar_token_id) -> GenResult:
    """Validity and bar counts after the fact (JAX _persistent_assemble_fn):
    a token is valid while its song had < bar_cond bars before it; the
    token that reaches bar_cond is kept."""
    b, T = toks.shape[:2]
    dev = toks.device
    is_bar = (toks[..., barbeat_field] == bar_token_id).to(torch.int32)
    bars_after = init_bars[:, None] + torch.cumsum(is_bar, dim=1)
    bars_before = bars_after - is_bar
    if bar_cond is not None:
        valid = bars_before < bar_cond
        n_bars = torch.minimum(bars_after[:, -1],
                               torch.clamp(init_bars, min=bar_cond))
        toks = torch.where(valid[..., None], toks, torch.zeros_like(toks))
    else:
        valid = torch.ones((b, T), dtype=torch.bool, device=dev)
        n_bars = bars_after[:, -1]
    if token_count is not None:
        valid &= torch.arange(T, device=dev)[None, :] < token_count
    t0 = init_tokens.shape[1]
    return GenResult(torch.cat([init_tokens.to(torch.int32), toks], dim=1),
                     torch.cat([torch.ones((b, t0), dtype=torch.bool, device=dev), valid], 1),
                     n_bars.to(torch.int32))


def generate_songs(params: dict, cfg: LinearTransformerConfig,
                   gen_cfg: GenerateConfig, *,
                   generator: Optional[torch.Generator] = None,
                   init: Sequence = CP_SEED, mesh=None) -> list:
    """Returns a list of (n_tokens_i, nf) numpy arrays, one per song (valid
    prefix only).  ``init`` is one seed token row or a (T0, nf) prompt.
    Runs on the device of ``params``.

    Greedy pins the plain per-step path whatever the device and batch (the
    JAX greedy pin, sampler.py:738-750): the kernels sum in another order and
    can flip an argmax at a near-tie.  RLMG_PERSISTENT_DECODE=1,
    RLMG_FUSED_DECODE=1 and RLMG_FUSED_SAMPLING=1 opt greedy back in."""
    if mesh is not None:
        raise NotImplementedError("mesh-sharded generation is not ported")
    dev = params["in_linear"]["w"].device
    b = gen_cfg.batch_size
    init_arr = np.asarray(init, dtype=np.int64)
    if init_arr.ndim == 1:
        init_arr = init_arr[None, :]
    if init_arr.shape[-1] != cfg.n_fields or (init_arr < 0).any() or \
            (init_arr >= np.asarray(cfg.vocab_sizes)).any():
        raise ValueError(f"init: rows of {cfg.n_fields} ids within {cfg.vocab_sizes}")
    init_tokens = torch.as_tensor(init_arr, dtype=torch.int32, device=dev)
    init_tokens = init_tokens[None].expand(b, -1, -1).contiguous()
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(gen_cfg.seed)
    kwargs = dict(
        generator=generator, max_tokens=gen_cfg.max_tokens,
        bar_cond=gen_cfg.bar_production if gen_cfg.token_count is None else None,
        token_count=gen_cfg.token_count, greedy=gen_cfg.greedy,
        settings=smp.GREEDY if gen_cfg.greedy else smp.CP_SAMPLING)
    _refuse_unported(b, gen_cfg.greedy)
    if gen_cfg.greedy:
        use_pers = os.environ.get("RLMG_PERSISTENT_DECODE") == "1"
        use_f = os.environ.get("RLMG_FUSED_DECODE") == "1"
        use_fs = os.environ.get("RLMG_FUSED_SAMPLING") == "1"
    else:
        use_pers = use_persistent_decode(dev, batch=b)
        use_f = use_fused_decode(dev)
        use_fs = use_fused_sampling()
    if use_pers:
        res = generate_tokens_persistent(params, cfg, init_tokens, **kwargs)
    else:
        res = generate_tokens(params, cfg, init_tokens, **kwargs, fused=use_f,
                              fused_sampling=use_fs)
    tokens = res.tokens.cpu().numpy()
    valid = res.valid.cpu().numpy()
    return [tokens[i][valid[i]] for i in range(b)]
