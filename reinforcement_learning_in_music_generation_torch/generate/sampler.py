"""Autoregressive CP generation: counterpart of the JAX package's
``generate/sampler.py``.

Three decode paths, chosen as in the JAX package:
  * per-step (``generate_tokens``): one ``decode_step`` per token, through
    the ``decode_kernel_v4`` kernel on CUDA (``fused=True``; the
    ``decode_kernel_v3`` kernel when the head count is odd) or the plain
    ``lt.decode_step`` (``fused=False``), then on-device sampling
    (``ops/sampling.py``).  On CUDA with ``fused`` and ``fused_sampling``
    (``generate_songs``' default) each token runs as one CUDA graph replay:
    the sampling, the bookkeeping, the embedding, the kernel and the final
    LN, captured once per shape and weights (``_TokenGraph``), the
    counterpart of the JAX package's compiled loop body;
  * chunked (``generate_tokens_persistent``): stochastic batches of
    ``persistent_min_batch()`` songs or more, through the
    ``decode_kernel_v6`` kernel, which samples on the card and emits up to
    128 tokens per call;
  * latency (``generate_tokens_latency``): opt-in (``RLMG_LATENCY_DECODE``,
    ``RLMG_LATENCY_MAX_BATCH``), through ``ops/experimental``'s v8 kernel
    (one launch per chunk) or v7 (one per layer, ``RLMG_LATENCY_KERNEL``).

Prompts of ``RLMG_PREFILL_MIN`` (16) tokens or more seed the state of a
non-greedy run through the parallel prefill (``lt.forward_prefill``),
padded to a 64-token bucket; greedy runs keep the per-token scan.

Stop conditions (testing-no-type-cp.py:169-174): a token whose bar-beat
field is 'Bar' counts a bar; a song is done when its count reaches
``bar_cond`` (the final Bar token is kept).  Finished songs emit zero
tokens that are marked invalid.  A fixed token budget (``token_count``)
masks the tail instead.

Under a mesh (``generate_songs(mesh=...)``, ``parallel/mesh.py``) each dp
index decodes its share of the songs on the per-step path, as JAX's mesh
always takes it, with a generator of its own, and the songs are
all-gathered over dp in global order.  Under tp > 1 the ranks of a tp group
decode the same songs in step, each on its shards of the weights
(``lt.decode_step``'s Megatron layer, the heads row-parallel), from
generators with the same seed, so they sample the same token from the same
logits at every step.
"""

from __future__ import annotations

import collections
import os
import warnings
import weakref
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..config import GenerateConfig, LinearTransformerConfig
from ..models import common as cm
from ..models import linear_transformer as lt
from ..ops import decode_kernel_v3 as dk3
from ..ops import decode_kernel_v4 as dk4
from ..ops import decode_kernel_v6 as dk6
from ..ops import sampling as smp
from ..ops.decode_common import decode_state_dtype
from ..ops.experimental import decode_kernel_v7 as dk7
from ..ops.experimental import decode_kernel_v8 as dk8
from ..parallel.mesh import all_gather_object
from ..parallel.sharding import shard_tree
from ..utils.cuda_graph import capture_stream


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


def latency_max_batch() -> int:
    """Largest stochastic batch routed to the latency kernels (v8 or v7,
    ``latency_kernel_version()``).  0, the default, disables the path: it is
    opt-in, as in the JAX package.  RLMG_LATENCY_MAX_BATCH overrides."""
    return int(os.environ.get("RLMG_LATENCY_MAX_BATCH", "0"))


def use_latency_decode(device, batch: Optional[int] = None) -> bool:
    """The latency kernels: CUDA, and batch <= latency_max_batch() when
    given (the JAX rule with "the device is CUDA" for "the backend is a
    TPU").  RLMG_LATENCY_DECODE=0/1 overrides everything."""
    env = os.environ.get("RLMG_LATENCY_DECODE")
    if env is not None:
        return env == "1"
    if batch is None or batch > latency_max_batch():
        return False
    return torch.device(device).type == "cuda"


def latency_kernel_version() -> str:
    """"v8" (one launch per chunk, the default) or "v7" (one launch per
    layer); RLMG_LATENCY_KERNEL overrides, anything else raises."""
    v = os.environ.get("RLMG_LATENCY_KERNEL", "v8")
    if v not in ("v7", "v8"):
        raise ValueError(f"RLMG_LATENCY_KERNEL must be v7 or v8, got {v!r}")
    return v


def _prompt_prefill_active(t0: int) -> bool:
    """JAX policy: prompts of RLMG_PREFILL_MIN (16) tokens or more seed the
    state through the parallel prefill, unless RLMG_PREFILL=0."""
    return (os.environ.get("RLMG_PREFILL") != "0"
            and t0 >= int(os.environ.get("RLMG_PREFILL_MIN", "16")))


def _bucket_pad(prompt: torch.Tensor):
    """A prompt that takes the prefill, padded with zero rows to its 64-token
    bucket (``lt.prefill_bucket``) -> (prompt, n_valid): n_valid is the true
    length, or None when no padding was needed."""
    t = prompt.shape[1]
    tb = lt.prefill_bucket(t)
    if tb == t:
        return prompt, None
    return torch.nn.functional.pad(prompt, (0, 0, 0, tb - t)), t


def _seed_state(params: dict, cfg: LinearTransformerConfig, init_tokens: torch.Tensor,
                state: lt.DecodeState, pe: torch.Tensor,
                n_valid: Optional[int] = None) -> lt.DecodeState:
    """Teacher-force ``init_tokens`` into the plain recurrent state (JAX
    :191-216): the parallel prefill for long prompts, the per-token steps
    below RLMG_PREFILL_MIN.  ``n_valid``: the true prompt length when the
    caller bucket-padded init_tokens (prefill only)."""
    if _prompt_prefill_active(init_tokens.shape[1]):
        _, st = lt.forward_prefill(params, cfg, init_tokens, n_valid, pe_table=pe)
        return lt.DecodeState(st.s.to(state.s.dtype), st.z.to(state.z.dtype), st.step)
    for t in range(init_tokens.shape[1]):
        _, state = lt.decode_step(params, cfg, init_tokens[:, t], state, pe_table=pe)
    return state


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _clone(tree):
    return {k: _clone(v) for k, v in tree.items()} if isinstance(tree, dict) else tree.clone()


def _cached(cache: "collections.OrderedDict", size: int, key, params: dict, build):
    """``build()``, kept in ``cache`` (an LRU of ``size`` entries) under
    ``key`` for as long as ``params``' tensors live unchanged.  An entry
    holds weak references to the tensors and their version counters: JAX
    arrays are immutable, torch tensors are not, so an in-place update (an
    optimizer step) builds again, and the entry goes when one of the
    tensors is freed.  What ``build`` returns should hold none of them."""
    leaves = list(_leaves(params))
    versions = tuple(t._version for t in leaves)
    hit = cache.get(key)
    if (hit is not None and hit[1] == versions and len(hit[0]) == len(leaves)
            and all(r() is t for r, t in zip(hit[0], leaves))):
        cache.move_to_end(key)
        return hit[2]
    cache.pop(key, None)
    while len(cache) >= size:
        cache.popitem(last=False)
    value, tag = build(), object()

    def drop(_):
        entry = cache.get(key)
        if entry is not None and entry[3] is tag:
            del cache[key]
    cache[key] = ([weakref.ref(t, drop) for t in leaves], versions, value, tag)
    return value


_PACKED_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_PACKED_CACHE_SIZE = 8


def _packed_decode_params(params: dict, cfg: LinearTransformerConfig) -> dk6.V6Params:
    """The chunked and latency kernels' weights (``make_resident_params``),
    packed once per params object (JAX :301-322), cached by ``_cached``."""
    return _cached(_PACKED_CACHE, _PACKED_CACHE_SIZE, (id(params), cfg), params,
                   lambda: dk8.make_resident_params(params, cfg))


class _Loop(NamedTuple):
    """The sampled loop's state on the device: the tokens (B, T, n_fields)
    and their validity (B, T) so far, the finished songs, the bar counts,
    and t, the next token's index ((1,) long)."""
    toks: torch.Tensor
    valid: torch.Tensor
    done: torch.Tensor
    bars: torch.Tensor
    t: torch.Tensor

    @staticmethod
    def new(b: int, max_tokens: int, nf: int, dev) -> "_Loop":
        return _Loop(torch.zeros((b, max_tokens, nf), dtype=torch.int32, device=dev),
                     torch.zeros((b, max_tokens), dtype=torch.bool, device=dev),
                     torch.zeros((b,), dtype=torch.bool, device=dev),
                     torch.zeros((b,), dtype=torch.int32, device=dev),
                     torch.zeros((1,), dtype=torch.long, device=dev))

    def start(self, done: torch.Tensor, bars: torch.Tensor) -> None:
        self.toks.zero_()
        self.valid.zero_()
        self.done.copy_(done)
        self.bars.copy_(bars)
        self.t.zero_()


def _loop_token(loop: _Loop, h: torch.Tensor, sample, step, bar_cond: Optional[int],
                barbeat_field: int, bar_token_id: int) -> torch.Tensor:
    """One token of the sampled loop, all on the device: ``sample(h)``, zero
    for finished songs, bars counted, the token and its validity stored at
    loop.t, the songs that reached ``bar_cond`` marked done, t advanced;
    returns ``step(token)``, the next h.  The eager loop runs it from the
    host, ``_TokenGraph`` captures it."""
    done = loop.done
    tok = sample(h)
    tok = torch.where(done[:, None], torch.zeros_like(tok), tok)
    loop.bars.add_(((tok[:, barbeat_field] == bar_token_id) & ~done).to(torch.int32))
    loop.toks.index_copy_(1, loop.t, tok[:, None])
    loop.valid.index_copy_(1, loop.t, ~done[:, None])
    if bar_cond is not None:
        torch.logical_or(done, loop.bars >= bar_cond, out=done)
    loop.t.add_(1)
    return step(tok)


class _TokenGraph:
    """One sampled token of ``generate_tokens``' loop as a CUDA graph, for
    one (weights, config, batch, token budget, sampling settings): a capture
    of ``_loop_token`` at the device position pos, with kernel A (v3 at odd
    heads) and the final LN as its step.  Every buffer the graph reads or
    writes belongs to the object: the kernel's workspace, and copies of the
    embedding, in_linear and final LN weights and of the heads, so it keeps
    none of the caller's tensors alive.  A call copies its start into them
    and replays the graph a token.  The random draws come from the object's
    generator, registered with the graph (each replay draws new numbers and
    advances it as the eager loop advances its own); a call sets it to the
    caller's generator's state and hands the state back after the loop, so
    the stream is the eager one."""

    def __init__(self, params: dict, cfg: LinearTransformerConfig, b: int, max_tokens: int,
                 greedy: bool, settings, bar_cond: Optional[int], barbeat_field: int,
                 bar_token_id: int):
        dev = params["in_linear"]["w"].device
        dtype = params["in_linear"]["w"].dtype
        self.cfg, self.dev, self.max_tokens = cfg, dev, max_tokens
        self.greedy, self.settings, self.bar_cond = greedy, tuple(settings), bar_cond
        self.barbeat_field, self.bar_token_id = barbeat_field, bar_token_id
        self.own = {k: _clone(params[k]) for k in ("emb", "in_linear", "final_ln")}
        self.pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, dtype, dev)
        self.hw, self.hb = cm.fused_head_params(params["heads"], cfg.n_fields)
        if cfg.n_head % 2 == 0:
            st = dk4.init_state(cfg, b, device=dev)
            self.s, self.z = st.s, st.z
            self.work = dk4.workspace(lt.make_decode_params(params, cfg), b)
        else:
            self.s = dk3.init_aug_state(cfg, b, dev)
            self.z = torch.zeros((1,), dtype=torch.float32, device=dev)
            self.work = dk3.workspace(dk3.make_v3_params(params, cfg, dtype=dtype), b)
        self.h = torch.zeros((b, cfg.d_model), dtype=dtype, device=dev)
        self.pos = torch.zeros((), dtype=torch.long, device=dev)
        self.loop = _Loop.new(b, max_tokens, cfg.n_fields, dev)
        self.gen = None if greedy else torch.Generator(device=dev)
        # one eager run on the capture stream first (lazy set-up: cuBLAS
        # workspaces, the sampler's constants, the kernel's launch set-up);
        # its effects on the buffers are overwritten by every call.  The
        # capture is begun and ended directly: torch.cuda.graph's context
        # also empties the allocator's caches and reads torch.compiler's
        # config, whose first import cost a cold call 0.8 s on the card.
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self._body()
            if self.gen is not None:
                self.graph.register_generator_state(self.gen)
            self.graph.capture_begin()
            try:
                self._body()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        generate_tokens.graph_captures += 1

    def step(self, tok: torch.Tensor, pos) -> torch.Tensor:
        """The kernel step on the object's state: embed tok at pos (an int or
        a 0-d device tensor), the layer stack, the final LN."""
        x = lt.embed_input(self.own, self.cfg, tok, pos, self.pe)
        if self.cfg.n_head % 2 == 0:
            out = dk4.fused_stack_step(None, x.float(), self.s, self.z, n_head=self.cfg.n_head,
                                       eps=self.cfg.attn_eps, work=self.work)[0]
        else:
            out = dk3.fused_stack_step(None, x.float(), self.s, n_head=self.cfg.n_head,
                                       eps=self.cfg.attn_eps, work=self.work)[0]
        return cm.layernorm(self.own["final_ln"], out.to(x.dtype))

    def _sample(self, h: torch.Tensor) -> torch.Tensor:
        return smp.sample_fields_fused(self.gen, h @ self.hw + self.hb, self.cfg.vocab_sizes,
                                       self.settings, greedy=self.greedy)

    def _body(self) -> None:
        self.h.copy_(_loop_token(self.loop, self.h, self._sample,
                                 lambda tok: self.step(tok, self.pos), self.bar_cond,
                                 self.barbeat_field, self.bar_token_id))
        self.pos += 1

    def run(self, h: torch.Tensor, step: int, done: torch.Tensor, bars: torch.Tensor,
            generator: Optional[torch.Generator]):
        """The sampled loop from h and the object's state at position step:
        (toks, valid, bars), fresh tensors."""
        self.h.copy_(h)
        self.pos.fill_(step)
        self.loop.start(done, bars)
        src = None
        if self.gen is not None:
            src = generator if generator is not None else \
                torch.cuda.default_generators[self.dev.index or 0]
            self.gen.set_state(src.get_state())
        for t in range(self.max_tokens):
            if (self.bar_cond is not None and t % STOP_CHECK_EVERY == 0
                    and bool(self.loop.done.all())):
                break
            self.graph.replay()
            generate_tokens.graph_replays += 1
        if src is not None:
            src.set_state(self.gen.get_state())
        return self.loop.toks.clone(), self.loop.valid.clone(), self.loop.bars.clone()


_TOKEN_GRAPHS: "collections.OrderedDict" = collections.OrderedDict()
_TOKEN_GRAPH_CACHE_SIZE = 4


def _token_graph(params: dict, cfg: LinearTransformerConfig, b: int, max_tokens: int,
                 greedy: bool, settings, bar_cond: Optional[int], barbeat_field: int,
                 bar_token_id: int) -> _TokenGraph:
    """The ``_TokenGraph`` of these weights and this loop, captured at its
    first use and cached by ``_cached`` per params, shape, budget, settings
    and the state's dtype."""
    key = (id(params), cfg, b, max_tokens, greedy, tuple(settings), bar_cond, barbeat_field,
           bar_token_id, decode_state_dtype())
    return _cached(_TOKEN_GRAPHS, _TOKEN_GRAPH_CACHE_SIZE, key, params,
                   lambda: _TokenGraph(params, cfg, b, max_tokens, greedy, settings, bar_cond,
                                       barbeat_field, bar_token_id))


def generate_tokens(params: dict, cfg: LinearTransformerConfig,
                    init_tokens: torch.Tensor, *,
                    generator: Optional[torch.Generator] = None,
                    max_tokens: int, bar_cond: Optional[int] = None,
                    token_count: Optional[int] = None,
                    barbeat_field: int = 2, bar_token_id: int = 1,
                    greedy: bool = False,
                    settings: Sequence[smp.FieldSampling] = smp.CP_SAMPLING,
                    fused: bool = False, fused_sampling: bool = False,
                    n_valid: Optional[int] = None, mesh=None) -> GenResult:
    """init_tokens (B, T0, n_fields) seeds the state (teacher-forced), then
    up to ``max_tokens`` sampled steps.  Returns seed + generated tokens.

    ``fused=True`` runs the layer stack through the ``decode_kernel_v4``
    kernel (state stored in ``decode_state_dtype()``) when the head count is
    even and through the ``decode_kernel_v3`` kernel (an f32 augmented
    state, whatever RLMG_DECODE_STATE_DTYPE says) when it is odd (JAX
    :583-597); ``fused=False`` the plain ``lt.decode_step`` with an f32
    state.  The bar-count stop gives the JAX while_loop's tokens and valid
    mask.

    A non-greedy prompt of RLMG_PREFILL_MIN tokens or more seeds the state
    through the parallel prefill (JAX :602-636), cast straight into the
    step's state type; greedy keeps the per-token steps (the greedy pin).
    ``n_valid``: the true prompt length when the caller bucket-padded
    init_tokens (``lt.prefill_bucket``), legal only where the prefill runs;
    the pad rows come back valid=False.

    On CUDA with ``fused`` and ``fused_sampling`` each sampled token is one
    replay of a ``_TokenGraph`` (``graph_captures`` and ``graph_replays``
    count them; a failed capture or replay raises); the prompt's steps run
    eagerly on the graph's state.  Elsewhere the loop runs eagerly.

    ``mesh`` with tp > 1: ``params`` are the rank's tp shards and the plain
    per-step path runs the Megatron layer (``lt.decode_step(mesh=...)``);
    ``fused`` is refused there (kernels A and v3 read every layer's whole
    weights and have no place for the row-parallel sums)."""
    tp = 1 if mesh is None else mesh.tp
    if fused and tp > 1:
        raise ValueError("fused=True under tp > 1: kernels A and v3 take whole weights")
    b, t0, nf = init_tokens.shape
    dev = init_tokens.device
    dtype = params["in_linear"]["w"].dtype
    graphed = fused and fused_sampling and dev.type == "cuda" and max_tokens > 0
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, dtype, dev)
    if graphed:
        tg = _token_graph(params, cfg, b, max_tokens, greedy, settings, bar_cond,
                          barbeat_field, bar_token_id)
        tg.s.zero_()
        tg.z.zero_()
        state = lt.DecodeState(tg.s, tg.z, 0)

        def step_fn(tok, st):
            return tg.step(tok, st.step), lt.DecodeState(st.s, st.z, st.step + 1)
    elif fused and cfg.n_head % 2 == 0:
        dparams = lt.make_decode_params(params, cfg)
        state = dk4.init_state(cfg, b, device=dev)
        work = dk4.workspace(dparams, b) if dev.type == "cuda" else None

        def step_fn(tok, st):
            return dk4.decode_step_v4(params, dparams, cfg, tok, st, pe_table=pe, work=work)
    elif fused:
        v3p = dk3.make_v3_params(params, cfg, dtype=dtype)
        state = lt.DecodeState(dk3.init_aug_state(cfg, b, dev),
                               torch.zeros((1,), dtype=torch.float32, device=dev), 0)
        work = dk3.workspace(v3p, b) if dev.type == "cuda" else None

        def step_fn(tok, st):
            return dk3.decode_step_v3(params, v3p, cfg, tok, st, pe_table=pe, work=work)
    else:
        state = lt.init_decode_state(cfg, b, device=dev, mesh=mesh)

        def step_fn(tok, st):
            return lt.decode_step(params, cfg, tok, st, pe_table=pe, mesh=mesh)

    prefill_ok = (not greedy and not (fused and cfg.n_head % 2 != 0)
                  and _prompt_prefill_active(t0))
    if n_valid is not None and not prefill_ok:
        raise ValueError("n_valid (a bucket-padded prompt) needs the prefill seeding")
    if prefill_ok:
        h, pst = lt.forward_prefill(params, cfg, init_tokens, n_valid, pe_table=pe, mesh=mesh)
        h = h.to(dtype)
        if graphed:
            state.s.copy_(pst.s)
            state.z.copy_(pst.z)
            state = lt.DecodeState(state.s, state.z, pst.step)
        else:
            state = lt.DecodeState(pst.s.to(state.s.dtype), pst.z.to(state.z.dtype), pst.step)
    else:
        h = torch.zeros((b, cfg.d_model), dtype=dtype, device=dev)
        for t in range(t0):
            h, state = step_fn(init_tokens[:, t], state)
    seed_valid = torch.ones((b, t0), dtype=torch.bool, device=dev)
    if n_valid is not None:
        seed_valid &= torch.arange(t0, device=dev)[None, :] < n_valid
    init_bars = ((init_tokens[..., barbeat_field] == bar_token_id) & seed_valid
                 ).sum(1).to(torch.int32)
    done = (init_bars >= bar_cond) if bar_cond is not None else \
        torch.zeros((b,), dtype=torch.bool, device=dev)
    if graphed:
        toks, valid, bars = tg.run(h, int(state.step), done, init_bars, generator)
    else:
        toks, valid, bars = _eager_loop(params, cfg, h, state, step_fn, done, init_bars,
                                        generator=generator, max_tokens=max_tokens,
                                        bar_cond=bar_cond, barbeat_field=barbeat_field,
                                        bar_token_id=bar_token_id, greedy=greedy,
                                        settings=settings, fused_sampling=fused_sampling,
                                        mesh=mesh)
    if token_count is not None:
        valid &= torch.arange(max_tokens, device=dev)[None, :] < token_count
    tokens = torch.cat([init_tokens.to(torch.int32), toks], dim=1)
    return GenResult(tokens, torch.cat([seed_valid, valid], dim=1), bars)


generate_tokens.graph_captures = generate_tokens.graph_replays = 0


def _eager_loop(params: dict, cfg: LinearTransformerConfig, h: torch.Tensor,
                state: lt.DecodeState, step_fn, done: torch.Tensor, init_bars: torch.Tensor, *,
                generator: Optional[torch.Generator], max_tokens: int,
                bar_cond: Optional[int], barbeat_field: int, bar_token_id: int,
                greedy: bool, settings: Sequence[smp.FieldSampling], fused_sampling: bool,
                mesh=None):
    """The sampled loop token by token from the host (``_loop_token`` with
    ``step_fn`` as its step): (toks, valid, bars).  Under tp (``mesh``) the
    logits come from the row-parallel heads."""
    loop = _Loop.new(h.shape[0], max_tokens, cfg.n_fields, h.device)
    loop.start(done, init_bars)
    if mesh is not None and mesh.tp > 1:
        def sample(x):
            logits = lt.head_logits(params, cfg, x, mesh)
            if fused_sampling:
                return smp.sample_fields_fused(generator, logits, cfg.vocab_sizes, settings,
                                               greedy=greedy)
            return smp.sample_fields(generator, torch.split(logits, list(cfg.vocab_sizes), -1),
                                     settings, greedy=greedy)
    elif fused_sampling:
        hw, hb = cm.fused_head_params(params["heads"], cfg.n_fields)

        def sample(x):
            return smp.sample_fields_fused(generator, x @ hw + hb, cfg.vocab_sizes, settings,
                                           greedy=greedy)
    else:
        def sample(x):
            return smp.sample_fields(generator, lt.forward_output(params, cfg, x), settings,
                                     greedy=greedy)

    def step(tok):
        nonlocal state
        out, state = step_fn(tok, state)
        return out
    for t in range(max_tokens):
        if bar_cond is not None and t % STOP_CHECK_EVERY == 0 and bool(loop.done.all()):
            break
        h = _loop_token(loop, h, sample, step, bar_cond, barbeat_field, bar_token_id)
    return loop.toks, loop.valid, loop.bars


def generate_tokens_persistent(params: dict, cfg: LinearTransformerConfig,
                               init_tokens: torch.Tensor, *,
                               generator: Optional[torch.Generator] = None,
                               max_tokens: int, bar_cond: Optional[int] = None,
                               token_count: Optional[int] = None,
                               barbeat_field: int = 2, bar_token_id: int = 1,
                               greedy: bool = False,
                               settings: Sequence[smp.FieldSampling] = smp.CP_SAMPLING,
                               chunk: Optional[int] = None) -> GenResult:
    """generate_tokens through the ``decode_kernel_v6`` kernel (the JAX
    function, :324-354)."""
    return _generate_tokens_chunked(
        "v6", params, cfg, init_tokens, generator=generator, max_tokens=max_tokens,
        bar_cond=bar_cond, token_count=token_count, barbeat_field=barbeat_field,
        bar_token_id=bar_token_id, greedy=greedy, settings=settings, chunk=chunk)


def generate_tokens_latency(params: dict, cfg: LinearTransformerConfig,
                            init_tokens: torch.Tensor, *,
                            generator: Optional[torch.Generator] = None,
                            max_tokens: int, bar_cond: Optional[int] = None,
                            token_count: Optional[int] = None,
                            barbeat_field: int = 2, bar_token_id: int = 1,
                            greedy: bool = False,
                            settings: Sequence[smp.FieldSampling] = smp.CP_SAMPLING,
                            chunk: Optional[int] = None) -> GenResult:
    """generate_tokens through the latency kernels (the JAX function,
    :357-383): ``decode_kernel_v8`` (one launch per chunk, the default) or
    ``decode_kernel_v7`` (one launch per layer), as
    ``latency_kernel_version()`` says.  Meant for B <= latency_max_batch();
    the kernels take at most 16 songs."""
    return _generate_tokens_chunked(
        latency_kernel_version(), params, cfg, init_tokens, generator=generator,
        max_tokens=max_tokens, bar_cond=bar_cond, token_count=token_count,
        barbeat_field=barbeat_field, bar_token_id=bar_token_id, greedy=greedy,
        settings=settings, chunk=chunk)


_CHUNK_KERNELS = {"v6": dk6.fused_decode_v6, "v7": dk7.fused_decode_v7,
                  "v8": dk8.fused_decode_v8}


def _generate_tokens_chunked(backend: str, params: dict, cfg: LinearTransformerConfig,
                             init_tokens: torch.Tensor, *,
                             generator: Optional[torch.Generator], max_tokens: int,
                             bar_cond: Optional[int], token_count: Optional[int],
                             barbeat_field: int, bar_token_id: int, greedy: bool,
                             settings: Sequence[smp.FieldSampling],
                             chunk: Optional[int]) -> GenResult:
    """The chunked kernels' loop (JAX :386-505): every init token but the
    last seeds the state (``_seed_state``: the prefill for long prompts,
    bucket-padded, else token by token), the last one is the kernel's first
    input, and each call emits up to ``chunk`` tokens.  The host checks the
    bar-count stop between calls; validity and bar counts are then derived
    after the fact with the per-step path's semantics."""
    b, t0, nf = init_tokens.shape
    dev = init_tokens.device
    if chunk is None:
        chunk = min(max_tokens, 256) if bar_cond is None else 128
    dtype = params["in_linear"]["w"].dtype
    pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, dtype, dev)
    packed = _packed_decode_params(params, cfg)
    prompt, n_valid = init_tokens[:, :-1], None
    if _prompt_prefill_active(t0 - 1):
        prompt, n_valid = _bucket_pad(prompt)
    state = _seed_state(params, cfg, prompt, lt.init_decode_state(cfg, b, device=dev), pe,
                        n_valid)
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
    fused_decode = _CHUNK_KERNELS[backend]
    pieces, done_t, bars = [], 0, init_bars
    while done_t < max_tokens:
        n = min(chunk, max_tokens - done_t)
        toks, s, z = fused_decode(
            packed, tok, s, z, t0 - 1 + done_t, seed, n_head=cfg.n_head, max_tokens=n,
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
    RLMG_LATENCY_DECODE=1, RLMG_FUSED_DECODE=1 and RLMG_FUSED_SAMPLING=1 opt
    greedy back in.  The latency path takes precedence over the chunked one;
    odd head counts take neither and decode per step (JAX :760-769), through
    the v3 kernel when fused.

    ``mesh`` (``parallel.make_mesh``; every rank calls this): the ranks of
    dp index i decode songs [i b/dp, (i+1) b/dp) on the per-step path (JAX
    takes neither the latency nor the chunked path under a mesh), from a
    generator seeded 7919 i above the run's seed (``gen_cfg.seed``, or a
    draw from ``generator``), so no two dp indices' songs are copies; every
    rank returns all b songs, in order.  A batch that dp does not divide is
    decoded whole on every rank, from the run's own generator (JAX's
    replicated placement).  Under tp > 1 ``params`` is the whole tree, the
    same on every rank; each rank keeps its tp shards of it (JAX's
    ``shard_params``) and decodes with the Megatron layer on the plain
    per-step path.  Kernel A does not run under tp: it reads every layer's
    whole weights in one launch and has no place for the row-parallel sums
    (JAX's reason for keeping C, D and G off the tp layer); an explicit
    ``RLMG_FUSED_DECODE=1`` is ignored there with a warning.  Where JAX's
    GSPMD would hand its v4 kernel all-gathered weights, the port does not:
    the gather would undo tp's memory split.  Greedy tokens equal one
    process's, as JAX's (tests/test_sharded_generation.py)."""
    tp = 1 if mesh is None else mesh.tp
    if tp > 1:
        lt.check_tp(cfg, tp)
        params = shard_tree(mesh, params)
    dev = params["in_linear"]["w"].device
    b_all = gen_cfg.batch_size
    sharded = mesh is not None and mesh.dp > 1 and b_all % mesh.dp == 0
    b = b_all // mesh.dp if sharded else b_all
    init_arr = np.asarray(init, dtype=np.int64)
    if init_arr.ndim == 1:
        init_arr = init_arr[None, :]
    if init_arr.shape[-1] != cfg.n_fields or (init_arr < 0).any() or \
            (init_arr >= np.asarray(cfg.vocab_sizes)).any():
        raise ValueError(f"init: rows of {cfg.n_fields} ids within {cfg.vocab_sizes}")
    init_tokens = torch.as_tensor(init_arr, dtype=torch.int32, device=dev)
    init_tokens = init_tokens[None].expand(b, -1, -1).contiguous()
    if sharded:
        seed = gen_cfg.seed if generator is None else int(torch.randint(
            0, 2 ** 62, (), generator=generator, device=generator.device))
        generator = torch.Generator(device=dev)
        generator.manual_seed(seed + 7919 * mesh.dp_index)
    elif generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(gen_cfg.seed)
    kwargs = dict(
        generator=generator, max_tokens=gen_cfg.max_tokens,
        bar_cond=gen_cfg.bar_production if gen_cfg.token_count is None else None,
        token_count=gen_cfg.token_count, greedy=gen_cfg.greedy,
        settings=smp.GREEDY if gen_cfg.greedy else smp.CP_SAMPLING)
    if gen_cfg.greedy:
        use_pers = os.environ.get("RLMG_PERSISTENT_DECODE") == "1"
        use_lat = os.environ.get("RLMG_LATENCY_DECODE") == "1"
        use_f = os.environ.get("RLMG_FUSED_DECODE") == "1"
        use_fs = os.environ.get("RLMG_FUSED_SAMPLING") == "1"
    else:
        use_pers = use_persistent_decode(dev, batch=b)
        use_lat = use_latency_decode(dev, batch=b)
        use_f = use_fused_decode(dev)
        use_fs = use_fused_sampling()
    if cfg.n_head % 2 != 0:
        use_pers = use_lat = False
    if mesh is not None:
        use_pers = use_lat = False
    if tp > 1:
        if use_f and os.environ.get("RLMG_FUSED_DECODE") == "1":
            warnings.warn(f"RLMG_FUSED_DECODE=1 ignored under tp={tp}: kernel A reads every "
                          "layer's whole weights; the per-step Megatron layer instead")
        use_f = False
    if use_lat:
        res = generate_tokens_latency(params, cfg, init_tokens, **kwargs)
    elif use_pers:
        res = generate_tokens_persistent(params, cfg, init_tokens, **kwargs)
    else:
        n_valid = None
        if (not gen_cfg.greedy and not (use_f and cfg.n_head % 2 != 0)
                and _prompt_prefill_active(init_tokens.shape[1])):
            init_tokens, n_valid = _bucket_pad(init_tokens)   # pad rows come back invalid
        res = generate_tokens(params, cfg, init_tokens, **kwargs, fused=use_f,
                              fused_sampling=use_fs, n_valid=n_valid, mesh=mesh)
    tokens = res.tokens.cpu().numpy()
    valid = res.valid.cpu().numpy()
    songs = [tokens[i][valid[i]] for i in range(b)]
    if sharded:
        songs = [song for part in all_gather_object(mesh, songs, axis="dp") for song in part]
    return songs
