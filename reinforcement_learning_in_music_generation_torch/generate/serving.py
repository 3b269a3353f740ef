"""Continuous batching: a slot refills the moment its song completes.

Counterpart of the JAX package's ``generate/serving.py``.  The synchronous
batcher (``sampler.generate_songs``) runs every song of a batch until the
last one reaches its bar budget.  Here each slot restarts as soon as its
song has ``bar_cond`` bars: its recurrent (S, z) rows are zeroed, its
position goes back to 0 and the init token is its next input, while the
other slots go on.  The loop ends when ``n_songs`` songs are complete (or
at the step budget), not when a batch drains.

Mechanics:
  * each slot has its own position: ``lt.embed_input`` gathers a (B,)
    position vector's rows of the positional table;
  * the refill is a masked store over the batch axis (axis 1 of the port's
    (L, B, H, E, E) state), done every step: a CUDA graph has no device
    branch, so the JAX loop's ``lax.cond(any(finished))`` gate is dropped;
  * the per-step finish flags alone mark song boundaries; the host slices
    each slot's token column between consecutive finishes.

On CUDA with the fused step (kernel A, ``ops/decode_kernel_v4.py``, at an
even head count) each step is one replay of a CUDA graph
(``_ServeLoop``): the sampling, the bar count, the refill, the embedding,
kernel A and the final LN.  The host checks the stop every
``sampler.STOP_CHECK_EVERY`` steps, so the loop may run past the JAX
loop's last step; ``steps`` and ``songs_done`` are then computed from the
finish flags, the first step at which the running total of finishes
reaches ``n_songs`` (capped at the budget), which is where the JAX loop
stops, and the songs finished after it are dropped.  Elsewhere (CPU, odd
head counts, ``fused=False``) the same step body runs eagerly, with the
plain ``lt.decode_step`` and an f32 state, as the JAX loop's plain branch.

``serve_requests`` is the daemon: it tails a JSONL request file, answers
each request with this loop (or, for a MIDI prompt, with
``sampler.generate_songs``' prefill and bar-stop sampler) and journals
what it served so that a restart serves each request once.
"""

from __future__ import annotations

import collections
import json
import os
import time
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import GenerateConfig, LinearTransformerConfig
from ..models import common as cm
from ..models import linear_transformer as lt
from ..ops import decode_kernel_v4 as dk4
from ..ops import sampling as smp
from ..ops.decode_common import decode_state_dtype
from ..utils.cuda_graph import capture_stream
from . import sampler


class ServeResult(NamedTuple):
    songs: List[np.ndarray]    # completed songs, (len, n_fields) each, in
                               # completion order (the first n_songs)
    steps: int                 # decode steps of the loop (the JAX loop's count)
    songs_done: int            # songs completed within those steps (may exceed n_songs)


class _ServeLoop:
    """The loop's buffers and its one step body for a batch of b slots and
    ``max_steps`` recorded steps: h, the state (s, z), each slot's position,
    bar count, init token and init bar count, the bar target, the count of
    finished songs, the step index t, and the (max_steps, b, n_fields)
    tokens and (max_steps, b) finish flags.

    With ``graph`` (CUDA and the fused step) the body is captured once as a
    CUDA graph and each step is one replay.  The object then holds copies of
    every weight it reads (the kernel's workspace, the embedding, in_linear,
    final LN and heads), none of the caller's tensors, and a generator of
    its own, registered with the graph: a run sets it to the caller's
    generator's state and hands the state back after, so the graphed stream
    is the eager one.  Without ``graph`` the body runs eagerly from the host
    on the caller's generator."""

    def __init__(self, params: dict, cfg: LinearTransformerConfig, b: int, max_steps: int,
                 settings, barbeat_field: int, bar_token_id: int, fused: bool, graph: bool):
        dev = params["in_linear"]["w"].device
        dtype = params["in_linear"]["w"].dtype
        self.cfg, self.dev, self.settings = cfg, dev, tuple(settings)
        self.barbeat_field, self.bar_token_id = barbeat_field, bar_token_id
        self.fused, self.graphed = fused, graph
        self.pe = cm.sinusoidal_table(cfg.max_len, cfg.d_model, dtype, dev)
        self.hw, self.hb = cm.fused_head_params(params["heads"], cfg.n_fields)
        if fused:
            self.own = {k: sampler._clone(params[k]) for k in ("emb", "in_linear", "final_ln")}
            dparams = lt.make_decode_params(params, cfg)
            st = dk4.init_state(cfg, b, device=dev)
            self.dparams = None if dev.type == "cuda" else dparams
            self.work = dk4.workspace(dparams, b) if dev.type == "cuda" else None
        else:
            self.params = params
            st = lt.init_decode_state(cfg, b, device=dev)
        self.s, self.z = st.s, st.z
        i32 = dict(dtype=torch.int32, device=dev)
        self.h = torch.zeros((b, cfg.d_model), dtype=dtype, device=dev)
        self.pos = torch.zeros((b,), dtype=torch.long, device=dev)
        self.bars = torch.zeros((b,), **i32)
        self.bars0 = torch.zeros((b,), **i32)
        self.tok0 = torch.zeros((b, cfg.n_fields), **i32)
        self.bar_cond = torch.zeros((), **i32)
        self.done = torch.zeros((), **i32)
        self.t = torch.zeros((1,), dtype=torch.long, device=dev)
        self.toks = torch.zeros((max_steps, b, cfg.n_fields), **i32)
        self.fin = torch.zeros((max_steps, b), dtype=torch.bool, device=dev)
        self.gen = None
        if graph:
            # one eager body on the capture stream first (lazy set-up), then
            # the capture; every run resets what the two wrote
            self.gen = torch.Generator(device=dev)
            stream = capture_stream(dev)
            stream.wait_stream(torch.cuda.current_stream(dev))
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.stream(stream):
                self._body(self.gen)
                self.graph.register_generator_state(self.gen)
                self.graph.capture_begin()
                try:
                    self._body(self.gen)
                finally:
                    self.graph.capture_end()
            torch.cuda.current_stream(dev).wait_stream(stream)
            generate_songs_continuous.graph_captures += 1

    def step(self, tok: torch.Tensor) -> torch.Tensor:
        """tok (b, n_fields) at each slot's position through the layer
        stack into the state; returns h after the final LN; positions + 1."""
        pos = torch.clamp(self.pos, max=self.pe.shape[0] - 1)   # JAX clamps the gather
        if self.fused:
            x = lt.embed_input(self.own, self.cfg, tok, pos, self.pe)
            out = dk4.fused_stack_step(self.dparams, x.float(), self.s, self.z,
                                       n_head=self.cfg.n_head, eps=self.cfg.attn_eps,
                                       work=self.work)[0]
            h = cm.layernorm(self.own["final_ln"], out.to(x.dtype))
        else:
            h, st = lt.decode_step(self.params, self.cfg, tok,
                                   lt.DecodeState(self.s, self.z, pos), pe_table=self.pe)
            self.s, self.z = st.s, st.z
        self.pos.add_(1)
        return h

    def refill(self, finished: torch.Tensor) -> None:
        """The finished slots' rows of the state zeroed, their positions and
        bar counts reset, and the finished songs counted."""
        self.s.masked_fill_(finished.view(1, -1, 1, 1, 1), 0)
        self.z.masked_fill_(finished.view(1, -1, 1, 1), 0)
        self.pos.masked_fill_(finished, 0)
        self.bars.copy_(torch.where(finished, self.bars0, self.bars))
        self.done.add_(finished.sum(dtype=torch.int32))

    def _body(self, gen: Optional[torch.Generator]) -> None:
        """One step: sample from h, count bars, record the token and the
        finish flags at t, refill the finished slots, step the init token
        (finished slots) or the sampled one into the state."""
        tok = smp.sample_fields_fused(gen, self.h @ self.hw + self.hb, self.cfg.vocab_sizes,
                                      self.settings, greedy=False)
        self.bars.add_((tok[:, self.barbeat_field] == self.bar_token_id).to(torch.int32))
        finished = self.bars >= self.bar_cond
        self.toks.index_copy_(0, self.t, tok[None])
        self.fin.index_copy_(0, self.t, finished[None])
        self.refill(finished)
        self.h.copy_(self.step(torch.where(finished[:, None], self.tok0, tok)))
        self.t.add_(1)

    def run(self, init_token: torch.Tensor, n_songs: int, budget: int, bar_cond: int,
            generator: Optional[torch.Generator]) -> Tuple[torch.Tensor, torch.Tensor]:
        """The loop from a zero state: init_token (b, n_fields) stepped in
        eagerly, then steps until ``n_songs`` songs are done (checked every
        ``STOP_CHECK_EVERY`` steps) or ``budget`` steps ran.  Returns the
        tokens and finish flags of the steps that ran (views of the
        object's buffers)."""
        self.s.zero_()
        self.z.zero_()
        self.pos.zero_()
        self.t.zero_()
        self.done.zero_()
        self.tok0.copy_(init_token)
        self.bars0.copy_(self.tok0[:, self.barbeat_field] == self.bar_token_id)
        self.bars.copy_(self.bars0)
        self.bar_cond.fill_(bar_cond)
        self.h.copy_(self.step(self.tok0))
        src = None
        if self.graphed:
            src = generator if generator is not None else \
                torch.cuda.default_generators[self.dev.index or 0]
            self.gen.set_state(src.get_state())
        ran = 0
        while ran < budget:
            if ran % sampler.STOP_CHECK_EVERY == 0 and int(self.done) >= n_songs:
                break
            if self.graphed:
                self.graph.replay()
                generate_songs_continuous.graph_replays += 1
            else:
                self._body(generator)
            ran += 1
        if src is not None:
            src.set_state(self.gen.get_state())
        generate_songs_continuous.steps_run += ran
        return self.toks[:ran], self.fin[:ran]


_SERVE_LOOPS: "collections.OrderedDict" = collections.OrderedDict()
_SERVE_LOOP_CACHE_SIZE = 4


def _graphed_loop(params: dict, cfg: LinearTransformerConfig, b: int, max_steps: int,
                  settings, barbeat_field: int, bar_token_id: int) -> _ServeLoop:
    """The graphed ``_ServeLoop`` of these weights, batch and step bucket,
    captured at its first use and cached by ``sampler._cached`` (it goes
    with its weights).  The bar target, song count and budget are not part
    of the key: they live in device buffers or on the host."""
    key = (id(params), cfg, b, max_steps, tuple(settings), barbeat_field, bar_token_id,
           decode_state_dtype())
    return sampler._cached(_SERVE_LOOPS, _SERVE_LOOP_CACHE_SIZE, key, params,
                           lambda: _ServeLoop(params, cfg, b, max_steps, settings, barbeat_field,
                                              bar_token_id, fused=True, graph=True))


def _exact_stop(fin: np.ndarray, n_songs: int, budget: int) -> Tuple[int, int]:
    """(steps, songs_done) of the JAX loop from the finish flags (T, B) of
    a loop that may have run past it: it stops after the first step at
    which the running total of finishes reaches n_songs, or at budget."""
    if n_songs <= 0 or budget <= 0:
        return 0, 0
    total = np.cumsum(fin.sum(axis=1))
    hit = np.flatnonzero(total >= n_songs)
    steps = int(hit[0]) + 1 if len(hit) else min(len(fin), budget)
    return steps, int(total[steps - 1]) if steps else 0


def _serve_loop(params: dict, cfg: LinearTransformerConfig,
                generator: Optional[torch.Generator], init_token: torch.Tensor,
                n_songs: int, budget: int, *, bar_cond: int, max_steps: int, settings,
                barbeat_field: int = 2, bar_token_id: int = 1, fused: bool = False,
                graph: Optional[bool] = None):
    """The continuous-batching loop (JAX :57-154).  init_token (B, 1,
    n_fields).  ``graph`` (default: CUDA and ``fused``) replays a captured
    step; ``graph=False`` runs the same body eagerly.

    Returns (toks (T, B, nf), fin (T, B), steps, songs_done): per step the
    emitted token and whether it completed its slot's current song, for the
    T >= steps steps that ran; steps and songs_done are the JAX loop's."""
    b = init_token.shape[0]
    if graph is None:
        graph = fused and init_token.device.type == "cuda"
    if graph and not (fused and init_token.device.type == "cuda"):
        raise ValueError("a graphed serve loop needs the fused step on a CUDA device")
    if graph:
        loop = _graphed_loop(params, cfg, b, max_steps, settings, barbeat_field, bar_token_id)
    else:
        loop = _ServeLoop(params, cfg, b, max_steps, settings, barbeat_field, bar_token_id,
                          fused=fused, graph=False)
    toks, fin = loop.run(init_token[:, 0].to(torch.int32), n_songs, budget, bar_cond, generator)
    toks, fin = toks.cpu().numpy(), fin.cpu().numpy()
    steps, songs_done = _exact_stop(fin, n_songs, budget)
    return toks, fin, steps, songs_done


def generate_songs_continuous(params: dict, cfg: LinearTransformerConfig,
                              generator: Optional[torch.Generator] = None, *,
                              n_songs: int, bar_cond: int = 50, batch: int = 8,
                              max_tokens_per_song: int = 512,
                              settings: Optional[Tuple] = None,
                              init_token=None, barbeat_field: int = 2,
                              bar_token_id: int = 1, fused: Optional[bool] = None,
                              graph: Optional[bool] = None) -> ServeResult:
    """Serve ``n_songs`` of ``bar_cond`` bars each with continuous batching
    over ``batch`` slots (JAX :157-218), on the device of ``params``.

    Each song includes its leading init token (``generate_songs``'
    convention).  ``max_tokens_per_song`` sizes the step budget; the loop
    ends once enough songs are complete.  ``fused=None`` picks kernel A on
    CUDA at an even head count (``sampler.use_fused_decode``; the kernel
    checks its shapes); the JAX rule's batch of 1 or a multiple of 8 is the
    TPU's sublane tile and is dropped.  ``graph`` (default: CUDA and the
    fused step) runs each step as one replay of a cached CUDA graph;
    ``graph=False`` runs the same step eagerly, on the same draws.
    ``generator`` (default: a new one seeded 0) is advanced by the loop's
    draws."""
    settings = tuple(settings if settings is not None else smp.CP_SAMPLING)
    dev = params["in_linear"]["w"].device
    if fused is None:
        fused = sampler.use_fused_decode(dev) and cfg.n_head % 2 == 0
    if generator is None:
        generator = torch.Generator(device=dev)
        generator.manual_seed(0)
    if init_token is None:
        init_token = np.tile(np.asarray([sampler.CP_SEED], np.int32)[None], (batch, 1, 1))
    init_token = torch.as_tensor(init_token, dtype=torch.int32, device=dev)
    # budget: about batch songs per max_tokens_per_song window, plus one
    # window of slack for refill skew; the buffers are bucketed to
    # 1024-step multiples so that requests of varied sizes share a capture
    waves = -(-n_songs // batch) + 1
    budget = waves * max_tokens_per_song
    max_steps = -(-budget // 1024) * 1024
    toks, fin, steps, songs_done = _serve_loop(
        params, cfg, generator, init_token, n_songs, budget, bar_cond=bar_cond,
        max_steps=max_steps, settings=settings, barbeat_field=barbeat_field,
        bar_token_id=bar_token_id, fused=bool(fused), graph=graph)
    toks, fin = np.asarray(toks), np.asarray(fin)
    init_row = init_token[:, 0].cpu().numpy()

    # host assembly: each slot's songs end at its finish flags; completion
    # order is (finishing step, slot); incomplete tails are dropped
    completed = []
    for slot in range(toks.shape[1]):
        start = 0
        for fi in np.flatnonzero(fin[:steps, slot]):
            seg = toks[start:fi + 1, slot]
            completed.append((int(fi), slot, np.concatenate(
                [init_row[slot:slot + 1], seg], axis=0)))
            start = int(fi) + 1
    completed.sort(key=lambda x: (x[0], x[1]))
    songs = [song for _, _, song in completed[:n_songs]]
    return ServeResult(songs=songs, steps=steps, songs_done=int(songs_done))


# graph_captures / graph_replays: the serve loop's captures and replays;
# steps_run: the steps every loop ran, eager or replayed (past the JAX
# loop's stop included)
generate_songs_continuous.graph_captures = 0
generate_songs_continuous.graph_replays = 0
generate_songs_continuous.steps_run = 0


def _prompt_request_result(params: dict, cfg: LinearTransformerConfig,
                           generator: Optional[torch.Generator], init_rows, n_songs: int,
                           bar_cond: int, max_tokens: int) -> ServeResult:
    """A prompt request (JAX :221-235): ``sampler.generate_songs``' prefill
    and bar-stop sampler, the n_songs continuations of one prompt as one
    batch (kernel A below ``persistent_min_batch()`` songs, kernel B from
    there)."""
    gcfg = GenerateConfig(n_songs=n_songs, bar_production=bar_cond, max_tokens=max_tokens,
                          batch_size=n_songs)
    songs = sampler.generate_songs(params, cfg, gcfg, generator=generator, init=init_rows)
    t0 = len(init_rows)
    steps = max((len(s) - t0 for s in songs), default=0)
    return ServeResult(songs=songs, steps=steps, songs_done=len(songs))


def _safe_id(rid: str) -> str:
    """One journal line per id: the line-structure characters escaped
    (deterministic, so dedup compares escaped to escaped)."""
    return rid.replace("\\", "\\\\").replace("\n", "\\n").replace("\r", "\\r")


def serve_requests(params: dict, cfg: LinearTransformerConfig, requests_path: str,
                   on_result, *, batch: int = 8, poll_s: float = 0.5,
                   max_requests: Optional[int] = None,
                   idle_timeout_s: Optional[float] = None,
                   max_tokens_per_song: int = 512, base_seed: int = 0,
                   stop_event=None, prompt_loader=None,
                   journal_path: Optional[str] = None) -> int:
    """Request server over the continuous batcher (JAX :238-387).

    Tails ``requests_path`` (JSON lines, appended by producers):

        {"id": "r1", "songs": 3, "bars": 20, "seed": 7}
        {"id": "r2", "songs": 2, "bars": 30, "prompt": "intro.mid"}
        {"cmd": "shutdown"}

    Prompt requests need ``prompt_loader`` (the request's "prompt" value ->
    (T0, n_fields) int rows; the CLI's CP-encodes a MIDI file) and run
    through ``_prompt_request_result``; the others through
    ``generate_songs_continuous``.  Each request's draws come from a
    ``torch.Generator`` seeded with its "seed" (default base_seed + the
    count served).  ``on_result(request, ServeResult)`` is called for each.

    Stops on a shutdown line, after ``max_requests``, after
    ``idle_timeout_s`` without new work, or when ``stop_event`` (a
    threading.Event, e.g. ``train.pretrain.INTERRUPT`` set by SIGTERM) is
    set.  Returns the number of requests served.

    Restart semantics (``journal_path``, default ``<requests_path>.journal``):
    each served request's id is appended to the journal, flushed and
    fsynced before the next one, and a restarted daemon reads the request
    file from its start, skipping journaled ids, so each request is served
    at least once and twice only if the daemon died inside ``on_result``.
    A request without an "id" gets ``@<byte offset of its line>``, stable
    because the file is append-only and read in binary (a multi-byte UTF-8
    character cannot shift later offsets).  A consumed shutdown line is
    journaled too, so a restarted daemon serves what was appended after it.
    Ids are escaped (backslash, \\n, \\r) before they are journaled."""
    if journal_path is None:
        journal_path = requests_path + ".journal"
    done_ids = set()
    try:
        with open(journal_path, "r") as jf:
            done_ids = {ln.rstrip("\n") for ln in jf if ln.rstrip("\n")}
    except FileNotFoundError:
        pass
    journal = open(journal_path, "a")
    dev = params["in_linear"]["w"].device

    def mark_done(rid: str) -> None:
        journal.write(rid + "\n")
        journal.flush()
        os.fsync(journal.fileno())

    served = 0
    offset = 0
    last_work = time.monotonic()
    try:
        while True:
            if stop_event is not None and stop_event.is_set():
                return served
            if max_requests is not None and served >= max_requests:
                return served
            lines = []          # [(byte offset of the line's start, raw bytes)]
            try:
                with open(requests_path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read()
            except FileNotFoundError:
                chunk = b""
            if chunk:
                # complete lines only (a producer may be mid-append)
                complete, _, _ = chunk.rpartition(b"\n")
                if complete:
                    pos = offset
                    for raw in complete.split(b"\n"):
                        if raw.strip():
                            lines.append((pos, raw))
                        pos += len(raw) + 1
                    offset += len(complete) + 1
            if not lines:
                if idle_timeout_s is not None and time.monotonic() - last_work > idle_timeout_s:
                    return served
                time.sleep(poll_s)
                continue
            for ln_off, raw in lines:
                try:
                    req = json.loads(raw.decode("utf-8"))
                except (UnicodeDecodeError, json.JSONDecodeError):
                    continue
                rid = _safe_id(str(req["id"])) if "id" in req else f"@{ln_off}"
                if rid in done_ids:
                    continue
                if req.get("cmd") == "shutdown":
                    mark_done(rid)
                    done_ids.add(rid)
                    return served
                generator = torch.Generator(device=dev)
                generator.manual_seed(int(req.get("seed", base_seed + served)))
                if req.get("prompt") and prompt_loader is not None:
                    res = _prompt_request_result(
                        params, cfg, generator, prompt_loader(req["prompt"]),
                        int(req.get("songs", 1)), int(req.get("bars", 50)),
                        max_tokens_per_song)
                else:
                    res = generate_songs_continuous(
                        params, cfg, generator, n_songs=int(req.get("songs", 1)),
                        bar_cond=int(req.get("bars", 50)), batch=batch,
                        max_tokens_per_song=max_tokens_per_song)
                on_result(req, res)
                mark_done(rid)
                done_ids.add(rid)
                served += 1
                last_work = time.monotonic()
                if max_requests is not None and served >= max_requests:
                    return served
    finally:
        journal.close()
