"""A song's rollout as one CUDA graph replay an episode: the port's
counterpart of the JAX package's jitted ``lax.scan`` over a song's episodes
(``rl/env.py`` :23-62, ``rl/ppo.py`` :77-120).

An ``EpisodeLoop`` holds a rollout's static buffers (the current state, the
song's stacked (episodes, ...) outputs and a device-side episode index that
says where an episode writes them) and runs its ``body``, one episode on
those buffers, ``episodes`` times a song.  On a CPU tensor the body runs
eagerly.  On CUDA the first song runs one episode eagerly on the capture
stream (the lazy set-up: cuBLAS workspaces, kernel attributes) and captures
the body once; every other episode is one replay.  A failed capture or
replay raises: nothing falls back to the eager loop.

The graph reads the weights' live storage, never copies: the optimizers add
their updates in place (``train/optim.py``), so a replay after an update
sees the new weights.  ``cached`` keeps a loop for as long as its weights'
tensors live at the same addresses, keyed by their identities and data
pointers (held weakly: an entry goes when one of its tensors is freed,
and a new tensor or a moved storage builds anew), and by the routes read
at capture (``ROUTE_VARS``), so a knob flipped between calls never replays
another route's graph.

The kernel wrappers count only their eager launches: a call made while a
capture records counts nothing, and a replay does not reach the host.  The
kernels that count their own runs on the card (F's ``kernel_runs``, G's
``ffn_kernel_runs``) count every replay.  ``EpisodeLoop.captures`` counts
graphs captured.
"""

from __future__ import annotations

import collections
import os
import weakref
from typing import Callable, Hashable, List, Sequence, Tuple

import torch

from ..utils.cuda_graph import capture_stream

# the environment knobs the layers read to pick their kernels
ROUTE_VARS = ("RLMG_ATTN_BACKEND", "RLMG_FFN_BACKEND", "RLMG_FFN_MIN_ROWS",
              "RLMG_WINDOW_BACKEND")
_CACHE_SIZE = 8


def routes() -> Tuple:
    return tuple(os.environ.get(v) for v in ROUTE_VARS)


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _leaves(v)]
    return [tree]


class EpisodeLoop:
    """A rollout's buffers (a subclass's) and ``body(trees)``, one episode
    on them with the weights ``trees``; ``run(n, trees)`` runs n episodes,
    eagerly on the CPU, as graph replays on CUDA.  The loop holds none of
    the weights: a replay reads the storage the capture saw."""

    captures = 0

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.graph = None

    def body(self, trees: Sequence[dict]) -> None:
        raise NotImplementedError

    def _capture(self, trees: Sequence[dict]) -> None:
        dev = self.device
        stream = capture_stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream):
            self.body(trees)                # a real episode: it is counted
            graph.capture_begin()
            try:
                self.body(trees)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        self.graph = graph
        EpisodeLoop.captures += 1

    def run(self, n: int, trees: Sequence[dict], graph: bool = True) -> None:
        """n episodes: replays of the loop's graph on CUDA (captured at the
        first call), else, or with ``graph=False``, the eager body."""
        if not graph or self.device.type != "cuda":
            for _ in range(n):
                self.body(trees)
            return
        done = 0
        if self.graph is None and n > 0:
            self._capture(trees)
            done = 1
        for _ in range(done, n):
            self.graph.replay()


_LOOPS: "collections.OrderedDict" = collections.OrderedDict()


def cached(key: Hashable, trees: Sequence[dict], build: Callable[[], EpisodeLoop]) -> EpisodeLoop:
    """``build()``, kept under (key, the trees' tensors' identities and data
    pointers, ``routes()``) while those tensors live; an LRU of 8."""
    leaves = [t for tree in trees for t in _leaves(tree)]
    full = (key, tuple((id(t), t.data_ptr()) for t in leaves), routes())
    hit = _LOOPS.get(full)
    if hit is not None and all(r() is t for r, t in zip(hit[0], leaves)):
        _LOOPS.move_to_end(full)
        return hit[1]
    _LOOPS.pop(full, None)
    while len(_LOOPS) >= _CACHE_SIZE:
        _LOOPS.popitem(last=False)
    value, tag = build(), object()

    def drop(_):
        entry = _LOOPS.get(full)
        if entry is not None and entry[2] is tag:
            del _LOOPS[full]
    _LOOPS[full] = ([weakref.ref(t, drop) for t in leaves], value, tag)
    return value
