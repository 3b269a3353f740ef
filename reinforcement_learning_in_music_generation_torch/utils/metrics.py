"""Per-song generation timings written as ``runtime_stats.json``: the
reference's contract (dqn_policy/testing-no-type-cp.py:213-224), a copy of
the JAX package's ``utils/metrics.py RuntimeStats``.  The JAX module's
profiler helpers (``profile_trace``, ``summarize_trace``) wrap
``jax.profiler`` and have no counterpart here."""

from __future__ import annotations

import json
from typing import List


class RuntimeStats:
    """Collects per-song generation timings and writes runtime_stats.json
    with the reference's keys ('ave token time:' is tokens per second)."""

    def __init__(self):
        self.song_time: List[float] = []
        self.words_len: List[int] = []

    def add_song(self, seconds: float, n_tokens: int) -> None:
        self.song_time.append(float(seconds))
        self.words_len.append(int(n_tokens))

    @property
    def tokens_per_sec(self) -> float:
        total = sum(self.song_time)
        return sum(self.words_len) / total if total > 0 else 0.0

    @property
    def ave_song_time(self) -> float:
        return sum(self.song_time) / len(self.song_time) if self.song_time else 0.0

    def dump(self, path: str = "runtime_stats.json") -> dict:
        result = {
            "song_time": self.song_time,
            "words_len_list": self.words_len,
            "ave token time:": self.tokens_per_sec,
            "ave song time": self.ave_song_time,
        }
        with open(path, "w") as f:
            json.dump(result, f)
        return result
