"""Per-song generation timings written as ``runtime_stats.json`` (the
reference's contract, dqn_policy/testing-no-type-cp.py:213-224, a copy of
the JAX package's ``utils/metrics.py RuntimeStats``), and the JAX module's
trace hooks on ``torch.profiler``: ``profile_trace`` records a region to a
Chrome trace file, ``summarize_trace`` sums its rows by kind."""

from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import re
import time
from typing import List, Optional, Tuple

import torch


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


# trace categories of the card's own work (kernels, copies, fills), and of
# the host's operators, the rows a CPU-only capture has
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_HOST_CATS = ("cpu_op",)


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """``torch.profiler`` around a region (a no-op when ``log_dir`` is
    None): the host's operators and, where a card is present, its kernels,
    written on exit as ``<log_dir>/<time>-<pid>.trace.json``, which
    ``summarize_trace`` reads."""
    if not log_dir:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    name = f"{time.strftime('%Y%m%d-%H%M%S')}-{os.getpid()}.trace.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


def _kind(name: str) -> str:
    """A row's kind: its name without template arguments, parameters or a
    leading return type (a kernel's instantiations are one kind), and
    without digits and dots, as the JAX function strips fusion indices."""
    base = re.sub(r"^void\s+", "", re.split(r"[<(]", name, maxsplit=1)[0]).strip()
    return re.sub(r"[.\d]+", "", base) or name


def summarize_trace(log_dir: str, top: int = 20,
                    steps: int = 1) -> List[Tuple[str, float, float]]:
    """Time by kind from the newest ``profile_trace`` capture under
    ``log_dir``: [(kind, us_per_step, count_per_step)], the ``top`` kinds
    by time, over the card's rows (kernels, copies, fills) or, in a
    capture without them (no card), the host's operator rows."""
    paths = sorted(glob.glob(os.path.join(log_dir, "**", "*.trace.json*"), recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace.json under {log_dir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
    rows = [e for e in events if e.get("cat") in _DEVICE_CATS]
    if not rows:
        rows = [e for e in events if e.get("cat") in _HOST_CATS]
    by_kind, counts = collections.Counter(), collections.Counter()
    for e in rows:
        kind = _kind(e["name"])
        by_kind[kind] += e.get("dur", 0)
        counts[kind] += 1
    n = max(steps, 1)
    return [(k, us / n, counts[k] / n) for k, us in by_kind.most_common(top)]
