"""Process-parallel corpus encoding for the data-preparation CLI.

The reference encodes its 1747-file Pop1K7 corpus strictly sequentially
(prepare_data.py:360-380 walks files one at a time through per-note Python
loops).  Both of this framework's encode pipelines are pure numpy/Python
per file with no shared state, so a process pool gives near-linear
speedup on the host CPUs; results are returned in input order, making the
output byte-identical to the sequential path (tested).

The port's own copy of the JAX package's ``data/parallel_encode.py`` (which imports
no JAX), with spawned rather than forked workers: the port imports nothing of
that package.  ``tests/test_torch_corpus_cli.py``
holds its output byte-equal to the original's.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _cp_encode_one(args) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    path, seq_len, with_chords = args
    from . import cp_tokenizer
    enc = cp_tokenizer.CPEncoder()
    try:
        rows = enc.encode(path, with_chords=with_chords)
    except Exception:
        return None
    if len(rows) < 2:
        return None
    n_fields = rows.shape[1]
    padded = np.zeros((seq_len, n_fields), np.int32)
    m = np.zeros(seq_len, np.float32)
    n = min(len(rows), seq_len)
    padded[:n] = rows[:n]
    m[:n] = 1.0
    return padded, m


def _tuple_extract_one(path: str):
    from . import events
    try:
        tes = events.extract_tuple_events(path)
    except Exception:
        return None
    if not tes:
        return None
    return events.group_by_bar(tes)


def _default_workers() -> int:
    # respect cgroup/affinity limits, not just the nominal core count
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:  # pragma: no cover (non-Linux)
        return os.cpu_count() or 1


def _map(fn, items, workers: Optional[int]):
    workers = workers if workers is not None else _default_workers()
    if workers <= 1 or len(items) <= 1:
        return [fn(i) for i in items]
    # spawned workers: the port's callers run torch's threads, which a
    # forked child would inherit half-held
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        return list(pool.map(fn, items, chunksize=8))


def cp_encode_corpus(midi_paths: Sequence[str], *, seq_len: int,
                     with_chords: bool = True,
                     workers: Optional[int] = None
                     ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """Ordered (padded_rows, mask) lists, skipping failed/short files."""
    results = _map(_cp_encode_one,
                   [(p, seq_len, with_chords) for p in midi_paths], workers)
    xs = [r[0] for r in results if r is not None]
    masks = [r[1] for r in results if r is not None]
    return xs, masks


def tuple_extract_corpus(midi_paths: Sequence[str], *,
                         workers: Optional[int] = None) -> List[list]:
    """Ordered grouped-by-bar tuple events per song, skipping failures."""
    results = _map(_tuple_extract_one, list(midi_paths), workers)
    return [r for r in results if r]
