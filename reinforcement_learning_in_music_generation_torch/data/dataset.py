"""Dataset construction: windowing, padding/masking, packing, loaders.

Covers D8-D10 of SURVEY §2.1:

  * `prepare_data_for_training` — 16-bar sliding windows, per-field PAD,
    shuffle (ppo_policy/prepare_data.py:383-438)
  * `process_data` — pad/truncate to MaxSeqLen with 0/1 mask, shuffle,
    split halves -> {'train_x','train_y','mask'} (ppo_policy/preprocess.py)
  * `load_cp_npz` — the precomputed Pop1K7 CP dataset consumed by the DQN
    pipeline, with the 'type' column dropped
    (dqn_policy/agent_pretrain.py:491-531, IRL_dqn_train.py:417-434)
  * `synthetic_cp_dataset` — structured random CP data so every pipeline is
    runnable/benchmarkable without the external Google-Drive datasets

The port's own copy of the JAX package's ``data/dataset.py`` (which imports
no JAX): the port imports nothing of that package.  ``tests/test_torch_corpus_cli.py``
holds its output byte-equal to the original's.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# PPO-side datasets
# ---------------------------------------------------------------------------

def prepare_data_for_training(worded_songs: Sequence, e2w: Dict, *,
                              is_train: bool = True, n_step_bars: int = 16,
                              n_bars_per_x: int = 16, max_len: int = 512,
                              seed: Optional[int] = 0) -> np.ndarray:
    """[songs][bars][notes][6] word rows -> (N, max_len, 6) windows.

    Bar field (index 1) is assigned the in-window bar index 0..15;
    windows longer than max_len are dropped; train windows are padded with
    the per-field <PAD> id and shuffled (prepare_data.py:383-438)."""
    pad_word = [e2w[etype][f"{etype} <PAD>"] for etype in e2w]
    xs: List[List[List[int]]] = []
    for song in worded_songs:
        for start in range(0, len(song) - n_bars_per_x + 1, n_step_bars):
            window = song[start:start + n_bars_per_x]
            rows: List[List[int]] = []
            for bar_idx, bar in enumerate(window):
                for note in bar:
                    row = list(note)
                    row[1] = bar_idx
                    rows.append(row)
            if len(rows) > max_len:
                continue
            if is_train:
                while len(rows) < max_len:
                    rows.append(list(pad_word))
            xs.append(rows)
    if not xs:
        return np.zeros((0, max_len, len(pad_word)), np.int32)
    if is_train:
        arr = np.asarray(xs, np.int32)
        if seed is not None:
            np.random.default_rng(seed).shuffle(arr, axis=0)
        return arr
    return np.asarray(xs, dtype=object)


def process_data(worded_flat: Sequence, max_seq_len: int = 1200, *,
                 seed: Optional[int] = 0) -> Dict[str, np.ndarray]:
    """Flat per-song token rows -> padded/truncated halves
    {'train_x','train_y','mask'} (ppo_policy/preprocess.py:10-72)."""
    data, masks = [], []
    n_fields = len(worded_flat[0][0]) if worded_flat else 6
    pad_word = [0] * n_fields
    for song in worded_flat:
        rows = [list(r) for r in song]
        mask = [1] * len(rows)
        if len(rows) <= max_seq_len:
            while len(rows) < max_seq_len:
                rows.append(list(pad_word))
                mask.append(0)
        else:
            rows = rows[:max_seq_len]
            mask = mask[:max_seq_len]
        data.append(rows)
        masks.append(mask)
    data = np.asarray(data, np.int32)
    masks = np.asarray(masks, np.float32)
    if seed is not None:
        idx = np.arange(len(data))
        np.random.default_rng(seed).shuffle(idx)
        data, masks = data[idx], masks[idx]
    half = len(data) // 2
    return {
        "train_x": data[:half],
        "train_y": data[half:2 * half],
        "mask": masks[:half],
    }


def split_data(data_file: str, *, seed: Optional[int] = 0,
               test_frac: float = 0.1) -> Tuple[int, int]:
    """90/10 train/test split of a worded-data pickle
    (ppo_policy/prepare_data.py:443-464): loads `data_file` (either the
    packed ``{'train': ...}`` dict or a raw song list), shuffles, and
    writes ``worded_data_train.pickle`` / ``worded_data_test.pickle`` next
    to it.  The reference seeds its shuffle from an external
    ``shuffle_order.pickle`` then re-shuffles randomly; here the order is
    a seeded rng (seed=None for nondeterministic).  Returns
    (n_train, n_test)."""
    import os
    dirname = os.path.dirname(data_file)
    with open(data_file, "rb") as handle:
        data = pickle.load(handle)
    if isinstance(data, dict):
        data = data["train"]
    n_data = len(data)
    n_test = n_data // 10 if test_frac == 0.1 else int(n_data * test_frac)
    n_train = n_data - n_test
    index = np.arange(n_data)
    np.random.default_rng(seed).shuffle(index)
    # index the python list directly: np.asarray(data, dtype=object) on a
    # uniformly-shaped corpus builds a multi-dim object ndarray, so the
    # pickles would hold numpy sub-arrays instead of the reference's
    # lists-of-lists
    data = [data[i] for i in index]
    with open(os.path.join(dirname, "worded_data_train.pickle"), "wb") as f:
        pickle.dump(data[:n_train], f, protocol=pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(dirname, "worded_data_test.pickle"), "wb") as f:
        pickle.dump(data[n_train:], f, protocol=pickle.HIGHEST_PROTOCOL)
    return n_train, n_test


def flatten_worded_songs(worded_songs: Sequence) -> List[List[List[int]]]:
    """[songs][bars][notes][6] -> [songs][notes][6] with in-song bar id
    capped at 15 (dictionary Bar range, prepare_data.py:254-257)."""
    out = []
    for song in worded_songs:
        rows = []
        for bar_idx, bar in enumerate(song):
            for note in bar:
                row = list(note)
                row[1] = min(bar_idx, 15)
                rows.append(row)
        if rows:
            out.append(rows)
    return out


# ---------------------------------------------------------------------------
# DQN-side (CP npz) loader
# ---------------------------------------------------------------------------

def load_cp_npz(npz_path: str, dict_path: str, *, drop_type_col: bool = True):
    """Load the Pop1K7 CP dataset: x/y (N, 3584, 7), mask (N, 3584) and the
    7-field dictionary; delete the 'type' column (index 3) to match the
    no-type pipeline (agent_pretrain.py:491-531)."""
    with open(dict_path, "rb") as f:
        event2word, word2event = pickle.load(f)
    data = np.load(npz_path)
    x, y, mask = data["x"], data["y"], data["mask"]
    if drop_type_col:
        x = np.delete(x, 3, axis=2)
        y = np.delete(y, 3, axis=2)
        event2word = {k: v for k, v in event2word.items() if k != "type"}
        word2event = {k: v for k, v in word2event.items() if k != "type"}
    n_class = [len(event2word[k]) for k in event2word]
    return x, y, mask, (event2word, word2event), n_class


# ---------------------------------------------------------------------------
# synthetic data (no external dataset needed)
# ---------------------------------------------------------------------------

def synthetic_cp_dataset(n_songs: int = 16, seq_len: int = 512,
                         n_class: Sequence[int] = (56, 135, 18, 87, 18, 25),
                         seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Structured random CP sequences (bar/beat grammar + random notes) with
    next-token targets and padding masks, shaped like the Pop1K7 npz."""
    rng = np.random.default_rng(seed)
    with_type = len(n_class) == 7   # 7-field variant keeps the 'type' column
    xs = np.zeros((n_songs, seq_len, len(n_class)), np.int64)
    masks = np.zeros((n_songs, seq_len), np.float32)

    def row(tempo=0, chord=0, barbeat=0, typ=0, pitch=0, dur=0, vel=0):
        if with_type:
            return [tempo, chord, barbeat, typ, pitch, dur, vel]
        return [tempo, chord, barbeat, pitch, dur, vel]

    pi, di, vi = (4, 5, 6) if with_type else (3, 4, 5)
    for s in range(n_songs):
        length = int(rng.integers(seq_len // 2, seq_len))
        t = 0
        beat = 0
        while t < length:
            if beat % 8 == 0:
                xs[s, t] = row(barbeat=1, typ=1)              # Bar row
            elif rng.random() < 0.3:
                n_beats = max(1, n_class[2] - 2)
                xs[s, t] = row(tempo=int(rng.integers(0, n_class[0])),
                               chord=int(rng.integers(0, n_class[1])),
                               barbeat=2 + (beat % n_beats), typ=1)  # Beat
            else:
                xs[s, t] = row(typ=2,
                               pitch=int(rng.integers(1, n_class[pi])),
                               dur=int(rng.integers(1, n_class[di])),
                               vel=int(rng.integers(1, n_class[vi])))  # Note
            t += 1
            beat += 1
        masks[s, :length] = 1.0
    ys = np.roll(xs, -1, axis=1)
    ys[:, -1] = 0
    return xs, ys, masks
