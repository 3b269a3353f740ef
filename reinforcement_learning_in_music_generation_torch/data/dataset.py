"""CP dataset loaders: the counterpart of the JAX package's
``data/dataset.py`` (``load_cp_npz`` and ``synthetic_cp_dataset``), in
numpy only, so one seed gives the JAX package's arrays exactly.

  * ``load_cp_npz`` -- the precomputed Pop1K7 CP dataset consumed by the DQN
    pipeline, with the 'type' column dropped
    (dqn_policy/agent_pretrain.py:491-531, IRL_dqn_train.py:417-434)
  * ``synthetic_cp_dataset`` -- structured random CP data, so pretraining
    runs without the external datasets
"""

from __future__ import annotations

import pickle
from typing import Sequence, Tuple

import numpy as np


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
