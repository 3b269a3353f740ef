"""MIDI -> compound-word (CP) encoder.

The reference's DQN pipeline consumes a *precomputed* CP dataset
(`train_data_linear.npz` from YatingMusic, dqn_policy/agent_pretrain.py:39-41)
and ships no encoder.  This module completes the loop: it encodes raw MIDI
into the same CP row format the decoder (tokenizer.write_midi_cp /
dqn_policy/testing-no-type-cp.py:57-122) expects:

  row = [tempo, chord, bar-beat, (type,) pitch, duration, velocity]

  * Metrical rows: 'Bar' rows and 'Beat_i' rows carrying tempo (CONTI when
    unchanged) and chord (from the rule-based recognizer) — type 'Metrical'.
  * Note rows: pitch/duration/velocity with zero metrical fields — 'Note'.
  * A terminal EOS row (type field only) when `with_type`.

Quantization follows the framework's CP dictionary (tokenizer.construct_cp_dict):
tempo bins linspace(32,224,54), duration bins 60..1020 step 60, velocity
bins 40..132 step 4, pitch 22..107, 16 beats/bar at 120-tick resolution.

The port's own copy of the JAX package's ``data/cp_tokenizer.py`` (which imports
no JAX): the port imports nothing of that package.  ``tests/test_torch_midi_input.py``
holds its output byte-equal to the original's.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from . import chords as chord_mod
from . import events as ev
from .tokenizer import BAR_RESOL, TICK_RESOL, construct_cp_dict

# chords.py quality names -> CP dictionary quality suffixes
_QUALITY_MAP = {"maj": "M", "min": "m", "dim": "o", "aug": "+", "dom": "7"}


def _nearest_token_id(e2w_field: Dict, prefix: str, value: float) -> int:
    """Token id of the numerically nearest '<prefix>_<num>' entry."""
    best, best_d = 0, float("inf")
    for tok, idx in e2w_field.items():
        if isinstance(tok, str) and tok.startswith(prefix):
            num = int(tok.split("_")[-1])
            d = abs(num - value)
            if d < best_d:
                best, best_d = idx, d
    return best


class CPEncoder:
    """Reusable encoder bound to a CP dictionary (with the 'type' field)."""

    def __init__(self, dictionary: Optional[Tuple[Dict, Dict]] = None):
        self.e2w, self.w2e = dictionary or construct_cp_dict()
        self.has_type = "type" in self.e2w
        self.fields = list(self.e2w.keys())
        # precompute numeric lookup tables
        self._tempo_vals = sorted(
            (int(t.split("_")[-1]), i) for t, i in self.e2w["tempo"].items()
            if isinstance(t, str) and t.startswith("Tempo_"))
        self._dur_vals = sorted(
            (int(t.split("_")[-1]), i) for t, i in self.e2w["duration"].items()
            if isinstance(t, str) and t.startswith("Note_Duration_"))
        self._vel_vals = sorted(
            (int(t.split("_")[-1]), i) for t, i in self.e2w["velocity"].items()
            if isinstance(t, str) and t.startswith("Note_Velocity_"))

    # -- field encoders ----------------------------------------------------

    def _nearest(self, table, value):
        arr = np.array([v for v, _ in table])
        return table[int(np.argmin(np.abs(arr - value)))][1]

    def tempo_id(self, bpm: float) -> int:
        return self._nearest(self._tempo_vals, bpm)

    def chord_id(self, name: Optional[str]) -> int:
        if not name or name == "N":
            return self.e2w["chord"].get("N_N", 0)
        root, _, quality = name.partition(":")
        quality = _QUALITY_MAP.get(quality, quality)
        return self.e2w["chord"].get(f"{root}_{quality}", self.e2w["chord"].get("N_N", 0))

    def pitch_id(self, pitch: int) -> int:
        p = min(max(int(pitch), 22), 107)
        return self.e2w["pitch"][f"Note_Pitch_{p}"]

    def duration_id(self, ticks: int) -> int:
        return self._nearest(self._dur_vals, ticks)

    def velocity_id(self, vel: int) -> int:
        return self._nearest(self._vel_vals, vel)

    # -- encoding ----------------------------------------------------------

    def _row(self, tempo=0, chord=0, barbeat=0, typ=0, pitch=0, duration=0,
             velocity=0) -> List[int]:
        if self.has_type:
            return [tempo, chord, barbeat, typ, pitch, duration, velocity]
        return [tempo, chord, barbeat, pitch, duration, velocity]

    def encode(self, path: str, *, with_chords: bool = True) -> np.ndarray:
        """Encode one MIDI file -> (N, 6|7) int32 CP rows."""
        note_tracks, tempo_items = ev.read_items(path)
        notes = ev.quantize_items([n for trk in note_tracks for n in trk])
        if not notes:
            return np.zeros((0, len(self.fields)), np.int32)
        notes.sort(key=lambda n: (n.start, n.pitch))
        max_time = max(n.end for n in notes)

        # tempo per beat (480 ticks), forward-filled
        n_beats = int(max_time // 480) + 1
        beat_bpm = np.full(n_beats, float(tempo_items[0].pitch) if tempo_items else 120.0)
        for it in tempo_items:
            b = int(it.start // 480)
            if b < n_beats:
                beat_bpm[b:] = float(it.pitch)

        # chords per tick-span
        chord_at: Dict[int, str] = {}
        if with_chords:
            for start, end, name in chord_mod.extract_chords(notes):
                for beat in range(int(start // 480), int(np.ceil(end / 480))):
                    chord_at.setdefault(beat, name)

        type_metrical = self.e2w["type"]["Metrical"] if self.has_type else 0
        type_note = self.e2w["type"]["Note"] if self.has_type else 0
        conti_tempo = self.e2w["tempo"].get("CONTI", 0)
        conti_chord = self.e2w["chord"].get("CONTI", 0)
        bar_tok = self.e2w["bar-beat"]["Bar"]

        rows: List[List[int]] = []
        notes_by_pos: Dict[int, List] = {}
        for n in notes:
            notes_by_pos.setdefault(int(n.start), []).append(n)

        n_bars = int(np.ceil(max_time / BAR_RESOL))
        prev_tempo_id = -1
        prev_chord_id = -1
        for bar in range(n_bars):
            rows.append(self._row(barbeat=bar_tok, typ=type_metrical))
            for beat in range(16):
                tick = bar * BAR_RESOL + beat * TICK_RESOL
                here = notes_by_pos.get(tick, [])
                beat_idx = tick // 480
                chord_name = chord_at.get(int(beat_idx))
                tempo_id = self.tempo_id(beat_bpm[min(int(beat_idx), n_beats - 1)])
                chord_id = self.chord_id(chord_name) if chord_name else 0
                changed = (tempo_id != prev_tempo_id or
                           (chord_id and chord_id != prev_chord_id))
                if not here and not changed:
                    continue
                t_tok = tempo_id if tempo_id != prev_tempo_id else conti_tempo
                c_tok = (chord_id if (chord_id and chord_id != prev_chord_id)
                         else (conti_chord if chord_id else 0))
                rows.append(self._row(
                    tempo=t_tok, chord=c_tok,
                    barbeat=self.e2w["bar-beat"][f"Beat_{beat}"],
                    typ=type_metrical))
                prev_tempo_id = tempo_id
                if chord_id:
                    prev_chord_id = chord_id
                for n in here:
                    rows.append(self._row(
                        typ=type_note,
                        pitch=self.pitch_id(n.pitch),
                        duration=self.duration_id(n.end - n.start),
                        velocity=self.velocity_id(n.velocity)))
        if self.has_type:
            rows.append(self._row(typ=self.e2w["type"]["EOS"]))
        return np.asarray(rows, np.int32)


def build_cp_training_data(midi_paths: Sequence[str], *, seq_len: int = 3584,
                           with_type: bool = True, with_chords: bool = True,
                           workers: int | None = 1
                           ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, Tuple[Dict, Dict]]:
    """Encode a corpus into the Pop1K7 npz layout: x/y (N, seq_len, F),
    mask (N, seq_len) — x the rows, y the next-row targets
    (agent_pretrain.py:491-531 consumption format).

    ``workers``: process-pool width (None = all CPUs); output is ordered
    and identical to the sequential encode."""
    enc = CPEncoder()
    from .parallel_encode import cp_encode_corpus
    xs, masks = cp_encode_corpus(midi_paths, seq_len=seq_len,
                                 with_chords=with_chords, workers=workers)
    x = np.stack(xs) if xs else np.zeros((0, seq_len, 7), np.int32)
    y = np.roll(x, -1, axis=1)
    if len(y):
        y[:, -1] = 0
    mask = np.stack(masks) if masks else np.zeros((0, seq_len), np.float32)
    if not with_type and x.shape[-1] == 7:
        x = np.delete(x, 3, axis=2)
        y = np.delete(y, 3, axis=2)
    return x, y, mask, enc.e2w and (enc.e2w, enc.w2e)
