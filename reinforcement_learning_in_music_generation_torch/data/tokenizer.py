"""Dictionaries and MIDI decode (own copy of the JAX package's
``data/tokenizer.py`` CP and tuple-event halves).

  * CP dictionary compatible with the Pop1K7 ``dictionary.pkl`` format:
    class sizes [56, 135, 18, 87, 18, 25] after dropping 'type'
  * CP decode to .mid (dqn_policy/testing-no-type-cp.py:57-122)
  * tuple-event dictionary (ppo_policy/prepare_data.py:239-302): class
    sizes [49, 19, 19, 89, 67, 25], and the tuple-event decode to .mid
    (prepare_data.py:190-225) that PPO's ``inference`` writes
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .events import DEFAULT_DURATION_BINS, DEFAULT_RESOLUTION, DEFAULT_VELOCITY_BINS, GroupEvent
from .midifile import Instrument, Marker, MidiFile, Note, TempoChange

TEMPO_QUANTIZE_STEP = 4  # prepare_data.py:15

BEAT_RESOL = 480
BAR_RESOL = BEAT_RESOL * 4
TICK_RESOL = BEAT_RESOL // 4

_CHORD_QUALITIES = ("+", "/o7", "7", "M", "M7", "m", "m7", "o", "o7", "sus2", "sus4")
_PITCH_CLASSES = ("A", "A#", "B", "C", "C#", "D", "D#", "E", "F", "F#", "G", "G#")


def construct_cp_dict() -> Tuple[Dict, Dict]:
    """CP-style (event2word, word2event) with the Pop1K7 class sizes
    [56, 135, 18, 3, 87, 18, 25] (incl. 'type', which generation drops)."""
    event2word: Dict[str, Dict] = {}
    tempos = [int(t) for t in np.linspace(32, 224, 54, dtype=int)]
    chords = [f"{r}_{q}" for r in _PITCH_CLASSES for q in _CHORD_QUALITIES]
    specs = {
        "tempo": [0, "CONTI"] + [f"Tempo_{t}" for t in tempos],
        "chord": [0, "CONTI", "N_N"] + chords,
        "bar-beat": [0, "Bar"] + [f"Beat_{i}" for i in range(16)],
        "type": ["EOS", "Metrical", "Note"],
        "pitch": [0] + [f"Note_Pitch_{p}" for p in range(22, 108)],
        "duration": [0] + [f"Note_Duration_{d}" for d in range(60, 1021, 60)],
        "velocity": [0] + [f"Note_Velocity_{v}" for v in range(40, 136, 4)],
    }
    for field, tokens in specs.items():
        event2word[field] = {tok: i for i, tok in enumerate(tokens)}
    word2event = {f: {i: t for t, i in m.items()} for f, m in event2word.items()}
    return event2word, word2event


def drop_type(dictionary: Tuple[Dict, Dict]) -> Tuple[Dict, Dict]:
    """del event2word['type'] (testing-no-type-cp.py:233-234)."""
    e2w = {k: v for k, v in dictionary[0].items() if k != "type"}
    w2e = {k: v for k, v in dictionary[1].items() if k != "type"}
    return e2w, w2e


def n_classes(e2w: Dict) -> List[int]:
    return [len(v) for v in e2w.values()]


def write_midi_cp(words: np.ndarray, path: str, word2event: Dict) -> MidiFile:
    """CP-token decode, fields [tempo, chord, bar-beat, pitch, duration,
    velocity].

    Rules: a row is a Note iff pitch/duration/velocity decode to strings;
    'Bar' advances the bar counter; 'Beat_i' sets the position and flushes
    pending chord marker / tempo change; duration 0 -> 60 ticks.
    """
    midi = MidiFile()
    midi.ticks_per_beat = BEAT_RESOL
    class_keys = list(word2event.keys())
    bar_cnt = 0
    cur_pos = 0
    notes: List[Note] = []
    for row in np.asarray(words):
        vals = [word2event[k].get(int(row[i]), 0) for i, k in enumerate(class_keys)]
        is_note = all(isinstance(v, str) for v in (vals[3], vals[4], vals[5]))
        if not is_note:
            if vals[2] == "Bar":
                bar_cnt += 1
            elif isinstance(vals[2], str) and "Beat" in vals[2]:
                beat_pos = int(vals[2].split("_")[1])
                cur_pos = bar_cnt * BAR_RESOL + beat_pos * TICK_RESOL
                if vals[1] not in ("CONTI", 0):
                    midi.markers.append(Marker(str(vals[1]), cur_pos))
                if vals[0] not in ("CONTI", 0):
                    tempo = int(str(vals[0]).split("_")[-1])
                    midi.tempo_changes.append(TempoChange(tempo, cur_pos))
        else:
            try:
                pitch = int(vals[3].split("_")[-1])
                duration = int(vals[4].split("_")[-1])
                velocity = int(vals[5].split("_")[-1])
                if duration == 0:
                    duration = 60
                notes.append(Note(velocity, pitch, cur_pos, cur_pos + duration))
            except (ValueError, IndexError):
                continue
    track = Instrument(0, is_drum=False, name="piano")
    track.notes = notes
    midi.instruments = [track]
    if not midi.tempo_changes:
        midi.tempo_changes.append(TempoChange(120, 0))
    midi.dump(path)
    return midi


# -- tuple-event dictionary (PPO side) -------------------------------------------

def construct_tuple_dict() -> Tuple[Dict, Dict]:
    """(event2word, word2event) per field (prepare_data.py:239-302): Tempo
    28..210 step 4; Bar 0..15; Position 0/16..15/16; Pitch 22..107;
    Duration 0..63; Velocity 0..21; plus <BOS>/<EOS>/<PAD> each."""
    event2word: Dict[str, Dict[str, int]] = {}
    word2event: Dict[str, Dict[int, str]] = {}
    specs = {
        "Tempo": [f"Tempo {i}" for i in range(28, 211, TEMPO_QUANTIZE_STEP)],
        "Bar": [f"Bar {i}" for i in range(16)],
        "Position": [f"Position {i}/16" for i in range(16)],
        "Pitch": [f"Pitch {i}" for i in range(22, 108)],
        "Duration": [f"Duration {i}" for i in range(64)],
        "Velocity": [f"Velocity {i}" for i in range(22)],
    }
    for etype, names in specs.items():
        e2w = {name: i for i, name in enumerate(names)}
        for suffix in ("<BOS>", "<EOS>", "<PAD>"):
            e2w[f"{etype} {suffix}"] = len(e2w)
        event2word[etype] = e2w
        word2event[etype] = {v: k for k, v in e2w.items()}
    return event2word, word2event


def tuple_events_to_midi(events: Sequence[GroupEvent], path: str,
                         tick_resolution: int = DEFAULT_RESOLUTION) -> MidiFile:
    """Tuple-event decode (prepare_data.py:190-225).  Bar strings holding
    'NEW' advance the bar counter, as does any change of the bar id (the
    JAX package's addition: the reference collapses integer-bar streams
    into bar 0); Position is a fraction string 'i/16'."""
    midi = MidiFile()
    midi.ticks_per_beat = tick_resolution
    ticks_per_bar = tick_resolution * 4
    notes: List[Note] = []
    tempo_changes: List[TempoChange] = []
    prev_tempo = None
    prev_bar = None
    bar_cnt = 0
    for e in events:
        velocity = int(DEFAULT_VELOCITY_BINS[e.Velocity])
        if isinstance(e.Bar, str) and "NEW" in e.Bar:
            bar_cnt += 1
        elif prev_bar is not None and e.Bar != prev_bar:
            bar_cnt += 1
        prev_bar = e.Bar
        st = int(bar_cnt * ticks_per_bar + Fraction(e.Position) * ticks_per_bar)
        et = st + int(DEFAULT_DURATION_BINS[e.Duration])
        notes.append(Note(velocity, e.Pitch, st, et))
        if e.Tempo != prev_tempo:
            prev_tempo = e.Tempo
            tempo_changes.append(TempoChange(e.Tempo, st))
    track = Instrument(0, is_drum=False)
    track.notes = notes
    midi.instruments.append(track)
    midi.tempo_changes = tempo_changes or [TempoChange(120, 0)]
    midi.dump(path)
    return midi


def words_to_tuple_events(rows: np.ndarray, word2event: Dict) -> List[GroupEvent]:
    """Tuple word rows -> GroupEvents (ppo_policy/inference.py:22-34 to_midi,
    data_midi.py:24-36); special tokens decode to the defaults Tempo 120,
    Position 0/16, Pitch 60, Duration 0, Velocity 0."""
    events = []
    etypes = list(word2event.keys())
    for row in np.asarray(rows):
        decoded = [word2event[et][int(row[i])] for i, et in enumerate(etypes)]
        parts = [d.split(" ")[1] for d in decoded]
        events.append(GroupEvent(
            Tempo=int(parts[0]) if parts[0].isdigit() else 120,
            Bar=parts[1],
            Position=parts[2] if "/" in parts[2] else "0/16",
            Pitch=int(parts[3]) if parts[3].isdigit() else 60,
            Duration=int(parts[4]) if parts[4].isdigit() else 0,
            Velocity=int(parts[5]) if parts[5].isdigit() else 0,
        ))
    return events
