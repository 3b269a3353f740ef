"""Dictionaries, word encoding and MIDI decode (writers).

Covers D6, D7, D11 of SURVEY §2.1:

  * tuple-event dictionary (ppo_policy/prepare_data.py:239-302): per-field
    event2word/word2event with BOS/EOS/PAD -> class sizes
    [49, 19, 19, 89, 67, 25]
  * compound-word (CP) dictionary compatible with the Pop1K7
    `dictionary.pkl` format the dqn pipeline consumes
    (dqn_policy/agent_pretrain.py:491-502): string tokens like
    'Tempo_120' / 'CONTI' / 0 / 'Bar' / 'Beat_3' / 'Note_Pitch_64', class
    sizes [56, 135, 18, 87, 18, 25] after dropping 'type'
  * MIDI writers: CP decode (dqn_policy/testing-no-type-cp.py:57-122),
    tuple-event decode (prepare_data.py:190-225), REMI decode with prompt
    continuation (ppo_policy/utils.py:212-351)

The port's own copy of the JAX package's ``data/tokenizer.py`` (which imports
no JAX): the port imports nothing of that package.  ``tests/test_torch_corpus_cli.py``
holds its output byte-equal to the original's.
"""

from __future__ import annotations

import pickle
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np

from .events import (
    DEFAULT_DURATION_BINS,
    DEFAULT_FRACTION,
    DEFAULT_RESOLUTION,
    DEFAULT_TEMPO_INTERVALS,
    DEFAULT_VELOCITY_BINS,
    Event,
    GroupEvent,
)
from .midifile import Instrument, Marker, MidiFile, Note, TempoChange

TEMPO_QUANTIZE_STEP = 4  # prepare_data.py:15

BEAT_RESOL = 480
BAR_RESOL = BEAT_RESOL * 4
TICK_RESOL = BEAT_RESOL // 4


# ---------------------------------------------------------------------------
# tuple-event dictionary (PPO side)
# ---------------------------------------------------------------------------

def construct_tuple_dict() -> Tuple[Dict, Dict]:
    """(event2word, word2event) per field (prepare_data.py:239-302).

    Tempo 28..210 step 4; Bar 0..15; Position 0/16..15/16; Pitch 22..107;
    Duration 0..63; Velocity 0..21; plus <BOS>/<EOS>/<PAD> each.
    """
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


def save_dict(dicts: Tuple[Dict, Dict], path: str) -> None:
    with open(path, "wb") as f:
        pickle.dump(list(dicts), f, protocol=pickle.HIGHEST_PROTOCOL)


def load_dict(path: str) -> Tuple[Dict, Dict]:
    with open(path, "rb") as f:
        e2w, w2e = pickle.load(f)
    return e2w, w2e


def tuple_events_to_words(songs_bars: Sequence[Sequence[Sequence[GroupEvent]]],
                          e2w: Dict) -> List[List[List[List[int]]]]:
    """[songs][bars][notes] GroupEvents -> word-id rows
    [tempo, -1(bar placeholder), position, pitch, duration, velocity]
    (prepare_data.py:318-340)."""
    out = []
    for song in songs_bars:
        song_words = []
        for bar in song:
            bar_words = []
            for ev in bar:
                tempo_q = min(max(ev.Tempo - ev.Tempo % TEMPO_QUANTIZE_STEP, 28), 208)
                # NOTE: the velocity-bin index range (0..32, utils.py:7) exceeds
                # the dictionary's Velocity 0..21 (prepare_data.py:277-281) —
                # a latent KeyError in the reference for velocities >= 88.
                # We clip into the dictionary range instead of crashing.
                vel = min(ev.Velocity, 21)
                pitch = min(max(ev.Pitch, 22), 107)
                bar_words.append([
                    e2w["Tempo"][f"Tempo {tempo_q}"],
                    -1,  # bar id assigned per 16-bar chunk later
                    e2w["Position"][f"Position {ev.Position}"],
                    e2w["Pitch"][f"Pitch {pitch}"],
                    e2w["Duration"][f"Duration {min(ev.Duration, 63)}"],
                    e2w["Velocity"][f"Velocity {vel}"],
                ])
            song_words.append(bar_words)
        out.append(song_words)
    return out


# ---------------------------------------------------------------------------
# compound-word (CP) dictionary (DQN side)
# ---------------------------------------------------------------------------

CP_FIELDS = ("tempo", "chord", "bar-beat", "type", "pitch", "duration", "velocity")

_CHORD_QUALITIES = ("+", "/o7", "7", "M", "M7", "m", "m7", "o", "o7", "sus2", "sus4")
_PITCH_CLASSES = ("A", "A#", "B", "C", "C#", "D", "D#", "E", "F", "F#", "G", "G#")


def construct_cp_dict() -> Tuple[Dict, Dict]:
    """CP-style (event2word, word2event) with the Pop1K7 class sizes
    [56, 135, 18, 3, 87, 18, 25] (incl. 'type'; the dqn scripts delete it:
    testing-no-type-cp.py:233-234, agent_pretrain.py:499-502).

    Token string formats follow the decode rules the CP writer expects
    (testing-no-type-cp.py:57-122): 'Tempo_<bpm>', '<root>_<quality>',
    'Bar'/'Beat_<i>', 'Note_Pitch_<p>', 'Note_Duration_<t>',
    'Note_Velocity_<v>', with 0 as the ignore token and 'CONTI' carry-over.
    """
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


# ---------------------------------------------------------------------------
# MIDI writers (decode back to .mid)
# ---------------------------------------------------------------------------

def write_midi_cp(words: np.ndarray, path: str, word2event: Dict) -> MidiFile:
    """CP-token decode (dqn_policy/testing-no-type-cp.py:57-122 no-type
    variant): fields [tempo, chord, bar-beat, pitch, duration, velocity].

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


def tuple_events_to_midi(events: Sequence[GroupEvent], path: str,
                         tick_resolution: int = DEFAULT_RESOLUTION) -> MidiFile:
    """Tuple-event decode (prepare_data.py:190-225).

    Bar strings containing 'NEW' advance the bar counter; Position is a
    fraction string 'i/16'."""
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
        # The reference advances the bar only on 'NEW'-tagged Bar strings
        # (prepare_data.py:202-204), which collapses integer-bar streams
        # into bar 0; we additionally advance whenever the bar id changes.
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
    data_midi.py:24-36)."""
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


def write_midi_remi(words: Sequence[int], word2event: Dict[int, str],
                    path: str, prompt_path: str | None = None) -> MidiFile:
    """REMI flat-token decode with optional 4-bar prompt continuation
    (ppo_policy/utils.py:212-351)."""
    events = []
    for w in words:
        name, value = word2event[w].split("_")
        events.append(Event(name, None, value, None))

    temp_notes, temp_chords, temp_tempos = [], [], []
    for i in range(len(events) - 3):
        ev = events[i]
        if ev.name == "Bar" and i > 0:
            temp_notes.append("Bar")
            temp_chords.append("Bar")
            temp_tempos.append("Bar")
        elif (ev.name == "Position" and events[i + 1].name == "Note Velocity"
              and events[i + 2].name == "Note On"
              and events[i + 3].name == "Note Duration"):
            position = int(ev.value.split("/")[0]) - 1
            velocity = int(DEFAULT_VELOCITY_BINS[int(events[i + 1].value)])
            pitch = int(events[i + 2].value)
            duration = int(DEFAULT_DURATION_BINS[int(events[i + 3].value)])
            temp_notes.append([position, velocity, pitch, duration])
        elif ev.name == "Position" and events[i + 1].name == "Chord":
            temp_chords.append([int(ev.value.split("/")[0]) - 1, events[i + 1].value])
        elif (ev.name == "Position" and events[i + 1].name == "Tempo Class"
              and events[i + 2].name == "Tempo Value"):
            position = int(ev.value.split("/")[0]) - 1
            cls = events[i + 1].value
            base = {"slow": DEFAULT_TEMPO_INTERVALS[0].start,
                    "mid": DEFAULT_TEMPO_INTERVALS[1].start,
                    "fast": DEFAULT_TEMPO_INTERVALS[2].start}[cls]
            temp_tempos.append([position, base + int(events[i + 2].value)])

    ticks_per_bar = DEFAULT_RESOLUTION * 4

    def timed(seq):
        out, bar = [], 0
        for entry in seq:
            if entry == "Bar":
                bar += 1
            else:
                position = entry[0]
                flags = np.linspace(bar * ticks_per_bar, (bar + 1) * ticks_per_bar,
                                    DEFAULT_FRACTION, endpoint=False, dtype=int)
                out.append([int(flags[position])] + list(entry[1:]))
        return out

    notes = [Note(v, p, st, st + d) for st, v, p, d in timed(temp_notes)]
    chords = timed(temp_chords)
    tempos = timed(temp_tempos)

    if prompt_path:
        midi = MidiFile(prompt_path)
        last_time = DEFAULT_RESOLUTION * 4 * 4
        for n in notes:
            n.start += last_time
            n.end += last_time
        if midi.instruments:
            midi.instruments[0].notes.extend(notes)
        else:
            midi.instruments.append(Instrument(0, notes=notes))
        kept = [t for t in midi.tempo_changes if t.time < last_time]
        kept += [TempoChange(bpm, st + last_time) for st, bpm in tempos]
        midi.tempo_changes = kept
        midi.markers.extend(Marker(c[1], c[0] + last_time) for c in chords)
    else:
        midi = MidiFile()
        midi.ticks_per_beat = DEFAULT_RESOLUTION
        midi.instruments.append(Instrument(0, notes=notes))
        midi.tempo_changes = [TempoChange(bpm, st) for st, bpm in tempos] or [TempoChange(120, 0)]
        midi.markers.extend(Marker(c[1], c[0]) for c in chords)
    midi.dump(path)
    return midi
