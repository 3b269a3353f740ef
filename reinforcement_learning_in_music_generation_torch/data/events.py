"""MIDI item/event extraction — the REMI/tuple-event front end.

Reimplements the reference pipeline D1-D5 (SURVEY §2.1) with the exact
quantization tables:

  * `read_items` — notes per track + tempo expanded to every beat
    (ppo_policy/utils.py:29-75)
  * `quantize_items` — snap to 120-tick grid (utils.py:78-89)
  * `group_items` — 1920-tick bars (utils.py:106-117)
  * `item2event` — Bar/Position/Velocity/Pitch/Duration/Tempo events; two
    position conventions: REMI "i+1/16" (utils.py:132-207) and the
    tuple-event "i/16" override (ppo_policy/prepare_data.py:97-174)
  * `events_to_tuple_events` — 6-field GroupEvent tuples
    (prepare_data.py:26-95)

The port's own copy of the JAX package's ``data/events.py`` (which imports
no JAX): the port imports nothing of that package.  ``tests/test_torch_midi_input.py``
holds its output byte-equal to the original's.
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import numpy as np

from . import chords as chord_mod
from .midifile import MidiFile

# quantization tables (ppo_policy/utils.py:7-13)
DEFAULT_VELOCITY_BINS = np.linspace(0, 128, 32 + 1, dtype=int)
DEFAULT_FRACTION = 16
DEFAULT_DURATION_BINS = np.arange(60, 3841, 60, dtype=int)
DEFAULT_TEMPO_INTERVALS = [range(30, 90), range(90, 150), range(150, 210)]
DEFAULT_RESOLUTION = 480

GroupEvent = collections.namedtuple(
    "GroupEvent", ["Tempo", "Bar", "Position", "Pitch", "Duration", "Velocity"])


class Item:
    """General note/tempo/chord container (ppo_policy/utils.py:16-26)."""

    __slots__ = ("name", "start", "end", "velocity", "pitch")

    def __init__(self, name, start, end=None, velocity=None, pitch=None):
        self.name = name
        self.start = start
        self.end = end
        self.velocity = velocity
        self.pitch = pitch

    def __repr__(self):
        return (f"Item(name={self.name}, start={self.start}, end={self.end},"
                f" velocity={self.velocity}, pitch={self.pitch})")


class Event:
    """Named event (ppo_policy/utils.py:120-129)."""

    __slots__ = ("name", "time", "value", "text")

    def __init__(self, name, time, value, text):
        self.name = name
        self.time = time
        self.value = value
        self.text = text

    def __repr__(self):
        return (f"Event(name={self.name}, time={self.time},"
                f" value={self.value}, text={self.text})")


def read_items(path: str):
    """-> (note_items per track, tempo_items expanded to every beat)."""
    midi = MidiFile(path)
    all_notes = []
    for inst in midi.instruments:
        notes = sorted(inst.notes, key=lambda n: (n.start, n.pitch))
        all_notes.append([
            Item("Note", n.start, n.end, n.velocity, n.pitch) for n in notes
        ])
    tempo_raw = sorted(midi.tempo_changes, key=lambda t: t.time)
    if not tempo_raw:
        raise ValueError(f"{path}: no tempo events")
    existing = {int(t.time): int(t.tempo) for t in tempo_raw}
    max_tick = int(tempo_raw[-1].time)
    tempos: List[Item] = []
    for tick in range(0, max_tick + 1, DEFAULT_RESOLUTION):
        bpm = existing.get(tick, tempos[-1].pitch if tempos else int(tempo_raw[0].tempo))
        tempos.append(Item("Tempo", tick, pitch=bpm))
    return all_notes, tempos


def quantize_items(items: List[Item], ticks: int = 120) -> List[Item]:
    """Snap starts (and shift ends) to the grid (utils.py:78-89)."""
    if len(items) == 1 and items[0].start == 0:
        return items
    if not items:
        return items
    # NOTE: utils.py:82 uses arange(0, last_start, ticks), excluding the last
    # note's own start from the grid and shifting it backward when it already
    # sits on the grid; we include the endpoint (the quantization intent).
    grids = np.arange(0, items[-1].start + ticks, ticks, dtype=int)
    starts = np.array([it.start for it in items])
    idx = np.argmin(np.abs(grids[None, :] - starts[:, None]), axis=1)
    shifts = grids[idx] - starts
    for it, sh in zip(items, shifts):
        it.start += int(sh)
        if it.end is not None:
            it.end += int(sh)
    return items


def extract_chord_items(note_items: List[Item]) -> List[Item]:
    """Chord recognizer output as items (utils.py:92-103)."""
    out = []
    for start, end, name in chord_mod.extract_chords(note_items):
        out.append(Item("Chord", start, end, pitch=name.split("/")[0]))
    return out


def group_items(items: List[Item], max_time: int,
                ticks_per_bar: int = DEFAULT_RESOLUTION * 4):
    """Bar grouping (utils.py:106-117)."""
    items = sorted(items, key=lambda x: x.start)
    downbeats = np.arange(0, max_time + ticks_per_bar, ticks_per_bar)
    groups = []
    for db1, db2 in zip(downbeats[:-1], downbeats[1:]):
        insiders = [it for it in items if db1 <= it.start < db2]
        groups.append([int(db1)] + insiders + [int(db2)])
    return groups


def _tempo_events(item: Item) -> List[Event]:
    tempo = item.pitch
    iv = DEFAULT_TEMPO_INTERVALS
    if tempo in iv[0]:
        cls, val = "slow", tempo - iv[0].start
    elif tempo in iv[1]:
        cls, val = "mid", tempo - iv[1].start
    elif tempo in iv[2]:
        cls, val = "fast", tempo - iv[2].start
    elif tempo < iv[0].start:
        cls, val = "slow", 0
    else:
        cls, val = "fast", 59
    return [Event("Tempo Class", item.start, cls, None),
            Event("Tempo Value", item.start, val, None)]


def item2event(groups, *, style: str = "tuple",
               skip_empty_bars: Optional[bool] = None) -> List[Event]:
    """Emit the event stream.

    style="remi": Position "i+1/16", names 'Note Velocity'/'Note On'/
    'Note Duration', empty bars skipped (utils.py:132-207).
    style="tuple": Position "i/16", names 'Velocity'/'Pitch'/'Duration',
    empty bars kept (prepare_data.py:97-174).
    """
    remi = style == "remi"
    if skip_empty_bars is None:
        skip_empty_bars = remi
    vel_name = "Note Velocity" if remi else "Velocity"
    pitch_name = "Note On" if remi else "Pitch"
    dur_name = "Note Duration" if remi else "Duration"
    events: List[Event] = []
    n_downbeat = 0
    for group in groups:
        inner = group[1:-1]
        if skip_empty_bars and "Note" not in [it.name for it in inner]:
            continue
        bar_st, bar_et = group[0], group[-1]
        n_downbeat += 1
        events.append(Event("Bar", None, None, str(n_downbeat)))
        flags = np.linspace(bar_st, bar_et, DEFAULT_FRACTION, endpoint=False)
        for item in inner:
            index = int(np.argmin(np.abs(flags - item.start)))
            pos_val = f"{index + 1}/{DEFAULT_FRACTION}" if remi else f"{index}/{DEFAULT_FRACTION}"
            events.append(Event("Position", item.start, pos_val, str(item.start)))
            if item.name == "Note":
                vel_idx = int(np.searchsorted(DEFAULT_VELOCITY_BINS,
                                              item.velocity, side="right") - 1)
                events.append(Event(vel_name, item.start, vel_idx,
                                    f"{item.velocity}/{DEFAULT_VELOCITY_BINS[vel_idx]}"))
                events.append(Event(pitch_name, item.start, item.pitch, str(item.pitch)))
                duration = item.end - item.start
                didx = int(np.argmin(np.abs(DEFAULT_DURATION_BINS - duration)))
                events.append(Event(dur_name, item.start, didx,
                                    f"{duration}/{DEFAULT_DURATION_BINS[didx]}"))
            elif item.name == "Chord":
                events.append(Event("Chord", item.start, item.pitch, str(item.pitch)))
            elif item.name == "Tempo":
                events.extend(_tempo_events(item))
    return events


def events_to_tuple_events(events: Sequence[Event]) -> List[GroupEvent]:
    """Collapse the stream into 6-field tuples (prepare_data.py:26-95)."""
    out: List[GroupEvent] = []
    note = {"Position": None, "Pitch": None, "Duration": None, "Velocity": None}
    bar_value = None
    tempo = 1
    tempo_class = None
    iv = DEFAULT_TEMPO_INTERVALS
    for ev in events:
        if ev.name == "Bar":
            bar_value = int(ev.text)
        elif ev.name == "Tempo Value":
            tempo = ev.value
        elif ev.name == "Tempo Class":
            tempo_class = ev.value
        elif ev.name in note:
            note[ev.name] = ev.value
        if None not in note.values():
            if tempo_class == "slow":
                bpm = iv[0].start + tempo
            elif tempo_class == "mid":
                bpm = iv[1].start + tempo
            elif tempo_class == "fast":
                bpm = iv[2].start + tempo
            else:
                raise ValueError(f"undefined tempo class: {tempo_class}")
            out.append(GroupEvent(Tempo=bpm, Bar=bar_value, **note))
            note = {k: None for k in note}
    return out


def extract_tuple_events(path: str) -> List[GroupEvent]:
    """Full MIDI -> tuple-event pipeline (prepare_data.py:177-188)."""
    note_tracks, tempo_items = read_items(path)
    notes = quantize_items(note_tracks[0])
    if not notes:
        return []
    max_time = notes[-1].end
    items = tempo_items + notes
    groups = group_items(items, max_time)
    events = item2event(groups, style="tuple")
    return events_to_tuple_events(events)


def extract_remi_events(path: str, *, with_chords: bool = True) -> List[Event]:
    """REMI event pipeline (prepare_data.py:17-24 extract_events)."""
    note_tracks, tempo_items = read_items(path)
    notes = quantize_items([n for trk in note_tracks for n in trk])
    if not notes:
        return []
    max_time = max(n.end for n in notes)
    items: List[Item] = tempo_items + notes
    if with_chords:
        items = items + extract_chord_items(notes)
    groups = group_items(items, max_time)
    return item2event(groups, style="remi")


def group_by_bar(events: Sequence[GroupEvent]) -> List[List[GroupEvent]]:
    """[n_bars][notes] (prepare_data.py:228-237)."""
    grouped: List[List[GroupEvent]] = []
    bar = object()
    for e in events:
        if bar != e.Bar:
            bar = e.Bar
            grouped.append([])
        grouped[-1].append(e)
    return grouped
