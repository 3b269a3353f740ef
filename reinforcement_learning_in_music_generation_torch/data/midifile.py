"""Standard MIDI File writer (own copy of the JAX package's ``data/midifile.py``
writer half).

The subset the CP decoder needs: notes per track, tempo changes, markers,
program changes and ticks-per-beat, written as SMF type 1.  The container
API mirrors miditoolkit's so the tokenizer code reads naturally, and the
bytes written are identical to the JAX package's writer.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List


@dataclasses.dataclass
class Note:
    velocity: int
    pitch: int
    start: int
    end: int


@dataclasses.dataclass
class TempoChange:
    tempo: float    # BPM
    time: int


@dataclasses.dataclass
class Marker:
    text: str
    time: int


@dataclasses.dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: List[Note] = dataclasses.field(default_factory=list)


class MidiFile:
    """Minimal miditoolkit.midi.parser.MidiFile equivalent (writer only)."""

    def __init__(self):
        self.ticks_per_beat: int = 480
        self.instruments: List[Instrument] = []
        self.tempo_changes: List[TempoChange] = []
        self.markers: List[Marker] = []

    @staticmethod
    def _varint(val: int) -> bytes:
        out = [val & 0x7F]
        val >>= 7
        while val:
            out.append(0x80 | (val & 0x7F))
            val >>= 7
        return bytes(reversed(out))

    def dump(self, path: str) -> None:
        tracks = []

        # conductor track: tempo + markers
        events = []
        for tc in self.tempo_changes:
            uspq = max(1, min(0xFFFFFF, round(60e6 / max(tc.tempo, 1e-6))))
            events.append((int(tc.time), 0,
                           b"\xff\x51\x03" + uspq.to_bytes(3, "big")))
        for mk in self.markers:
            text = mk.text.encode("latin-1", "replace")
            events.append((int(mk.time), 1,
                           b"\xff\x06" + self._varint(len(text)) + text))
        tracks.append(self._encode_track(events))

        for i, inst in enumerate(self.instruments):
            ch = 9 if inst.is_drum else min(i, 15) if i != 9 else 10
            events = [(0, 0, bytes([0xC0 | ch, inst.program & 0x7F]))]
            for n in inst.notes:
                p = max(0, min(127, int(n.pitch)))
                v = max(1, min(127, int(n.velocity)))
                events.append((int(n.start), 2, bytes([0x90 | ch, p, v])))
                events.append((int(n.end), 1, bytes([0x80 | ch, p, 64])))
            tracks.append(self._encode_track(events))

        with open(path, "wb") as f:
            f.write(b"MThd" + struct.pack(">IHHH", 6, 1, len(tracks),
                                          self.ticks_per_beat))
            for t in tracks:
                f.write(b"MTrk" + struct.pack(">I", len(t)) + t)

    def _encode_track(self, events) -> bytes:
        events.sort(key=lambda e: (e[0], e[1]))
        out = bytearray()
        last = 0
        for tick, _, payload in events:
            out += self._varint(max(0, tick - last))
            out += payload
            last = max(last, tick)
        out += self._varint(0) + b"\xff\x2f\x00"
        return bytes(out)
