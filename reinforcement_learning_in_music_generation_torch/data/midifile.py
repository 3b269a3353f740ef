"""Self-contained Standard MIDI File reader/writer.

The reference leans on `miditoolkit` (requirements.txt:27) for all MIDI
parse/dump (ppo_policy/utils.py:29-75,219-351, dqn_policy/
testing-no-type-cp.py:57-122).  That package is not available here, so this
module implements the needed subset of SMF 0/1 directly: notes per track,
tempo changes, markers, program changes, ticks-per-beat — the exact surface
the tokenizers and writers touch.

Container API mirrors miditoolkit's so the tokenizer code reads naturally.

The port's own copy of the JAX package's ``data/midifile.py`` (which imports
no JAX): the port imports nothing of that package.  ``tests/test_torch_midi_input.py``
holds its output byte-equal to the original's.
"""

from __future__ import annotations

import dataclasses
import struct
from typing import List, Optional


@dataclasses.dataclass
class Note:
    velocity: int
    pitch: int
    start: int
    end: int

    def __repr__(self):
        return (f"Note(start={self.start}, end={self.end}, "
                f"pitch={self.pitch}, velocity={self.velocity})")


@dataclasses.dataclass
class TempoChange:
    tempo: float    # BPM
    time: int


@dataclasses.dataclass
class Marker:
    text: str
    time: int


@dataclasses.dataclass
class TimeSignature:
    numerator: int
    denominator: int
    time: int


@dataclasses.dataclass
class Instrument:
    program: int = 0
    is_drum: bool = False
    name: str = ""
    notes: List[Note] = dataclasses.field(default_factory=list)


class MidiFile:
    """Minimal miditoolkit.midi.parser.MidiFile equivalent."""

    def __init__(self, filename: Optional[str] = None):
        self.ticks_per_beat: int = 480
        self.instruments: List[Instrument] = []
        self.tempo_changes: List[TempoChange] = []
        self.markers: List[Marker] = []
        self.time_signature_changes: List[TimeSignature] = []
        if filename is not None:
            self._parse(filename)

    # -- reading -----------------------------------------------------------

    def _parse(self, path: str) -> None:
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"MThd":
            raise ValueError(f"{path}: not a MIDI file")
        hlen, fmt, ntracks, division = struct.unpack(">IHHH", data[4:14])
        if division & 0x8000:
            raise ValueError("SMPTE time division not supported")
        self.ticks_per_beat = division
        pos = 8 + hlen
        for _ in range(ntracks):
            if data[pos:pos + 4] != b"MTrk":
                # skip unknown chunk
                clen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
                pos += 8 + clen
                continue
            tlen = struct.unpack(">I", data[pos + 4:pos + 8])[0]
            self._parse_track(data[pos + 8:pos + 8 + tlen])
            pos += 8 + tlen
        if not self.tempo_changes:
            self.tempo_changes = [TempoChange(120.0, 0)]
        self.tempo_changes.sort(key=lambda t: t.time)

    def _parse_track(self, buf: bytes) -> None:
        pos = 0
        tick = 0
        status = 0
        active: dict = {}          # (channel, pitch) -> list of (start, vel)
        notes: dict = {}           # channel -> List[Note] (format-0 files
        #                            carry several channels in one MTrk;
        #                            miditoolkit splits instruments per
        #                            channel — so do we)
        programs: dict = {}
        name = ""

        def read_varint():
            nonlocal pos
            val = 0
            while True:
                b = buf[pos]
                pos += 1
                val = (val << 7) | (b & 0x7F)
                if not b & 0x80:
                    return val

        def close_note(ch, pitch, end_tick):
            stack = active.get((ch, pitch))
            if stack:
                start, vel = stack.pop(0)
                if end_tick > start:
                    notes.setdefault(ch, []).append(
                        Note(vel, pitch, start, end_tick))

        while pos < len(buf):
            tick += read_varint()
            b = buf[pos]
            if b & 0x80:
                status = b
                pos += 1
            ev = status & 0xF0
            ch = status & 0x0F
            if status == 0xFF:
                mtype = buf[pos]
                pos += 1
                mlen = read_varint()
                mdata = buf[pos:pos + mlen]
                pos += mlen
                if mtype == 0x51 and mlen == 3:
                    uspq = (mdata[0] << 16) | (mdata[1] << 8) | mdata[2]
                    self.tempo_changes.append(TempoChange(60e6 / uspq, tick))
                elif mtype == 0x06:
                    self.markers.append(Marker(mdata.decode("latin-1"), tick))
                elif mtype == 0x03:
                    name = mdata.decode("latin-1", "ignore")
                elif mtype == 0x58 and mlen >= 2:
                    self.time_signature_changes.append(
                        TimeSignature(mdata[0], 2 ** mdata[1], tick))
            elif status in (0xF0, 0xF7):
                slen = read_varint()
                pos += slen
            elif ev == 0x90:
                pitch, vel = buf[pos], buf[pos + 1]
                pos += 2
                if vel > 0:
                    active.setdefault((ch, pitch), []).append((tick, vel))
                else:
                    close_note(ch, pitch, tick)
            elif ev == 0x80:
                pitch = buf[pos]
                pos += 2
                close_note(ch, pitch, tick)
            elif ev == 0xC0:
                programs[ch] = buf[pos]
                pos += 1
            elif ev == 0xD0:
                pos += 1
            elif ev in (0xA0, 0xB0, 0xE0):
                pos += 2
            else:
                raise ValueError(f"bad MIDI event status 0x{status:02x}")

        # close any dangling notes at track end
        for (ch, pitch), stack in active.items():
            for start, vel in stack:
                if tick > start:
                    notes.setdefault(ch, []).append(Note(vel, pitch, start, tick))
        for ch in sorted(notes):
            ch_notes = notes[ch]
            ch_notes.sort(key=lambda n: (n.start, n.pitch))
            self.instruments.append(
                Instrument(programs.get(ch, 0), ch == 9, name, ch_notes))

    # -- writing -----------------------------------------------------------

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

    @property
    def max_tick(self) -> int:
        ticks = [n.end for inst in self.instruments for n in inst.notes]
        return max(ticks) if ticks else 0


# ---------------------------------------------------------------------------
# pianoroll helpers (miditoolkit.pianoroll equivalents used by chords)
# ---------------------------------------------------------------------------

def notes2pianoroll(notes, max_tick: int, ticks_per_beat: int):
    """(max_tick, 128) velocity roll (miditoolkit.pianoroll.parser)."""
    import numpy as np
    roll = np.zeros((int(max_tick), 128), dtype=np.int32)
    for n in notes:
        s, e = int(n.start), int(n.end)
        if e > s and 0 <= n.pitch < 128:
            roll[s:e, n.pitch] = max(1, int(n.velocity))
    return roll


def tochroma(pianoroll):
    """(T, 128) -> (T, 12) chroma (miditoolkit.pianoroll.utils)."""
    import numpy as np
    t = pianoroll.shape[0]
    chroma = np.zeros((t, 12), dtype=np.int64)
    for c in range(12):
        chroma[:, c] = pianoroll[:, c::12].sum(axis=1)
    return chroma
