"""The port's MIDI input pipeline against the JAX package's, on MIDI bytes
the test writes itself (the raw SMF writer of
``tests/test_midifile_conformance.py``): notes on several tracks, tempo
changes, markers, a time signature, running status, note-on with velocity
0, a drum channel, an unknown chunk.  The reader's fields, the pianoroll and
chroma, the chords, the items and the CP encoder's rows must equal the JAX
package's, rows byte for byte.  (``generate --prompt`` and ``serve``'s
prompt requests read a MIDI file through these.)"""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_corpus_pipeline import write_corpus  # noqa: E402
from test_midifile_conformance import smf, tempo_ev, track, vlq  # noqa: E402

from reinforcement_learning_in_music_generation_torch.data import chords as tch  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import cp_tokenizer as tcp  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import events as tev  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import midifile as tmf  # noqa: E402
from reinforcement_learning_in_music_generation_torch.data import tokenizer as ttok  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import chords as jch  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import cp_tokenizer as jcp  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import events as jev  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import midifile as jmf  # noqa: E402
from reinforcement_learning_in_music_generation_tpu.data import tokenizer as jtok  # noqa: E402


def _song_format1() -> bytes:
    """Conductor (tempo 100 -> 132 -> 76, 3/4 then 4/4, markers) and three
    tracks: chords under running status closed by velocity-0 note-ons, a
    bass line with explicit note-offs, drums on channel 9."""
    cond = (tempo_ev(0, 100.0)
            + vlq(0) + b"\xff\x58\x04" + bytes([3, 2, 24, 8])
            + vlq(0) + b"\xff\x06" + vlq(5) + b"Intro"
            + tempo_ev(1920, 132.0)
            + vlq(0) + b"\xff\x58\x04" + bytes([4, 2, 24, 8])
            + vlq(1920) + b"\xff\x06" + vlq(6) + b"Chorus"
            + tempo_ev(1920, 76.0))
    keys = bytearray(vlq(0) + bytes([0xC0, 0]))
    progression = [(60, 64, 67), (57, 60, 64), (62, 65, 69), (55, 59, 62, 65),
                   (60, 63, 67), (59, 62, 65, 68), (60, 64, 68), (53, 57, 60)]
    for i, chord in enumerate(progression):
        keys += vlq(0 if i == 0 else 120) + bytes([0x90, chord[0], 90])
        for p in chord[1:]:
            keys += vlq(0) + bytes([p, 70 + p % 20])          # running status
        keys += vlq(840) + bytes([chord[0], 0])               # velocity-0 offs
        for p in chord[1:]:
            keys += vlq(0) + bytes([p, 0])
    bass = bytearray(vlq(0) + bytes([0xC1, 33]))
    for i in range(16):
        p = (36, 33, 38, 31)[i % 4]
        bass += vlq(0 if i == 0 else 240) + bytes([0x91, p, 100 - 3 * i])
        bass += vlq(240 + 60 * (i % 3)) + bytes([0x81, p, 0])
        bass += vlq(0) + bytes([0xB1, 7, 90])                 # a controller
    drums = bytearray()
    for i in range(32):
        drums += vlq(0 if i == 0 else 240) + bytes([0x99, (36, 38, 42)[i % 3], 110])
        drums += vlq(240) + bytes([0x89, (36, 38, 42)[i % 3], 0])
    junk = b"XFIH" + (4).to_bytes(4, "big") + b"\x00" * 4
    return smf(1, [track(cond), track(bytes(keys)), track(bytes(bass)), track(bytes(drums))]) + junk


def _song_format0() -> bytes:
    """One format-0 track with two channels, running status, a marker, a
    tempo change mid-bar and a note still sounding at the end."""
    ev = bytearray(tempo_ev(0, 90.0) + vlq(0) + b"\xff\x06" + vlq(3) + b"C:M")
    ev += vlq(0) + bytes([0xC0, 5]) + vlq(0) + bytes([0xC1, 40])
    t = 0
    for i in range(24):
        ev += vlq(0 if i == 0 else 120) + bytes([0x90, 48 + (i * 5) % 30, 60 + i])
        ev += vlq(0) + bytes([0x91, 72 - i % 7, 80])
        if i == 10:
            ev += tempo_ev(0, 150.0)
        ev += vlq(360) + bytes([0x80, 48 + (i * 5) % 30, 0]) + vlq(0) + bytes([0x81, 72 - i % 7, 0])
        t += 480
    ev += vlq(0) + bytes([0x90, 64, 77]) + vlq(960) + bytes([0xB0, 64, 0])   # left open
    return smf(0, [track(bytes(ev))], division=240)


@pytest.fixture(scope="module")
def midis(tmp_path_factory):
    root = tmp_path_factory.mktemp("midi_input")
    paths = []
    for name, data in (("f1.mid", _song_format1()), ("f0.mid", _song_format0())):
        (root / name).write_bytes(data)
        paths.append(str(root / name))
    write_corpus(str(root / "corpus"), n_songs=4, seed=3)
    paths += sorted(str(p) for p in (root / "corpus").iterdir())
    return paths


CASES = range(6)


def _notes(notes):
    return [(n.start, n.end, n.pitch, n.velocity) for n in notes]


def _midi_fields(m):
    return (m.ticks_per_beat,
            [(i.program, i.is_drum, i.name, _notes(i.notes)) for i in m.instruments],
            [(t.tempo, t.time) for t in m.tempo_changes],
            [(k.text, k.time) for k in m.markers],
            [(s.numerator, s.denominator, s.time) for s in m.time_signature_changes],
            m.max_tick)


def _items(items):
    return [(i.name, i.start, i.end, i.velocity, i.pitch) for i in items]


def _bytes_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("case", CASES)
def test_midifile_reader_matches_jax(midis, case):
    ours, ref = _midi_fields(tmf.MidiFile(midis[case])), _midi_fields(jmf.MidiFile(midis[case]))
    assert ours == ref
    assert ref[1] and ref[2]


def test_the_files_cover_the_corner_cases(midis):
    m = jmf.MidiFile(midis[0])
    assert len(m.tempo_changes) == 3 and len(m.markers) == 2
    assert [s.numerator for s in m.time_signature_changes] == [3, 4]
    assert [i.is_drum for i in m.instruments] == [False, False, True]
    assert jmf.MidiFile(midis[1]).ticks_per_beat == 240


def test_midifile_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.mid"
    bad.write_bytes(b"RIFF....")
    smpte = tmp_path / "smpte.mid"
    smpte.write_bytes(b"MThd" + (6).to_bytes(4, "big") + b"\x00\x00\x00\x01\xe7\x28")
    for path in (bad, smpte):
        with pytest.raises(ValueError) as ours:
            tmf.MidiFile(str(path))
        with pytest.raises(ValueError) as ref:
            jmf.MidiFile(str(path))
        assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("case", CASES)
def test_pianoroll_and_chroma_match_jax(midis, case):
    m = jmf.MidiFile(midis[case])
    notes = [n for i in m.instruments for n in i.notes]
    roll = tmf.notes2pianoroll(notes, m.max_tick, m.ticks_per_beat)
    _bytes_equal(roll, jmf.notes2pianoroll(notes, m.max_tick, m.ticks_per_beat))
    _bytes_equal(tmf.tochroma(roll), jmf.tochroma(roll))


@pytest.mark.parametrize("case", CASES)
def test_chords_match_jax(midis, case):
    notes = jev.quantize_items([n for t in jev.read_items(midis[case])[0] for n in t])
    ours, ref = tch.extract_chords(notes), jch.extract_chords(notes)
    assert ours == ref
    if case == 0:
        assert len(ref) >= 4          # the progression is recognised
    roll = jmf.tochroma(jmf.notes2pianoroll(notes, max(n.end for n in notes), 480))[:960]
    assert tch._find_chord(roll) == jch._find_chord(roll)
    assert tch._quality_and_score(roll.sum(0)) == jch._quality_and_score(roll.sum(0))


@pytest.mark.parametrize("case", CASES)
def test_read_and_quantize_items_match_jax(midis, case):
    (tnotes, ttempo), (jnotes, jtempo) = tev.read_items(midis[case]), jev.read_items(midis[case])
    assert [_items(t) for t in tnotes] == [_items(t) for t in jnotes]
    assert _items(ttempo) == _items(jtempo)
    flat = [n for t in jnotes for n in t]
    for ticks in (120, 60):
        assert _items(tev.quantize_items(flat, ticks)) == _items(jev.quantize_items(flat, ticks))
    assert repr(tev.Item("Note", 0, 1, 2, 3)) == repr(jev.Item("Note", 0, 1, 2, 3))
    assert repr(tev.Event("Bar", 0, 1, "x")) == repr(jev.Event("Bar", 0, 1, "x"))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("has_type", [True, False])
@pytest.mark.parametrize("with_chords", [True, False])
def test_cp_encoder_rows_match_jax(midis, case, has_type, with_chords):
    tdict, jdict = ttok.construct_cp_dict(), jtok.construct_cp_dict()
    if not has_type:
        tdict, jdict = ttok.drop_type(tdict), jtok.drop_type(jdict)
    ours = tcp.CPEncoder(tdict).encode(midis[case], with_chords=with_chords)
    ref = jcp.CPEncoder(jdict).encode(midis[case], with_chords=with_chords)
    assert ref.shape[0] > 0 and ref.shape[1] == (7 if has_type else 6)
    _bytes_equal(ours, ref)


def test_cp_encoder_field_ids_match_jax():
    ours, ref = tcp.CPEncoder(), jcp.CPEncoder()
    for v in (0, 31.5, 33, 120, 150.2, 224, 400):
        assert ours.tempo_id(v) == ref.tempo_id(v)
    for v in (0, 59, 61, 600, 5000):
        assert ours.duration_id(v) == ref.duration_id(v)
    for v in (0, 41, 42, 127):
        assert ours.velocity_id(v) == ref.velocity_id(v)
    for p in (0, 22, 64, 107, 127):
        assert ours.pitch_id(p) == ref.pitch_id(p)
    for name in (None, "N", "C:maj", "A#:min", "E:dim", "G:aug", "D:dom", "B:sus4", "X:q"):
        assert ours.chord_id(name) == ref.chord_id(name)
    e2w = jtok.construct_cp_dict()[0]
    for prefix, field in (("Tempo_", "tempo"), ("Note_Duration_", "duration")):
        for v in (0, 95, 333, 1e6):
            assert (tcp._nearest_token_id(e2w[field], prefix, v)
                    == jcp._nearest_token_id(e2w[field], prefix, v))


def test_cli_prompt_rows_are_the_jax_prompt(midis):
    """``generate --prompt`` and ``serve``'s prompt loader: the CP rows with
    the 'type' column dropped, as the JAX CLI's."""
    from reinforcement_learning_in_music_generation_torch.apps import cli
    _bytes_equal(cli._prompt_rows(midis[0]), np.delete(jcp.CPEncoder().encode(midis[0]), 3, 1))
