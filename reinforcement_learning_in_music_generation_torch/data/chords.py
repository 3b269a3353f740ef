"""Rule-based chord recognition from note streams.

Capability-parity reimplementation of ppo_policy/chord_recognition.py
(MIDIChord): chroma-template scoring over 2- and 4-beat windows with greedy
segmentation.  The musical constant tables (quality templates,
insider/outsider scoring) are the same rules; the implementation is
vectorized numpy over windows rather than per-tick python.

The port's own copy of the JAX package's ``data/chords.py`` (which imports
no JAX): the port imports nothing of that package.  ``tests/test_torch_midi_input.py``
holds its output byte-equal to the original's.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .midifile import notes2pianoroll, tochroma

PITCH_CLASSES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]

# chord quality -> required intervals (chord_recognition.py:9-13)
CHORD_MAPS = {
    "maj": (0, 4),
    "min": (0, 3),
    "dim": (0, 3, 6),
    "aug": (0, 4, 8),
    "dom": (0, 4, 7, 10),
}
# +1 intervals (chord_recognition.py:15-19)
CHORD_INSIDERS = {"maj": (7,), "min": (7,), "dim": (9,), "aug": (), "dom": ()}
# -1 intervals (chord_recognition.py:21-25)
CHORD_OUTSIDERS_1 = {
    "maj": (2, 5, 9), "min": (2, 5, 8), "dim": (2, 5, 10),
    "aug": (2, 5, 9), "dom": (2, 5, 9),
}
# -2 intervals (chord_recognition.py:27-31)
CHORD_OUTSIDERS_2 = {
    "maj": (1, 3, 6, 8, 10), "min": (1, 4, 6, 9, 11), "dim": (1, 4, 7, 8, 11),
    "aug": (1, 3, 6, 7, 10), "dom": (1, 3, 6, 8, 11),
}


def _quality_and_score(sequence: np.ndarray) -> Tuple[str, int]:
    """Decide quality + score for a root-rotated interval set
    (chord_recognition.py:49-87)."""
    seq = set(int(s) for s in sequence)
    if (3 in seq) == (4 in seq):       # neither or both thirds -> no chord
        return "None", -100
    if 3 in seq:
        quality = "dim" if 6 in seq else "min"
    else:
        if 8 in seq:
            quality = "aug"
        elif 7 in seq and 10 in seq:
            quality = "dom"
        else:
            quality = "maj"
    score = 0
    for n in seq - set(CHORD_MAPS[quality]):
        if n in CHORD_OUTSIDERS_1[quality]:
            score -= 1
        elif n in CHORD_OUTSIDERS_2[quality]:
            score -= 2
        elif n in CHORD_INSIDERS[quality]:
            score += 1
    return quality, score


def _find_chord(pianoroll: np.ndarray) -> Tuple[str, str, str, int]:
    """Best (root, quality, bass, score) for a pianoroll window
    (chord_recognition.py:89-123)."""
    chroma = (tochroma(pianoroll).sum(axis=0) > 0).astype(np.int64)
    if chroma.sum() == 0:
        return "N", "N", "N", 0
    scores, qualities = {}, {}
    for root in range(12):
        if not chroma[root]:
            continue
        rotated = np.roll(chroma, -root)
        sequence = np.where(rotated == 1)[0]
        qualities[root], scores[root] = _quality_and_score(sequence)
    # bass = lowest sounding pitch class
    col_any = pianoroll.sum(axis=0) > 0
    bass_note = int(np.where(col_any)[0][0] % 12)
    best = max(scores.values())
    tied = [r for r, s in scores.items() if s == best]
    if len(tied) == 1:
        root = tied[0]
    else:
        root = tied[0]
        for pitch in np.where(col_any)[0]:
            if int(pitch % 12) in tied:
                root = int(pitch % 12)
                break
    return (PITCH_CLASSES[root], qualities[root], PITCH_CLASSES[bass_note],
            scores[root])


def extract_chords(notes, ticks_per_beat: int = 480) -> List[list]:
    """notes -> [[start_tick, end_tick, 'Root:quality[/bass]'], ...]
    (chord_recognition.py:125-188 extract + greedy)."""
    if not notes:
        return []
    max_tick = max(n.end for n in notes)
    roll = notes2pianoroll(notes, max_tick, ticks_per_beat)

    candidates: dict = {}
    for interval in (4, 2):          # longest window wins ties last-in sort
        for start in range(0, int(max_tick), ticks_per_beat):
            end = min(int(max_tick), start + ticks_per_beat * interval)
            root, quality, bass, score = _find_chord(roll[start:end])
            candidates.setdefault(start, {}).setdefault(
                end, (root, quality, bass, score))

    # greedy: best-scoring (then longest) candidate from each start tick
    chords = []
    tick = 0
    while tick < max_tick:
        opts = sorted(candidates[tick].items(),
                      key=lambda kv: (kv[1][-1], kv[0]))
        end, (root, quality, bass, _) = opts[-1]
        name = f"{root}:{quality}" if root == bass else f"{root}:{quality}/{bass}"
        chords.append([tick, end, name])
        tick = end

    # merge/strip ':None' spans (chord_recognition.py:141-155)
    while chords and ":None" in chords[0][2]:
        if len(chords) == 1:
            return []
        chords[1][0] = chords[0][0]
        del chords[0]
    merged = []
    for ch in chords:
        if ":None" not in ch[2]:
            merged.append(ch)
        else:
            merged[-1][1] = ch[1]
    return merged
