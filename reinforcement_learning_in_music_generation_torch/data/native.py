"""ctypes bindings for the C++ data-loader core (``native/midi_core.cpp`` at
the root of the checkout).

Provides the hot host-side paths (SMF parsing, grid quantization and the
fused tuple-event encoder) as native code, built at first use with g++ and
falling back to the pure-Python implementations in midifile.py / events.py
when no compiler is available or RLMG_NO_NATIVE is set.

The port's own copy of the JAX package's ``data/native.py``: the same C
entry points and Python fallback.  The library is built into
``build/native/`` at the root of the checkout (git ignores ``build/``),
named by a hash of the source and the flags, never into ``native/``, where
the JAX package builds its own.  ``tests/test_torch_corpus_cli.py`` holds
its output equal to the original's.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SOURCE = _ROOT / "native" / "midi_core.cpp"
_BUILD_DIR = _ROOT / "build" / "native"
_CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-shared")
_lib = None
_tried = False


def _lib_path() -> Path:
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_CXX_FLAGS).encode())
    return _BUILD_DIR / f"libmidi_core-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    """The library of this source, compiled unless it is there already
    (into a temporary name first, so that a concurrent loader never sees a
    half-written file)."""
    target = _lib_path()
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        subprocess.run([os.environ.get("CXX", "g++"), *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
                       check=True, capture_output=True)
        os.replace(tmp, target)
    return target


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("RLMG_NO_NATIVE"):
        return None
    try:
        lib = ctypes.CDLL(str(_build()))
        i8, i16, i32, i64, f64 = (ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.POINTER(ctypes.c_int16),
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_double))
        lib.rlmg_parse_midi.restype = ctypes.c_int
        lib.rlmg_parse_midi.argtypes = [
            i8, ctypes.c_int64, i32, i32, i16, i16, i16, ctypes.c_int64, i64,
            i32, f64, ctypes.c_int64, i64, i32]
        lib.rlmg_quantize.restype = None
        lib.rlmg_quantize.argtypes = [i32, i32, ctypes.c_int64, ctypes.c_int32]
        lib.rlmg_encode_tuple.restype = None
        lib.rlmg_encode_tuple.argtypes = [
            i32, i32, i16, i16, ctypes.c_int64, f64, ctypes.c_int64, i32, i32]
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_midi(path: str):
    """Parse an SMF file natively.

    Returns (notes, tempos, ticks_per_beat) where notes is a structured dict
    of arrays {'start','end','pitch','velocity','track'} and tempos is
    {'tick','bpm'}.  None if the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    with open(path, "rb") as f:
        data = np.frombuffer(f.read(), np.uint8)
    max_notes = max(1024, len(data))      # SMF note event is >= 3 bytes
    max_tempos = max(256, len(data) // 4)
    start = np.zeros(max_notes, np.int32)
    end = np.zeros(max_notes, np.int32)
    pitch = np.zeros(max_notes, np.int16)
    vel = np.zeros(max_notes, np.int16)
    track = np.zeros(max_notes, np.int16)
    t_tick = np.zeros(max_tempos, np.int32)
    t_bpm = np.zeros(max_tempos, np.float64)
    n_notes = ctypes.c_int64()
    n_tempos = ctypes.c_int64()
    tpb = ctypes.c_int32()
    rc = lib.rlmg_parse_midi(
        _ptr(data, ctypes.c_uint8), len(data),
        _ptr(start, ctypes.c_int32), _ptr(end, ctypes.c_int32),
        _ptr(pitch, ctypes.c_int16), _ptr(vel, ctypes.c_int16),
        _ptr(track, ctypes.c_int16), max_notes, ctypes.byref(n_notes),
        _ptr(t_tick, ctypes.c_int32), _ptr(t_bpm, ctypes.c_double),
        max_tempos, ctypes.byref(n_tempos), ctypes.byref(tpb))
    if rc != 0:
        raise ValueError(f"{path}: malformed MIDI (rc={rc})")
    n, m = n_notes.value, n_tempos.value
    notes = {"start": start[:n].copy(), "end": end[:n].copy(),
             "pitch": pitch[:n].copy(), "velocity": vel[:n].copy(),
             "track": track[:n].copy()}
    tempos = {"tick": t_tick[:m].copy(), "bpm": t_bpm[:m].copy()}
    return notes, tempos, tpb.value


def quantize(start: np.ndarray, end: np.ndarray, ticks: int = 120
             ) -> Tuple[np.ndarray, np.ndarray]:
    """Grid-snap (in place on copies).  Python fallback when unavailable."""
    start = np.ascontiguousarray(start, np.int32).copy()
    end = np.ascontiguousarray(end, np.int32).copy()
    lib = _load()
    if lib is None:
        snapped = np.round(start / ticks).astype(np.int32) * ticks
        shift = snapped - start
        return start + shift, end + shift
    lib.rlmg_quantize(_ptr(start, ctypes.c_int32), _ptr(end, ctypes.c_int32),
                      len(start), ticks)
    return start, end


def encode_tuple_words(start, end, pitch, vel, beat_bpm) -> Tuple[np.ndarray, np.ndarray]:
    """Fused tuple-event word encoder: -> (words (N,6) int32, bar_index (N,)).

    Requires the native library (use the events.py/tokenizer.py path
    otherwise)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native midi core unavailable")
    start = np.ascontiguousarray(start, np.int32)
    end = np.ascontiguousarray(end, np.int32)
    pitch = np.ascontiguousarray(pitch, np.int16)
    vel = np.ascontiguousarray(vel, np.int16)
    beat_bpm = np.ascontiguousarray(beat_bpm, np.float64)
    n = len(start)
    words = np.zeros((n, 6), np.int32)
    bar_index = np.zeros(n, np.int32)
    lib.rlmg_encode_tuple(
        _ptr(start, ctypes.c_int32), _ptr(end, ctypes.c_int32),
        _ptr(pitch, ctypes.c_int16), _ptr(vel, ctypes.c_int16), n,
        _ptr(beat_bpm, ctypes.c_double), len(beat_bpm),
        _ptr(words, ctypes.c_int32), _ptr(bar_index, ctypes.c_int32))
    return words, bar_index
