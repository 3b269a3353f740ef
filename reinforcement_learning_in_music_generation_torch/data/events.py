"""The tuple-event record and the quantisation tables (own copy of the part
of the JAX package's ``data/events.py`` that the tuple-event MIDI decode
reads; the tables are ppo_policy/utils.py:7-13)."""

from __future__ import annotations

import collections

import numpy as np

DEFAULT_VELOCITY_BINS = np.linspace(0, 128, 32 + 1, dtype=int)
DEFAULT_FRACTION = 16
DEFAULT_DURATION_BINS = np.arange(60, 3841, 60, dtype=int)
DEFAULT_TEMPO_INTERVALS = [range(30, 90), range(90, 150), range(150, 210)]
DEFAULT_RESOLUTION = 480

GroupEvent = collections.namedtuple(
    "GroupEvent", ["Tempo", "Bar", "Position", "Pitch", "Duration", "Velocity"])
