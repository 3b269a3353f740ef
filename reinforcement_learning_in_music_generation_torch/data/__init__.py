"""Host-side data code: the MIDI reader and writer, chords, events, the
tuple-event and CP tokenizers, the corpus datasets and the native helper."""
