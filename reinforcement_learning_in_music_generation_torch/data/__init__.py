"""Host-side data code: the CP dictionary and the MIDI writer."""
