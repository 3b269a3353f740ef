"""The side stream CUDA graphs are captured on, shared by the token graphs
of ``generate/sampler.py`` and the episode graphs of
``rl/episode_graph.py``."""

from __future__ import annotations

import torch

_CAPTURE_STREAMS: dict = {}


def capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The side stream every graph of ``dev`` is captured on.  PyTorch
    keeps a cuBLAS workspace for each stream that ran a cuBLAS product, for
    the life of the process (32 MiB on an H100), so a new stream a capture
    would leave one behind each time."""
    if dev not in _CAPTURE_STREAMS:
        _CAPTURE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _CAPTURE_STREAMS[dev]
