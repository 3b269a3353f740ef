"""Logging and checkpoints of the port (counterpart of the JAX package's
``utils``), and the stream its CUDA graphs are captured on.  Exports what
the JAX package's ``utils`` does; ``save_checkpoint_orbax``,
``load_checkpoint_orbax`` and ``wait_for_checkpoints`` keep JAX's names for
the port's own sharded, asynchronous format (``checkpoint.py``; orbax is
not used)."""

from . import expio
from .checkpoint import (load_checkpoint, load_checkpoint_orbax, load_params_lenient,
                         save_checkpoint, save_checkpoint_orbax, wait_for_checkpoints)
from .metrics import RuntimeStats, profile_trace, summarize_trace
from .plotting import (bi_loss_plot, curve_plot, make_loss_report, score_plotting,
                       tri_loss_plot)
from .saver import MetricsBus, Saver, loss_bucket_filename

__all__ = [
    "expio",
    "load_checkpoint", "load_checkpoint_orbax", "load_params_lenient",
    "save_checkpoint", "save_checkpoint_orbax", "wait_for_checkpoints",
    "RuntimeStats", "profile_trace", "summarize_trace",
    "bi_loss_plot", "curve_plot", "make_loss_report", "score_plotting",
    "tri_loss_plot",
    "MetricsBus", "Saver", "loss_bucket_filename",
]
