"""Logging and checkpoints of the port (counterpart of the JAX package's
``utils``), and the stream its CUDA graphs are captured on.  Exports what
the JAX package's ``utils`` does, but its orbax functions
(``save_checkpoint_orbax``, ``load_checkpoint_orbax``,
``wait_for_checkpoints``): the port's sharded checkpoint format waits for
the parallelism item of ROADMAP Queue 1."""

from . import expio
from .checkpoint import load_checkpoint, load_params_lenient, save_checkpoint
from .metrics import RuntimeStats, profile_trace, summarize_trace
from .plotting import (bi_loss_plot, curve_plot, make_loss_report, score_plotting,
                       tri_loss_plot)
from .saver import MetricsBus, Saver, loss_bucket_filename

__all__ = [
    "expio",
    "load_checkpoint", "load_params_lenient", "save_checkpoint",
    "RuntimeStats", "profile_trace", "summarize_trace",
    "bi_loss_plot", "curve_plot", "make_loss_report", "score_plotting",
    "tri_loss_plot",
    "MetricsBus", "Saver", "loss_bucket_filename",
]
