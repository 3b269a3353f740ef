"""Experiment-file helpers (ppo_policy/utils_file.py equivalents): seeding,
config and result logs, prediction CSV I/O.  A copy of the JAX package's
``utils/expio.py``; the files it writes are the same bytes."""

from __future__ import annotations

import csv
import os
import random
from typing import List, Sequence, Tuple

import numpy as np
import torch


def set_seed(seed: int) -> None:
    """Seed the host RNGs (utils_file.py:10-20): numpy's, Python's and, as
    the JAX package has no counterpart for it, torch's default generators
    (``torch.manual_seed``: the CPU one and every card's).  The port's
    dropout and sampling draw from the explicit generators their callers
    pass, which this does not touch."""
    np.random.seed(seed)
    random.seed(seed)
    torch.manual_seed(seed)


def write_config_log(logfile_path: str, purpose: str, model_type, epochs: int,
                     batch_size: int, lr: float, **extra) -> None:
    """Config log file (utils_file.py:22-30)."""
    os.makedirs(os.path.dirname(logfile_path) or ".", exist_ok=True)
    with open(logfile_path, "w") as f:
        f.write(f"Purpose         = {purpose}\n")
        f.write(f"Model Type      = {model_type}\n")
        f.write(f"Num epochs      = {epochs}\n")
        f.write(f"Batch size      = {batch_size}\n")
        f.write(f"Learning rate   = {lr}\n")
        for k, v in extra.items():
            f.write(f"{k:15s} = {v}\n")


def write_result_log(logfile_path: str, epoch: int, epoch_num: int,
                     epoch_time: float, train_acc: float, val_acc: float,
                     train_loss: float, val_loss: float,
                     is_better: bool) -> None:
    """Per-epoch result line (utils_file.py:33-40)."""
    with open(logfile_path, "a") as f:
        f.write(f"[{epoch + 1}/{epoch_num}] {epoch_time:.2f} sec(s) "
                f"Train Acc: {train_acc:.5f} | Val Acc: {val_acc:.5f} | "
                f"Train Loss: {train_loss:.5f} | Val Loss: {val_loss:.5f}")
        if is_better:
            f.write(" -> val best (acc)")
        f.write("\n")


def write_csv(output_path: str, rows: Sequence[Tuple[str, str]],
              header: Sequence[str] = ("filename", "label")) -> None:
    """Prediction CSV writer (utils_file.py:43-52)."""
    if os.path.dirname(output_path):
        os.makedirs(os.path.dirname(output_path), exist_ok=True)
    with open(output_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(list(header))
        for row in rows:
            writer.writerow(list(row))


def read_csv(filepath: str) -> Tuple[List[str], List[int]]:
    """Prediction CSV reader (utils_file.py:55-63)."""
    with open(filepath, newline="") as f:
        data = list(csv.reader(f))[1:]
    return [r[0] for r in data], [int(r[1]) for r in data]
