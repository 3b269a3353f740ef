"""Experiment logging, the reference's ``Saver`` contract: the counterpart
of the JAX package's ``utils/saver.py``.

``exp_dir/log.txt`` lines of ``key | val | step | time``
(dqn_policy/saving.py:158-241), a global step counter, and a metrics bus
fanning out to the log file, wandb when installed, and an in-memory
history.
"""

from __future__ import annotations

import os
import time
from typing import Optional


class Saver:
    """Logfile-format-compatible Saver (dqn_policy/saving.py:158-241)."""

    def __init__(self, exp_dir: str, mode: str = "w"):
        self.exp_dir = exp_dir
        self.init_time = time.time()
        self.global_step = 0
        os.makedirs(exp_dir, exist_ok=True)
        self._path = os.path.join(exp_dir, "log.txt")
        self._fh = open(self._path, mode)

    def add_summary_msg(self, msg: str) -> None:
        self._fh.write(f"{msg}\n")
        self._fh.flush()

    def add_summary(self, key: str, val, step: Optional[int] = None,
                    cur_time: Optional[float] = None) -> None:
        if cur_time is None:
            cur_time = time.time() - self.init_time
        if step is None:
            step = self.global_step
        if isinstance(val, float):
            msg = f"{key:10s} | {val:.10f} | {step:10d} | {cur_time}"
        else:
            msg = f"{key:10s} | {val} | {step:10d} | {cur_time}"
        self._fh.write(msg + "\n")
        self._fh.flush()

    def global_step_increment(self) -> None:
        self.global_step += 1

    def close(self) -> None:
        self._fh.close()


class QuietSaver(Saver):
    """A ``Saver`` that counts the steps and writes nothing: the saver of a
    rank other than 0 of a dp mesh (rank 0 logs)."""

    def __init__(self):                 # opens no file
        self.exp_dir, self.global_step, self.init_time = None, 0, time.time()

    def add_summary_msg(self, msg: str) -> None:
        pass

    def add_summary(self, *args, **kwargs) -> None:
        pass

    def close(self) -> None:
        pass


class MetricsBus:
    """One metrics bus fanning out to the log file, wandb if installed and
    an in-memory history, in place of the reference's four logging paths."""

    def __init__(self, saver: Optional[Saver] = None, use_wandb: bool = False):
        self.saver = saver
        self.history: dict = {}
        self._wandb = None
        if use_wandb:
            try:  # optional dependency
                import wandb
            except ImportError:
                wandb = None
            if wandb is not None:
                wandb.init(project="rlmg-torch")
                self._wandb = wandb

    def log(self, metrics: dict, step: Optional[int] = None) -> None:
        if step is None:
            step = (self.saver.global_step if self.saver
                    else len(self.history.get("_steps", [])))
        self.history.setdefault("_steps", []).append(step)
        for k, v in metrics.items():
            v = float(v)
            self.history.setdefault(k, []).append(v)
            if self.saver is not None:
                self.saver.add_summary(k, v, step=step)
        if self._wandb is not None:
            self._wandb.log(metrics, step=step)

    def save_file(self, path: str) -> None:
        """Upload an artifact (a checkpoint) to the live wandb run, as the
        reference wandb.save()s its best DQN checkpoint
        (dqn_policy/IRL_dqn_train.py:370); without wandb, nothing."""
        if self._wandb is not None:
            self._wandb.save(path)


def loss_bucket_filename(loss: float) -> Optional[str]:
    """Loss-bucketed checkpoint names (agent_pretrain.py:594-632):
    0.4<l<=0.8 -> trainloss_<int(l*10)*10>; 0.05<l<=0.4 -> trainloss_<int(l*100)>;
    l<=0.05 -> None (early stop); else trainloss_<int(l*100)>_high."""
    if 0.4 < loss <= 0.8:
        return f"trainloss_{int(loss * 10) * 10}"
    if 0.05 < loss <= 0.40:
        return f"trainloss_{int(loss * 100)}"
    if loss <= 0.05:
        return None
    return f"trainloss_{int(loss * 100)}_high"
