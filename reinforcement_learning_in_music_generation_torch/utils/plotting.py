"""Loss and score plots: the counterpart of the JAX package's
``utils/plotting.py`` (``bi_loss_plot``, ``tri_loss_plot``,
``score_plotting``, ``curve_plot``, the helpers the reference imports but
never defines, dqn_policy/IRL_dqn_train.py:21, AIRL.py:15; and
``make_loss_report``, saving.py:243-289).

They draw with matplotlib when it is installed; without it each prints
one line naming the PNG it did not draw and returns.
"""

from __future__ import annotations

import collections
from typing import Sequence


def _plt(path: str):
    try:
        import matplotlib
    except ImportError:
        print(f"matplotlib is not installed: {path} not drawn")
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _save(plt, fig, path: str) -> None:
    plt.tight_layout()
    plt.savefig(path)
    plt.close(fig)


def bi_loss_plot(first: Sequence[float], second: Sequence[float], third: Sequence[float],
                 names: Sequence[str], path: str) -> None:
    """Three-series loss plot (MSE / CE / global), IRL_dqn_train.py:373-378."""
    plt = _plt(path)
    if plt is None:
        return
    fig = plt.figure(dpi=100)
    for series, name in zip((first, second, third), names):
        plt.plot(series, label=name)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.legend(loc="upper right")
    _save(plt, fig, path)


def tri_loss_plot(expert: Sequence[float], agent: Sequence[float], ce: Sequence[float],
                  total: Sequence[float], names: Sequence[str], path: str) -> None:
    """Discriminator losses (Expert / Agent / CE / Total), AIRL.py:219-223."""
    plt = _plt(path)
    if plt is None:
        return
    fig = plt.figure(dpi=100)
    for series, name in zip((expert, agent, ce, total), names):
        plt.plot(series, label=name)
    plt.xlabel("Update")
    plt.ylabel("Loss")
    plt.legend(loc="upper right")
    _save(plt, fig, path)


def curve_plot(series: dict, path: str, *, xlabel: str = "Epoch",
               ylabel: str = "Value") -> None:
    """Named series over epochs (the discriminator's score separation, in
    place of the reference's wandb panels, IRL_dqn_train.py:393-401)."""
    plt = _plt(path)
    if plt is None:
        return
    fig = plt.figure(dpi=100)
    for name, ys in series.items():
        plt.plot(ys, label=name)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    plt.legend(loc="best")
    _save(plt, fig, path)


def score_plotting(agent_scores: Sequence[float], expert_scores: Sequence[float],
                   path: str) -> None:
    """Agent-vs-expert discriminator score histogram, AIRL.py:225-228."""
    plt = _plt(path)
    if plt is None:
        return
    fig = plt.figure(dpi=100)
    plt.hist(agent_scores, bins=50, alpha=0.6, label="Agent")
    plt.hist(expert_scores, bins=50, alpha=0.6, label="Expert")
    plt.xlabel("Discriminator score")
    plt.ylabel("Count")
    plt.legend(loc="upper right")
    _save(plt, fig, path)


def make_loss_report(path_logfile: str, path_figure: str = "loss.png",
                     dpi: int = 100) -> None:
    """Train / valid loss curves from a Saver logfile (saving.py:254-289):
    each "key | value | step | time" line; other lines are skipped."""
    monitor = collections.defaultdict(list)
    with open(path_logfile) as f:
        for line in f:
            try:
                key, val, step, _ = line.strip().split(" | ")
                monitor[key.strip()].append((float(val), int(step)))
            except ValueError:
                continue
    plt = _plt(path_figure)
    if plt is None:
        return
    fig = plt.figure(dpi=dpi)
    plt.title("training process")
    for key in ("train loss", "valid loss", "epoch loss", "batch loss"):
        if monitor[key]:
            plt.plot([s for _, s in monitor[key]], [v for v, _ in monitor[key]], label=key)
    plt.yscale("log")
    plt.legend(loc="upper right")
    _save(plt, fig, path_figure)
