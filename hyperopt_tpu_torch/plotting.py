"""Trial-visualisation helpers over the port's ``Trials`` (counterpart
of ``hyperopt_tpu/plotting.py``: ``main_plot_history``,
``main_plot_histogram``, ``main_plot_vars``).  matplotlib is imported
inside each function, so the package does not need it.
"""

from __future__ import annotations

import math

import numpy as np

from .base import STATUS_OK

__all__ = ["main_plot_history", "main_plot_histogram", "main_plot_vars"]


def _ok_losses(trials):
    pairs = [
        (d["tid"], d["result"]["loss"])
        for d in trials.trials
        if d["result"].get("status") == STATUS_OK and d["result"].get("loss") is not None
    ]
    return zip(*pairs) if pairs else ((), ())


def main_plot_history(trials, do_show=False, status_colors=None, title="Loss History"):
    """Scatter of loss vs trial id with the running best overlaid
    (plotting.py sym: main_plot_history)."""
    import matplotlib.pyplot as plt

    tids, losses = _ok_losses(trials)
    fig, ax = plt.subplots()
    ax.scatter(tids, losses, s=12, alpha=0.6, label="trial loss")
    if losses:
        best = np.minimum.accumulate(np.asarray(losses))
        ax.plot(tids, best, color="C1", label="best so far")
    ax.set_xlabel("trial")
    ax.set_ylabel("loss")
    ax.set_title(title)
    ax.legend()
    if do_show:
        plt.show()
    return fig


def main_plot_histogram(trials, do_show=False, title="Loss Histogram"):
    """Histogram of ok-trial losses (plotting.py sym: main_plot_histogram)."""
    import matplotlib.pyplot as plt

    _, losses = _ok_losses(trials)
    fig, ax = plt.subplots()
    ax.hist(np.asarray(losses), bins=min(30, max(3, len(losses) // 3 or 3)))
    ax.set_xlabel("loss")
    ax.set_ylabel("count")
    ax.set_title(title)
    if do_show:
        plt.show()
    return fig


def main_plot_vars(trials, do_show=False, columns=3):
    """Per-hyperparameter scatter of value vs loss, colored by recency
    (plotting.py sym: main_plot_vars)."""
    import matplotlib.pyplot as plt

    samples = {}  # label -> (vals, losses, tids)
    for d in trials.trials:
        result = d["result"]
        if result.get("status") != STATUS_OK or result.get("loss") is None:
            continue
        for label, v in d["misc"]["vals"].items():
            if len(v) != 1:
                continue
            entry = samples.setdefault(label, ([], [], []))
            entry[0].append(v[0])
            entry[1].append(result["loss"])
            entry[2].append(d["tid"])
    labels = sorted(samples)
    if not labels:
        fig, _ = plt.subplots()
        return fig
    rows = math.ceil(len(labels) / columns)
    fig, axes = plt.subplots(rows, columns, figsize=(4 * columns, 3 * rows),
                             squeeze=False)
    for i, label in enumerate(labels):
        ax = axes[i // columns][i % columns]
        vals, losses, tids = samples[label]
        sc = ax.scatter(vals, losses, c=tids, cmap="viridis", s=12)
        ax.set_title(label)
        ax.set_ylabel("loss")
    for j in range(len(labels), rows * columns):
        axes[j // columns][j % columns].axis("off")
    fig.colorbar(sc, ax=axes[-1][-1], label="trial id")
    fig.tight_layout()
    if do_show:
        plt.show()
    return fig
