"""Shared matplotlib-optional precision/recall plotting for the evaluators."""

from __future__ import annotations

import os
from typing import Optional, Sequence


def save_pr_plot(path: str, title: str, curves: Sequence,
                 recalls: Optional[Sequence] = None,
                 labels: Optional[Sequence[str]] = None) -> bool:
    """One PR figure with one line per curve; returns False (no-op) when
    matplotlib is unavailable. ``recalls`` defaults to a uniform [0, 1] grid
    per curve (the KITTI 41-point convention)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False
    import numpy as np

    os.makedirs(os.path.dirname(path), exist_ok=True)
    fig, ax = plt.subplots()
    for i, prec in enumerate(curves):
        rec = (recalls[i] if recalls is not None
               else np.linspace(0.0, 1.0, len(prec)))
        ax.plot(rec, prec, lw=2,
                label=labels[i] if labels is not None else None)
    ax.set_xlim(0.0, 1.0)
    ax.set_ylim(0.0, 1.05)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    ax.set_title(title)
    if labels is not None:
        ax.legend(loc="lower left")
    fig.savefig(path)
    plt.close(fig)
    return True
