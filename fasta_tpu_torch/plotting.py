"""Convergence plotting (port of ``fasta_tpu/plotting.py``).

Residual and objective against iteration for the three solver modes, and
each example's solution, drawn from a :class:`FastaResult` (host arrays;
a result's tensors are moved to the host once).  matplotlib is imported
inside the functions, never with the package, with the Agg backend when
no display exists, so headless hosts still write PNGs.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from .solver import FastaResult

__all__ = ["plot_convergence", "plot_solution", "save_comparison_figure"]


def _mpl():
    import matplotlib
    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(a):
    """A tensor or array as a NumPy array on the host (None stays)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return None if a is None else np.asarray(a)


def plot_convergence(results: Dict[str, FastaResult], *,
                     quantity: str = "residuals",
                     title: Optional[str] = None,
                     ax=None, logy: bool = True):
    """Residual, normalized residual or objective against iteration, one
    curve per solver mode (the reference's signature figure)."""
    plt = _mpl()
    if ax is None:
        _, ax = plt.subplots(figsize=(7, 4.5))
    for mode, r in results.items():
        y = _host(getattr(r, quantity))
        if y is None:
            continue
        ax.plot(np.arange(1, y.size + 1), y, label=mode)
    ax.set_xlabel("iteration")
    ax.set_ylabel(quantity.replace("_", " "))
    if logy:
        ax.set_yscale("log")
    if title:
        ax.set_title(title)
    ax.legend()
    ax.grid(True, which="both", alpha=0.3)
    return ax


def plot_solution(problem, result: FastaResult, ax=None):
    """The solution of one example: recovered against true for a vector
    signal, the image pair for a 2-D problem (the problem's ``recover``
    applied on the host)."""
    plt = _mpl()
    x = _host(result.solution)
    if problem.recover is not None:
        x = _host(problem.recover(torch.as_tensor(x)))
    xt = problem.x_true

    if x.ndim == 2:                           # image problems (TV)
        if ax is None:
            _, axes = plt.subplots(1, 2 if xt is not None else 1,
                                   figsize=(9, 4))
            axes = np.atleast_1d(axes)
        else:
            axes = [ax]
        axes[0].imshow(np.real(x), cmap="gray")
        axes[0].set_title(f"{problem.name}: recovered")
        axes[0].axis("off")
        if xt is not None and len(axes) > 1:
            axes[1].imshow(np.real(xt), cmap="gray")
            axes[1].set_title("ground truth")
            axes[1].axis("off")
        return axes

    if ax is None:
        _, ax = plt.subplots(figsize=(7, 4))
    if xt is not None:
        ax.plot(np.real(np.asarray(xt)), "o", ms=3, alpha=0.6,
                label="true")
    ax.plot(np.real(x), ".", ms=2, label="recovered")
    ax.set_title(problem.name)
    ax.legend()
    return ax


def save_comparison_figure(problem, results: Dict[str, FastaResult],
                           path: str):
    """One figure: convergence (residual and objective) and the
    solution."""
    plt = _mpl()
    fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
    plot_convergence(results, quantity="residuals",
                     title=f"{problem.name}: residual", ax=axes[0])
    if any(r.objectives is not None for r in results.values()):
        plot_convergence(results, quantity="objectives",
                         title="objective", ax=axes[1], logy=False)
    plot_solution(problem, next(iter(results.values())), ax=axes[2])
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
