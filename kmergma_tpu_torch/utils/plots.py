"""Diagnostic scatter plots for the distance sweeps (the port's copy of
``kmergma_tpu.utils.plots``).

The reference renders mutation-rate diagnostics with Plots.jl (ref KmerGMA.jl
src/DistanceTesting.jl:87-92 ``mutation_plot`` and
StrobemerGMA/MonteCarloBenchmark.jl:2-23); here the sweep functions
(ops/thresholds.py) return the data arrays and this optional helper renders
the same scatter with matplotlib.  The import is deferred, so the package
works without matplotlib installed.
"""

from __future__ import annotations

import numpy as np


def mutation_plot(
    sweep: np.ndarray,
    stepsize: float,
    title: str = "k-mer distance vs mutation rate",
    ylabel: str = "distance to profile",
    save_path: str | None = None,
):
    """Scatter each seed's distance trajectory against mutation rate.

    ``sweep`` is the (num_seeds, n_steps) output of
    substitution_distance_sweep or strobemer_distance_sweep; ``stepsize``
    the rate increment those used.  Returns the matplotlib Figure (saved to
    ``save_path`` when given - use the Agg backend for headless runs).
    """
    import matplotlib

    if save_path is not None:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    rates = np.arange(sweep.shape[1]) * stepsize
    fig, ax = plt.subplots(figsize=(7, 4.5))
    for row in sweep:
        ax.scatter(rates, row, s=6, alpha=0.45, color="#4063d8", linewidths=0)
    mean = sweep.mean(axis=0)
    ax.plot(rates, mean, color="#cb3c33", linewidth=1.5, label="mean")
    ax.set_xlabel("mutation rate")
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend(frameon=False)
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
    return fig
