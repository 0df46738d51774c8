"""Visualization helpers (counterpart of ``torchdr_tpu/utils/visu.py``).

``matplotlib`` is imported when a plot is made, not with the module.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def plot_poincare_disk(Z, labels=None, ax=None, disk_color="lightgrey", **scatter_kwargs):
    """Scatter a hyperbolic (Poincaré-ball) embedding inside the unit disk.

    Parameters
    ----------
    Z : (n, 2) array or tensor on any device — embedding on the Poincaré
        ball (e.g. COSNE output); a tensor is moved to the host once.
    labels : optional per-point labels used for coloring.
    ax : optional matplotlib axes.
    """
    import matplotlib.pyplot as plt

    Z = _host(Z)
    if Z.shape[1] != 2:
        raise ValueError("[TorchDR-TPU] plot_poincare_disk requires a 2D embedding.")
    if ax is None:
        _, ax = plt.subplots(figsize=(6, 6))
    circle = plt.Circle((0, 0), 1.0, color=disk_color, fill=True, alpha=0.4, zorder=0)
    ax.add_patch(circle)
    boundary = plt.Circle((0, 0), 1.0, color="black", fill=False, lw=1.0, zorder=1)
    ax.add_patch(boundary)
    ax.scatter(
        Z[:, 0], Z[:, 1], c=None if labels is None else _host(labels),
        s=scatter_kwargs.pop("s", 8), zorder=2, **scatter_kwargs,
    )
    ax.set_xlim(-1.05, 1.05)
    ax.set_ylim(-1.05, 1.05)
    ax.set_aspect("equal")
    ax.axis("off")
    return ax
