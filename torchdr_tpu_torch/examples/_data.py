"""scikit-learn's ``make_moons`` and ``make_swiss_roll`` in numpy.

The same formulas and the same ``RandomState`` draws in the same order
(the shuffle, then the noise), so the rows equal scikit-learn's bit for bit
for the same arguments; the card's machine has no scikit-learn.
"""

from __future__ import annotations

import numpy as np


def make_moons(n_samples: int = 100, *, shuffle: bool = True, noise=None, random_state=None):
    """Two interleaving half circles: X (n, 2) float64 and y (n,) intp."""
    rng = np.random.RandomState(random_state)
    n_out = n_samples // 2
    n_in = n_samples - n_out
    outer_x = np.cos(np.linspace(0, np.pi, n_out))
    outer_y = np.sin(np.linspace(0, np.pi, n_out))
    inner_x = 1 - np.cos(np.linspace(0, np.pi, n_in))
    inner_y = 1 - np.sin(np.linspace(0, np.pi, n_in)) - 0.5
    X = np.vstack([np.append(outer_x, inner_x), np.append(outer_y, inner_y)]).T
    y = np.hstack([np.zeros(n_out, dtype=np.intp), np.ones(n_in, dtype=np.intp)])
    if shuffle:
        order = np.arange(n_samples)
        rng.shuffle(order)
        X, y = X[order], y[order]
    if noise is not None:
        X += rng.normal(scale=noise, size=X.shape)
    return X, y


def make_swiss_roll(n_samples: int = 100, *, noise: float = 0.0, random_state=None):
    """The swiss roll: X (n, 3) float64 and its position t (n,)."""
    rng = np.random.RandomState(random_state)
    t = 1.5 * np.pi * (1 + 2 * rng.uniform(size=n_samples))
    height = 21 * rng.uniform(size=n_samples)
    X = np.vstack((t * np.cos(t), height, t * np.sin(t)))
    X += noise * rng.standard_normal(size=(3, n_samples))
    return X.T, np.squeeze(t)
