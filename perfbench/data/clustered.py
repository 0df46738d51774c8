"""Gaussian clusters: the rows every cell of the benchmark fits.

A frozen copy of ``make_clustered`` in ``torchdr_tpu_torch/benchmarks/ivf_recall.py``
(``perfbench/tests/test_perfbench_copies.py`` holds the two equal), which
every earlier record of the port made its data with: ``clusters`` centres
N(0, ``scale``²) in ``d`` dimensions, each row a centre drawn uniformly plus
unit noise, component j of each row then scaled by (j + 1)^-``decay``. It
imports nothing of the program.
"""

from __future__ import annotations

import numpy as np


def make_clustered(n: int, d: int, n_clusters: int = 50, decay: float = 0.0, seed: int = 0,
                   scale: float = 4.0):
    """n x d float32 rows and their cluster labels, from ``seed``."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=scale, size=(n_clusters, d)).astype(np.float32)
    labels = rng.integers(0, n_clusters, n)
    X = centers[labels] + rng.standard_normal((n, d), dtype=np.float32)
    if decay:
        X *= (np.arange(1, d + 1, dtype=np.float32) ** -decay)[None, :]
    return X, labels


def make(params: dict, seed: int) -> np.ndarray:
    """The rows of a traffic file's ``data`` parameters, as the host float32
    array a user hands to ``fit_transform``."""
    X, _ = make_clustered(int(params["n"]), int(params["d"]), int(params["clusters"]),
                          float(params.get("decay", 0.0)), seed,
                          float(params.get("scale", 4.0)))
    return X
