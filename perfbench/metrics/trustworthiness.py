"""trustworthiness (ratio): scikit-learn's trustworthiness (k = 15) of the
last fit's embedding on 10,000 rows (all of a smaller cell's) drawn from
the seed, in float64, after the window."""

import numpy as np

from perfbench.reference.quality import trustworthiness

K = 15
ROWS = 10_000


def read(ctx):
    X, Z = ctx["X"], ctx["Z"]
    n = X.shape[0]
    rows = np.sort(np.random.default_rng([ctx["seed"], 2]).choice(n, min(ROWS, n), replace=False))
    return trustworthiness(X[rows], np.asarray(Z)[rows], K, ctx["device"])
