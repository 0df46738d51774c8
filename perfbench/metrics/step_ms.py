"""step_ms (ms): the optimize phase over the steps it took (mean over the
window's fits)."""

from perfbench.readers import mean_over_fits


def read(ctx):
    return mean_over_fits(ctx, lambda f: f["timings"]["optimize"] / f["n_iter"] * 1e3)
