"""init_s (s): the embedding's initialisation, ``timings_["init"]`` (mean over
the window's fits)."""

from perfbench.readers import mean_over_fits


def read(ctx):
    return mean_over_fits(ctx, lambda f: f["timings"]["init"])
