"""fit_s (s): the summed wall time of the window's fits over their number,
each timed on the host clock around ``fit_transform``, which returns a host
array."""

from perfbench.readers import mean_over_fits


def read(ctx):
    return mean_over_fits(ctx, lambda f: f["wall_s"])
