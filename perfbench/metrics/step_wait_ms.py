"""step_wait_ms (ms): the optimizer loop's time waiting on the card, its
grad-norm reads at the check steps and each segment's closing synchronise,
``timings_["optimize.wait"]``, over the steps (mean over the window's
fits)."""

from perfbench.spans import mean_of_spans


def read(ctx):
    return mean_of_spans(ctx, ("optimize.wait",),
                         lambda t, f: t["optimize.wait"] / f["n_iter"] * 1e3)
