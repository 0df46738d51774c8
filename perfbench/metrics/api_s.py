"""api_s (s): a fit's wall time less its affinity, init and optimize
phases: input checks and deduplication, the copy to the device, the float32
context, the result's copy back (mean over the window's fits)."""

from perfbench.readers import mean_over_fits


def read(ctx):
    return mean_over_fits(ctx, lambda f: f["wall_s"] - sum(
        f["timings"][p] for p in ("affinity", "init", "optimize")))
