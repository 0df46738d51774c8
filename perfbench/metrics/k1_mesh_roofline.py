"""k1_mesh_roofline (%): K1 on a mesh, where each launch computes one
shard's rows against the whole shared sample. K1's least time on an H100
(``perfbench/roofline/k1.py``) at a shard's shape (n / chips rows, S, d)
over its mean device time a launch in the traced fit, summed over every
card (its kernels' device time over the launches
``fused_shared_repulsion.launches`` counted). None where the fit did not
launch K1 once a shard a step (a program that runs the step on one card)."""

import types

from perfbench.readers import mean_over_fits, roofline_percent
from perfbench.roofline import k1

COUNTERS = {"k1": k1.COUNTER}


def read(ctx):
    prof = ctx["profile"]
    chips = ctx["cell"].chips
    n_iter = mean_over_fits(ctx, lambda f: f["n_iter"])
    if prof is None or not n_iter or prof["launches"].get("k1", 0) != chips * n_iter:
        return None
    shard = types.SimpleNamespace(
        __name__="k1", KERNELS=k1.KERNELS,
        shape_bound_ms=lambda s: k1.bound_ms(s["n"] / chips, s["S"], s["d"]))
    return roofline_percent(ctx, shard)
