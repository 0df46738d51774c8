"""device_idle (ratio): 1 - the traced fit's device busy time (the union of
its kernels', copies' and memsets' intervals) over its wall time."""


def read(ctx):
    prof = ctx["profile"]
    if prof is None or prof["wall_s"] <= 0:
        return None
    return 1.0 - prof["busy_s"] / prof["wall_s"]
