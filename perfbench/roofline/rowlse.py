"""The least time of K2 and K3, the exact row log-sum's forward and backward.

``bound_ms`` is a frozen copy of ``chip_smoke.rowlse_bound_ms``: the larger
of the bytes over the memory rate (Z, and for K3 lse and g, read once; the
output written once) and the float32 operations over the float32 rate. Both
functions are symmetric in the pair, so each of the n(n - 1)/2 unordered
pairs is evaluated once. K2: 3d + 3 per pair and a log per row. K3: 6d + 4
per pair for student (gaussian one fewer) and d + 3 per row. Each exp, log
and divide counts as one operation.
"""

from __future__ import annotations

from .peaks import least_ms


def bound_ms(n: int, d: int, which: str, kernel: str) -> tuple:
    pairs = n * (n - 1) // 2
    if which == "K2":
        bytes_moved = 4 * n * d + 4 * n
        ops = pairs * (3 * d + 3) + n
    else:
        bytes_moved = 4 * n * d + 8 * n + 4 * n * d
        ops = pairs * (6 * d + 4 - (1 if kernel == "gaussian" else 0)) + n * (d + 3)
    return least_ms(ops, bytes_moved)
