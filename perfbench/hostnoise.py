"""Per-fit host readings over a long closed loop of one cell's fits (not run
by the benchmark's runs).

    python3 -m perfbench.hostnoise --workload <cell> --seconds 200 [--rows n]

It finds what moves a host-bound cell's fit times. In one process: the
cell's rows (``--rows`` overrides their number), one warm-up fit, then fits
back to back for ``--seconds``, in blocks of three with Python's garbage
collector on, then off (after a collection). Before each fit a fixed probe
times the host: a pure-Python loop and five copies of a 64 MB array. Each
fit's line: its wall, phases (``timings_``), the process's user and system
CPU, the main thread's CPU, the collector's passes and time, and the
probe's two times. Then the correlation of each with the wall, and the
spread (quartile distance over median) of the mean fit over windows of 10
to 80 s that start at each fit, as ``--seconds`` windows would read it.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time

import numpy as np

from perfbench.cells import Cell
from perfbench.run import prepare

WINDOWS = (10, 20, 40, 51, 80)


class GcClock:
    """The collector's passes and their summed time."""

    def __init__(self):
        self.seconds, self.passes, self._start = 0.0, 0, 0.0
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self._start = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._start
            self.passes += 1


def probe(buf: np.ndarray) -> tuple:
    t = time.perf_counter()
    s = 0
    for i in range(300_000):
        s += i * i % 7
    py = time.perf_counter() - t
    t = time.perf_counter()
    for _ in range(5):
        buf.copy()
    return py, time.perf_counter() - t


def window_spreads(walls: list) -> dict:
    """Spread of the mean fit over windows of each length in ``WINDOWS``."""
    out = {}
    for length in WINDOWS:
        means = []
        for i in range(len(walls)):
            total, j = 0.0, i
            while j < len(walls) and total < length:
                total += walls[j]
                j += 1
            if total >= length:
                means.append(sum(walls[i:j]) / (j - i))
        if len(means) >= 4:
            q = statistics.quantiles(means, n=4)
            out[length] = (q[2] - q[0]) / statistics.median(means)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, default=200.0)
    parser.add_argument("--rows", type=int, default=0)
    parser.add_argument("--seed", type=int, default=1_700_000_001)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    clock, buf = GcClock(), np.ones(16 * 1024 * 1024, dtype=np.float32)
    data = {"n": args.rows} if args.rows else None
    _, _, X, watch, model = prepare(Cell(args.workload), args.seed, args.device, None, data)
    model.fit_transform(X)
    recs, start = [], time.perf_counter()
    while time.perf_counter() - start < args.seconds:
        gc_on = (len(recs) // 3) % 2 == 0
        if gc_on:
            gc.enable()
        else:
            gc.collect()
            gc.disable()
        py, mem = probe(buf)
        o0, th0, g0 = os.times(), time.thread_time(), (clock.seconds, clock.passes)
        watch.reset()
        t0 = time.perf_counter()
        model.fit_transform(X)
        wall = time.perf_counter() - t0
        o1, th1 = os.times(), time.thread_time()
        recs.append({"gc": gc_on, "wall": wall, "timings": dict(model.timings_),
                     "user": o1.user - o0.user, "sys": o1.system - o0.system,
                     "thread_cpu": th1 - th0, "gc_s": clock.seconds - g0[0],
                     "gc_passes": clock.passes - g0[1], "probe_py": py, "probe_mem": mem})
        print(json.dumps(recs[-1]), flush=True)
    gc.enable()
    walls = np.array([r["wall"] for r in recs])
    corr = {}
    for key in ("thread_cpu", "user", "sys", "gc_s", "probe_py", "probe_mem"):
        v = np.array([float(r[key]) for r in recs])
        corr[key] = float(np.corrcoef(walls, v)[0, 1]) if v.std() > 0 else None
    on = np.array([r["gc"] for r in recs])
    print(json.dumps({"fits": len(recs), "corr_with_wall": corr,
                      "wall_gc_on": float(walls[on].mean()) if on.any() else None,
                      "wall_gc_off": float(walls[~on].mean()) if (~on).any() else None,
                      "window_spread": window_spreads(walls.tolist())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
