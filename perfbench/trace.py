"""One whole fit under ``torch.profiler``, read into what the per-layer
metrics and the result's ``breakdown`` need. In a traced run the window's
first fit is the profiled one; the records are read after the window.

The device's busy time is the union of its kernels', copies' and memsets'
intervals; an idle gap is a stretch of the profiled fit with none of them,
labelled by the innermost host operation the profiler shows at its middle.
The arithmetic is ``chip_smoke.profile_optimize``'s, over a user's whole
``fit_transform`` rather than a replayed optimizer loop.
"""

from __future__ import annotations

import importlib
import time

TOP = 10
#: the profiler's own host events, which are no work of the program
PROFILER_OWN = {"Activity Buffer Request"}
NAME_CHARS = 120


def _counter(path):
    module, name = path
    return getattr(importlib.import_module(module), name).launches


def profiled(fit, counters: dict):
    """``fit()`` under the profiler: its result, and what :func:`read` reads
    (the profiler's records, the wall seconds, the launches each counter
    saw)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    before = {k: _counter(v) for k, v in counters.items()}
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fit()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k: _counter(v) - before[k] for k, v in counters.items()}
    return out, {"prof": prof, "wall_s": wall, "launches": launches}


def read(raw: dict) -> dict:
    """Wall and busy seconds, device seconds by kernel name, the launches,
    the top device operations and the longest idle gaps of a profiled fit
    (from the profiler's raw records, which read far faster than its event
    tree)."""
    device, host = [], []
    for e in raw["prof"].profiler.kineto_results.events():
        name = e.name()
        if name in PROFILER_OWN:
            continue
        span = (e.start_ns(), e.start_ns() + e.duration_ns(), name)
        (device if str(e.device_type()).endswith("CUDA") else host).append(span)
    by_name = {}
    for start, end, name in device:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e9
    device.sort()
    busy_ns, gaps = 0, []
    t_first = min(s for s, _, _ in host + device)
    t_last = max(e for _, e, _ in host + device)
    cursor = t_first
    for start, end, _ in device:
        if start > cursor:
            gaps.append((start - cursor, cursor, start))
        if end > cursor:
            busy_ns += end - max(start, cursor)
            cursor = end
    if t_last > cursor:
        gaps.append((t_last - cursor, cursor, t_last))
    gaps.sort(reverse=True)
    idle = []
    for length, start, end in gaps[:TOP]:
        mid = 0.5 * (start + end)
        inside = [(e - s, name) for s, e, name in host if s <= mid <= e]
        label = min(inside)[1] if inside else "no host operation"
        idle.append([label[:NAME_CHARS], length / 1e9])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "wall_s": raw["wall_s"],
        "busy_s": busy_ns / 1e9,
        "device_s_by_name": by_name,
        "launches": raw["launches"],
        "breakdown": {"device_ops": [[name[:NAME_CHARS], s] for name, s in top],
                      "idle_gaps": idle},
    }
