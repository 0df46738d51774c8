"""One cell's fit under the program's own ``device_trace``, read by span, and
what the spans and the trace cost.

    python3 -m perfbench.spantrace --workload <cell> --seed <n> [--pairs 4] [--out DIR]

Run from the root of a checkout, on the card. The cell's estimator is built
and warmed up as ``perfbench.run`` builds it. Then:

- one fit runs under ``torchdr_tpu_torch.utils.device_trace``, which turns on
  the spans' ``torchdr/<span>`` ranges; the trace's kernels, copies and
  memsets give the device's busy intervals inside the ``torchdr/fit`` range,
  and each of the longest idle gaps there is put down to the innermost span
  and the innermost host operation over its middle;
- ``--pairs`` rounds of three fits, in turns: untraced, under
  ``device_trace``, and under ``device_trace`` with the ranges held off (the
  profiler's own cost against the ranges'), the order rotating each round;
- the host cost of one span in a fit and outside one, with and without a
  synchronise of the idle card.

Prints one JSON object as its last line (the traced fit's timings, its
gaps, the walls) and, with ``--out DIR``, writes it into ``DIR/<cell>.json``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import statistics
import sys
import tempfile
import time
from pathlib import Path

TOP = 5
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def read_trace(path: str) -> dict:
    """The spans, host operations and device intervals of a trace, in µs."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans, ops, device = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        iv = (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e.get("name", ""))
        cat = e.get("cat", "")
        if cat == "user_annotation" and iv[2].startswith("torchdr/"):
            spans.append(iv)
        elif cat in DEVICE_CATS:
            device.append(iv)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver"):
            ops.append(iv)
    return {"spans": spans, "ops": ops, "device": device}


def innermost(intervals, t: float) -> str:
    inside = [(e - s, name) for s, e, name in intervals if s <= t <= e]
    return min(inside)[1] if inside else "none"


def gaps_by_span(trace: dict, top: int = TOP) -> dict:
    """Busy seconds and the longest idle gaps of the device inside the
    ``torchdr/fit`` range, each with the innermost span and host operation
    over its middle."""
    fit = [s for s in trace["spans"] if s[2] == "torchdr/fit"]
    if len(fit) != 1:
        raise RuntimeError(f"perfbench: {len(fit)} torchdr/fit ranges in the trace")
    t0, t1, _ = fit[0]
    device = sorted((max(s, t0), min(e, t1)) for s, e, _ in trace["device"] if e > t0 and s < t1)
    busy, gaps, cursor = 0.0, [], t0
    for s, e in device:
        if s > cursor:
            gaps.append((s - cursor, cursor, s))
        if e > cursor:
            busy += e - max(s, cursor)
            cursor = e
    if t1 > cursor:
        gaps.append((t1 - cursor, cursor, t1))
    gaps.sort(reverse=True)
    out = []
    for length, s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        out.append({"s": length / 1e6, "span": innermost(trace["spans"], mid).replace(
            "torchdr/", ""), "host_op": innermost(trace["ops"], mid), "at_s": (s - t0) / 1e6})
    return {"wall_s": (t1 - t0) / 1e6, "busy_s": busy / 1e6, "idle": 1 - busy / (t1 - t0),
            "gaps": out}


def span_seconds(trace: dict) -> dict:
    total = {}
    for s, e, name in trace["spans"]:
        key = name[len("torchdr/"):]
        total[key] = total.get(key, 0.0) + (e - s) / 1e6
    return total


def span_cost_us(device, n: int = 20000) -> dict:
    """Host µs of one span (enter and exit), outside a fit and inside one,
    without and with a synchronise of the idle card."""
    import torch

    from torchdr_tpu_torch.utils import profiling

    def per(make, sync):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            with make("probe", device if sync else None):
                pass
        return (time.perf_counter() - t) / n * 1e6

    out = {"outside_fit": per(profiling.span, False)}
    with profiling.fit_span({}):
        out["in_fit"] = per(profiling.span, False)
        out["in_fit_sync"] = per(profiling.span, True)
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--pairs", type=int, default=0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)

    import torch

    from perfbench.cells import Cell
    from perfbench.run import power_limit, prepare
    from torchdr_tpu_torch.utils import device_trace, profiling

    if not torch.cuda.is_available():
        print("perfbench: spantrace needs a CUDA device", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    _, _, X, watch, model = prepare(cell, args.seed)

    def fit():
        watch.reset()
        t = time.perf_counter()
        model.fit_transform(X)
        return time.perf_counter() - t

    fit()  # warm-up
    with tempfile.TemporaryDirectory() as logdir:
        with device_trace(logdir):
            traced_wall = fit()
        trace = read_trace(glob.glob(os.path.join(logdir, "*.pt.trace.json"))[0])
    result = {"workload": args.workload, "seed": args.seed, "card": power_limit(),
              "traced_wall_s": traced_wall, "timings": dict(model.timings_),
              "n_iter": int(model.n_iter_), "ranges": span_seconds(trace),
              **gaps_by_span(trace)}
    del trace

    def traced(annotate: bool):
        with tempfile.TemporaryDirectory() as logdir:
            with device_trace(logdir):
                profiling._annotate = annotate
                return fit()

    walls = {"untraced": [], "trace": [], "trace_no_ranges": []}
    runs = [("untraced", fit), ("trace", lambda: traced(True)),
            ("trace_no_ranges", lambda: traced(False))]
    for i in range(args.pairs):
        for name, run in runs[i % 3:] + runs[:i % 3]:
            walls[name].append(run())
    if args.pairs:
        result["walls"] = walls
        result["medians"] = {k: statistics.median(v) for k, v in walls.items()}
    result["span_cost_us"] = span_cost_us(torch.device("cuda"))

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / f"{args.workload}.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
