"""The benchmark of the PyTorch/CUDA port: one cell, one run, one result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. A run makes the cell's rows from the seed
(a host float32 array, as a user passes it), loads the port's kernels from
its build directory inside the checkout (built there by the first run),
fits the cell's estimator once at the cell's shape to warm up, and then
calls ``fit_transform`` back to back for ``--seconds``; the fit in progress
when the time is up is finished and counted. ``setup_s`` runs from the start
of this process to the first timed fit. With ``--trace 1`` the window's
first fit runs under ``torch.profiler`` (its records are read once the
window has closed) and the per-layer phase metrics read the other fits. Then
the last fit is judged against the plain reference in ``perfbench/reference`` (the
numbers and their limits end the result line and standard error), and the
cell's metrics are read: the end-to-end ones untraced, the per-layer ones
traced. The last line of standard output is the result, one JSON object.

The run fails, and prints no result, without a CUDA device (it never falls
back to the CPU), without the port in its checkout, or with JAX or the JAX
package loaded once the window has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # the process's start, as near as Python sees it

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

from perfbench.cells import ROOT, Cell  # noqa: E402

#: top-level modules the port must not load: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "torchdr_tpu")
#: rows sampled for the kNN recall and the affinity's rows
SAMPLE_ROWS = 2000


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, as a whole, is forbidden."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"


def program_objects(params: dict) -> dict:
    """The parameters with each ``{"KnnConfig": {...}}`` made the port's
    object of that name."""
    import torchdr_tpu_torch

    return {k: getattr(torchdr_tpu_torch, next(iter(v)))(**next(iter(v.values())))
            if isinstance(v, dict) else v for k, v in params.items()}


def prepare(cell: Cell, seed: int, device: str = "cuda", params_override: dict | None = None,
            data_override: dict | None = None):
    """(params, estimator module, rows X, watch, model) of one run of ``cell``."""
    import numpy as np
    import torch

    from perfbench.watch import Watch

    params = cell.params()
    params.update(params_override or {})
    est = cell.estimator()
    if device == "cuda":
        from torchdr_tpu_torch.ops.cuda.build import build_libraries

        build_libraries(est.KERNEL_SOURCES)
    if data_override:
        cell.traffic = dict(cell.traffic, params=dict(cell.traffic["params"], **data_override))
    X = cell.data(seed)
    n = X.shape[0]
    rng = np.random.default_rng([seed, 1])
    rows = np.sort(rng.choice(n, min(SAMPLE_ROWS, n), replace=False))
    watch = Watch(torch.from_numpy(rows).to(device))
    model = est.build(program_objects(params), seed, device, watch)
    return params, est, X, watch, model


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t0: float = T0, params_override: dict | None = None, data_override: dict | None = None):
    """One run of ``cell``: the result line's fields, and the timed fits."""
    import torch

    from perfbench.watch import HookNotReached

    cuda = device == "cuda"
    params, est, X, watch, model = prepare(cell, seed, device, params_override, data_override)

    def fit_once():
        watch.reset()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        Z = model.fit_transform(X)
        wall = time.perf_counter() - t
        return Z, {"wall_s": wall, "timings": dict(model.timings_), "n_iter": int(model.n_iter_),
                   "peak_bytes": torch.cuda.max_memory_allocated() if cuda else 0}

    _, warm = fit_once()
    setup_s = time.perf_counter() - t0
    counters = {}
    if trace:
        from perfbench import trace as tracing

        for m, reader in cell.metrics(trace=True):
            counters.update(getattr(reader, "COUNTERS", {}))
    fits, failed, Z, raw, shapes = [], 0, None, None, None
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        try:
            if trace and raw is None:
                # the window's first fit runs under the profiler; the phase
                # metrics read the others
                (Z, _), raw = tracing.profiled(fit_once, counters)
                shapes = est.shapes(model, watch)
                continue
            Z, rec = fit_once()
        except Exception:  # a failed fit is counted and ends the window
            traceback.print_exc()
            failed += 1
            break
        fits.append(rec)
    attempted = len(fits) + failed + (raw is not None)
    kept = watch.snapshot()
    memory_peak = max([warm["peak_bytes"]] + [f["peak_bytes"] for f in fits])
    del model
    if cuda:
        torch.cuda.empty_cache()
    profile = None
    if raw is not None:
        profile = dict(tracing.read(raw), shapes=shapes)
        del raw

    judged, numbers = None, {}
    limits = cell.limits()
    if Z is not None:
        try:
            judged = est.judge(params, X, Z, kept, device)
            numbers = judged["numbers"]
        except HookNotReached as err:
            # the program no longer calls a hook the check rides on
            print(err, file=sys.stderr)
            numbers, limits = {"hooks_missing": 1.0}, dict(limits, hooks_missing=0.0)
    checks = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    correct = Z is not None and failed == 0 and all(
        c["limit"] is not None and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    ctx = {"setup_s": setup_s, "fits": fits, "X": X, "Z": Z, "seed": seed, "device": device,
           "judged": judged, "profile": profile, "cell": cell}
    metrics = {}
    for m, reader in cell.metrics(trace=trace):
        value = reader.read(ctx) if Z is not None else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    if profile is not None:
        info.update(busy_s=profile["busy_s"], window_s=profile["wall_s"])
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if profile is not None:
        result["breakdown"] = profile["breakdown"]
    result["checks"] = checks
    return result, fits


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    cell = Cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    try:
        import torchdr_tpu_torch
    except ImportError as err:
        print(f"perfbench: the port is not in this checkout: {err}", file=sys.stderr)
        return 2
    if ROOT not in Path(torchdr_tpu_torch.__file__).resolve().parents:
        print(f"perfbench: torchdr_tpu_torch loads from {torchdr_tpu_torch.__file__}, "
              f"outside the checkout {ROOT}", file=sys.stderr)
        return 2

    result, fits = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in the measured process: {', '.join(found)}", file=sys.stderr)
        return 3
    for f in fits:
        print("perfbench: fit " + json.dumps({k: f[k] for k in ("wall_s", "timings")}),
              file=sys.stderr)
    print(f"perfbench: {power_limit()}", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
