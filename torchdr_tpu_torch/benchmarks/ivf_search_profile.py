"""Where the IVF search spends its time at the 10M x 128 operating point,
on one card.

    python -m torchdr_tpu_torch.benchmarks.ivf_search_profile [--tier split|int8|f32 ...]
        [--blocks B] [--n N] [--queries Q]

Makes N x 128 float32 rows (default 10,000,000) around 10,000 centres drawn
N(0, 10^2) with unit noise (:func:`make_tiers_data`, the data of
``chip_smoke.py``'s kNN tiers phase), builds the index of each tier with
``ivf_build``'s defaults, and runs the self-query probe of ``ivf_knn`` (k =
15, nprobe 12, budget 128) over the first B query blocks of 256 rows:
once timed with CUDA events, once under ``torch.profiler``. It prints one
JSON line a tier with the resolved knobs, ms a block, the device's idle
share, and the device time and calls of the top kernels a block. With
``--queries Q`` it instead indexes the first N − Q rows (float32, as a
segment of ``knn_graph_streaming``) and profiles one ``ivf_knn_queries``
of the last Q rows.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

K, NPROBE, BUDGET, BLOCK = 15, 12, 128, 256


def make_tiers_data(n: int, d: int = 128, n_centers: int = 10_000, seed: int = 0,
                    device="cuda", seg: int = 1_000_000) -> torch.Tensor:
    """n x d float32 rows on ``device`` around ``n_centers`` centres drawn
    N(0, 10^2), unit noise, made in ``seg``-row segments from a
    ``torch.Generator`` seeded ``seed`` (the JAX package's 10M operating
    point, ``benchmarks/_ivf10m_driver2.py``)."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    centers = torch.randn((n_centers, d), generator=g, device=device) * 10.0
    X = torch.empty((n, d), device=device)
    for a in range(0, n, seg):
        m = min(seg, n - a)
        lab = torch.randint(0, n_centers, (m,), generator=g, device=device)
        X[a : a + m] = centers[lab] + torch.randn((m, d), generator=g, device=device)
    return X


def profile_tier(X: torch.Tensor, tier: str, blocks: int) -> dict:
    from torch.profiler import ProfilerActivity, profile

    from torchdr_tpu_torch.ops import ivf

    index = ivf.ivf_build(X, storage={"f32": "f32", "split": "split", "int8": "int8"}[tier])
    nprobe, budget, m, merge, max_ch, _, n_supers, nominate = ivf._resolve_search_knobs(
        index, K, NPROBE, None, BUDGET, None, "xla")
    nq = min(blocks * BLOCK, (index.X_sorted.shape[0] // BLOCK) * BLOCK)
    ids = index.ids_sorted[:nq]
    kw = dict(k=K, ncells=nprobe, budget=budget, block=BLOCK, chunk=index.chunk, m=m,
              merge=merge, max_ch=max_ch, nominate=nominate, n_supers=n_supers,
              Qs_lo=None if index.X_lo is None else index.X_lo[:nq])

    def run():
        return ivf._ivf_search_impl(index.X_sorted[:nq], ids, index, **kw)

    run()  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()

    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    kernels.sort(key=_device_us, reverse=True)
    n_blocks = nq // BLOCK
    per_block = sum(_device_us(e) for e in kernels) / 1e3 / n_blocks
    return {
        "tier": tier, "n": X.shape[0], "blocks": n_blocks, "chunk": index.chunk,
        "budget": budget, "m": m, "merge": merge, "nomination": nominate,
        "ms_per_block": ms / n_blocks, "device_ms_per_block": per_block,
        "device_idle_share": 1.0 - per_block * n_blocks / ms,
        "top_kernels_ms_per_block": {
            e.key[:70]: _device_us(e) / 1e3 / n_blocks for e in kernels[:15]},
        "calls_per_block": {e.key[:70]: e.count / n_blocks for e in kernels[:15]},
    }


def profile_queries(X: torch.Tensor, n_db: int, nq: int) -> dict:
    """``ivf_knn_queries`` of ``nq`` rows against a float32 index of the
    first ``n_db`` rows (a segment of ``knn_graph_streaming``): seconds of
    the call, the resolved knobs, and the device time of the top kernels."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from torchdr_tpu_torch.ops import ivf

    index = ivf.ivf_build(X[:n_db])
    Q = X[n_db : n_db + nq]
    ivf.ivf_knn_queries(Q, index, k=K, nprobe=NPROBE)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ivf.ivf_knn_queries(Q, index, k=K, nprobe=NPROBE)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ivf.ivf_knn_queries(Q, index, k=K, nprobe=NPROBE)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if str(getattr(e, "device_type", "")).endswith("CUDA") and _device_us(e) > 0]
    kernels.sort(key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in kernels) / 1e6
    homes = max(1, min(BLOCK, -(-BLOCK * min(index.centroids.shape[0], nq) // nq)))
    knobs = ivf._resolve_search_knobs(index, K, NPROBE * homes, None, None, None, "xla",
                                      has_q_cells=True)
    return {
        "queries": nq, "db_rows": n_db, "chunk": index.chunk, "homes_per_block": homes,
        "nprobe": knobs[0], "budget": knobs[1], "m": knobs[2], "merge": knobs[3],
        "nomination": knobs[7], "seconds": secs, "device_busy_s": busy,
        "top_kernels_s": {e.key[:70]: _device_us(e) / 1e6 for e in kernels[:12]},
    }


def _device_us(evt):
    return getattr(evt, "self_device_time_total", None) or getattr(evt, "self_cuda_time_total", 0.0)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    blocks, n, tiers, queries = 2000, 10_000_000, [], None
    while argv:
        arg = argv.pop(0)
        if arg == "--queries":
            queries = int(argv.pop(0))
        elif arg == "--blocks":
            blocks = int(argv.pop(0))
        elif arg == "--n":
            n = int(argv.pop(0))
        elif arg == "--tier":
            tiers.append(argv.pop(0))
        else:
            raise SystemExit(f"unknown argument {arg!r}")
    import torchdr_tpu_torch  # noqa: F401  (TF32 off)

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    X = make_tiers_data(n)
    if queries:
        rec = profile_queries(X, n - queries, queries)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        return 0
    for tier in tiers or ["split", "int8"]:
        rec = profile_tier(X, tier, blocks)
        rec["card"] = card
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
