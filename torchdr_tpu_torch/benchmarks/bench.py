"""The port's headline benchmark (counterpart of the repository's ``bench.py``):
prints ONE JSON line.

    python -m torchdr_tpu_torch.benchmarks.bench
    python -m torchdr_tpu_torch.cli bench

Headline metric: the reference's own Faiss kNN benchmark configuration
(1M x 128-d clustered data, 1,000 Gaussian clusters, k = 15) run through
the port's IVF tier on one card (``ivf_build`` with NLIST cells and 20
k-means iterations; ``ivf_knn`` at nprobe NPROBE, m M), with recall@15
measured on the first 1,000 rows against the exact float32 ``knn_graph``.

Reference numbers on an NVIDIA B200 (the reference's
BENCHMARK_RESULTS.md):
  Faiss Flat  10.19 s @ 100.0% recall
  Faiss IVF    2.90 s @  99.9% recall (nlist=4096, nprobe=40)

``vs_baseline`` = B200 Faiss IVF seconds / the port's search seconds.

The timed work runs in a child process (``--child``, at most
CHILD_TIMEOUT_S seconds), which prints a ``RESULT`` line; the parent prints
the JSON line on standard output and a summary on standard error. When the
child fails or times out, the parent prints the line with ``"value": -1.0``
and exits 1 (the JAX script exits 0 there).

Data: the 1,000 centres are the JAX script's numpy draw
(``np.random.default_rng(0).normal(scale=10.0, size=(1000, 128))``); the
labels and the unit noise are drawn on the device from a
``torch.Generator`` seeded 0, so the 512 MB of rows never cross the host
link. The JAX script draws them with ``jax.random``: the same
distribution, other numbers.

``--n`` and ``--device`` change the size and the device, for a test on
the CPU; the benchmark is their defaults.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N, D, K = 1_000_000, 128, 15
NLIST, NPROBE, M = 1024, 12, 24  # the JAX script's adjacency-nomination knobs
B200_FLAT_S = 10.19
B200_IVF_S = 2.90
N_CENTERS, N_EVAL = 1000, 1000
CHILD_TIMEOUT_S = 2400
METRIC = f"knn_{N}x{D}_k{K}_ivf_search_seconds"


def _run_child(n: int = N, nlist: int = NLIST, device="auto") -> dict:
    """Build the index, search it twice (the second timed) and read the
    recall; the seconds of the build and of the timed search."""
    import numpy as np
    import torch

    from torchdr_tpu_torch.base import resolve_device
    from torchdr_tpu_torch.ops.distance import knn_graph
    from torchdr_tpu_torch.ops.ivf import ivf_build, ivf_knn

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.default_rng(0)
    centers = torch.from_numpy(
        rng.normal(scale=10.0, size=(N_CENTERS, D)).astype(np.float32)).to(dev)
    g = torch.Generator(device=dev)
    g.manual_seed(0)
    lab = torch.randint(0, N_CENTERS, (n,), generator=g, device=dev)
    X = centers[lab] + torch.randn((n, D), generator=g, device=dev)
    sync()

    t0 = time.perf_counter()
    index = ivf_build(X, n_clusters=nlist, kmeans_iters=20)
    sync()
    build_s = time.perf_counter() - t0

    kw = dict(k=K, nprobe=NPROBE, m=M, scan_precision="high", index=index)
    ivf_knn(X, **kw)  # warm-up
    sync()
    t0 = time.perf_counter()
    _, i = ivf_knn(X, **kw)
    sync()
    search_s = time.perf_counter() - t0

    sub = min(N_EVAL, n)
    _, i_t = knn_graph(X[:sub], X, k=K + 1, exclude_diag=False)
    i_t = i_t.cpu().numpy()
    i_true = np.stack([row[row != r][:K] for r, row in enumerate(i_t)])
    i_got = i[:sub].cpu().numpy()
    recall = float(np.mean([len(set(i_got[j]) & set(i_true[j])) / K for j in range(sub)]))
    return {"build_s": build_s, "search_s": search_s, "recall": recall}


def _child_result(args) -> dict | None:
    """The child's RESULT, or None (with the reason on standard error)."""
    cmd = [sys.executable, "-m", "torchdr_tpu_torch.benchmarks.bench", "--child",
           "--n", str(args.n), "--device", args.device]
    root = str(Path(__file__).resolve().parents[2])  # the directory that holds the package
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=CHILD_TIMEOUT_S,
                              env=env)
    except subprocess.TimeoutExpired:
        print("[bench] child timed out", file=sys.stderr)
        return None
    for line in proc.stdout.splitlines():
        if line.startswith("RESULT "):
            return json.loads(line[len("RESULT "):])
    print(f"[bench] child failed:\n{proc.stderr[-2000:]}", file=sys.stderr)
    return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    parser.add_argument("--n", type=int, default=N, help="rows (a test's size; default 1M)")
    parser.add_argument("--device", default="auto",
                        help="'auto' (the card, or raise without one) or 'cpu'")
    args = parser.parse_args(argv)
    if args.child:
        print("RESULT " + json.dumps(_run_child(args.n, device=args.device)), flush=True)
        return 0

    result = _child_result(args)
    if result is None:
        print(json.dumps({"metric": METRIC, "value": -1.0, "unit": "s", "vs_baseline": 0.0}))
        return 1

    search_s = result["search_s"]
    print(
        f"[bench] ivf(nlist={NLIST}, nprobe={NPROBE}, m={M}) "
        f"build={result['build_s']:.1f}s search={search_s:.2f}s "
        f"recall@{K}={result['recall']:.4f} "
        f"| B200 Faiss: Flat {B200_FLAT_S}s@100%, IVF {B200_IVF_S}s@99.9%",
        file=sys.stderr,
    )
    print(json.dumps({
        "metric": METRIC,
        "value": round(search_s, 3),
        "unit": "s",
        "vs_baseline": round(B200_IVF_S / search_s, 3),
        "build_s": round(result["build_s"], 3),
        "recall": round(result["recall"], 5),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
