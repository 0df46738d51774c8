"""kNN graph benchmark on one card (counterpart of ``benchmarks/knn_benchmark.py``),
following the reference's Faiss methodology: clustered or random data,
k = 15, recall against the exact graph.

    python -m torchdr_tpu_torch.benchmarks.knn_benchmark [--n N] [--d D] [--k K]
        [--kind clustered|random] [--device auto|cpu]

Tiers, with the JAX script's labels and ``knn_graph`` arguments (query
blocks of 2,048 rows), each timed on its second, synchronised call, and
its recall@k on the first 2,000 rows against the first tier's graph:

  exact/f32    ``mode="exact", precision="highest"``
  exact/bf16   ``mode="exact", precision="default"``
  approx@0.95  ``mode="approx", recall_target=0.95``

The port's grams are always full float32 and its approximate tier is the
exact one (ROADMAP, "Deviations"), so ``exact/bf16`` and ``approx@0.95``
compute the exact float32 graph too and read recall 1.0; the script prints
a line saying so. The data are the JAX script's numpy draw, bit for bit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np

TIERS = (
    ("exact/f32", dict(mode="exact", precision="highest")),
    ("exact/bf16", dict(mode="exact", precision="default")),
    ("approx@0.95", dict(mode="approx", recall_target=0.95)),
)
BLOCK_SIZE, N_RECALL = 2048, 2000


def make_data(n, d, kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "clustered":
        centers = rng.normal(scale=10.0, size=(1000, d)).astype(np.float32)
        return centers[rng.integers(0, 1000, n)] + rng.normal(size=(n, d)).astype(np.float32)
    return rng.uniform(size=(n, d)).astype(np.float32)


def run_tiers(X, k: int) -> dict:
    """Each tier's seconds (its second call), recall against the first
    tier, and indices, on ``X``'s device."""
    import torch

    from torchdr_tpu_torch.eval.knn_metrics import knn_recall
    from torchdr_tpu_torch.ops.distance import knn_graph

    n_sample = min(N_RECALL, X.shape[0])
    results, reference_idx = {}, None
    for label, kwargs in TIERS:
        d, i = knn_graph(X, k=k, block_size=BLOCK_SIZE, **kwargs)
        float(torch.sum(d))  # the first call, to the end
        t0 = time.perf_counter()
        d, i = knn_graph(X, k=k, block_size=BLOCK_SIZE, **kwargs)
        float(torch.sum(d))
        dt = time.perf_counter() - t0
        if reference_idx is None:
            reference_idx = i
            rec = 1.0
        else:
            rec = knn_recall(i[:n_sample], reference_idx[:n_sample], device=X.device)
        results[label] = {"seconds": dt, "recall": rec, "indices": i}
    return results


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=100_000)
    parser.add_argument("--d", type=int, default=128)
    parser.add_argument("--k", type=int, default=15)
    parser.add_argument("--kind", choices=["clustered", "random"], default="clustered")
    parser.add_argument("--device", default="auto",
                        help="'auto' (the card, or raise without one) or 'cpu'")
    args = parser.parse_args(argv)

    import torch

    from torchdr_tpu_torch.base import resolve_device

    X = torch.from_numpy(make_data(args.n, args.d, args.kind)).to(resolve_device(args.device))
    results = run_tiers(X, args.k)
    for label, res in results.items():
        print(f"{label:>14}: {res['seconds']:7.3f}s  recall@{args.k}={res['recall']:.4f}")
    print("(the port's grams are full float32 and its approx tier is exact: "
          "exact/bf16 and approx@0.95 compute the exact float32 graph)")
    return results


if __name__ == "__main__":
    main()
