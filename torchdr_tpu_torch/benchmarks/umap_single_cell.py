"""Single-cell-scale UMAP benchmark on one card (counterpart of
``benchmarks/umap_single_cell.py``, after the reference's
benchmarks/benchmark_umap_single_cell.py: 50 PCA dimensions, 500
iterations), on synthetic clustered data, since the real datasets are not
in the repository.

    python -m torchdr_tpu_torch.benchmarks.umap_single_cell [--n N] [--pca-dims D]
        [--iters T] [--distributed] [--device auto|cpu]

The data are the JAX script's numpy draw, bit for bit (40 centres at scale
5, unit noise). It fits ``UMAP(n_neighbors=30, max_iter=T, random_state=0,
distributed=...)`` (``--distributed``: a mesh of every visible card, one
device on a one-card machine) and prints the fit seconds and the
silhouette of every (n // 5000)-th row of the embedding
(``eval.silhouette_score``). ``main`` returns them with the embedding and
the labels.
"""

from __future__ import annotations

import argparse
import time

import numpy as np


def make_data(n: int, pca_dims: int, seed: int = 0):
    """The JAX script's rows and labels."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=5.0, size=(40, pca_dims)).astype(np.float32)
    lab = rng.integers(0, 40, n)
    X = centers[lab] + rng.normal(size=(n, pca_dims)).astype(np.float32)
    return X, lab


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=200_000)
    parser.add_argument("--pca-dims", type=int, default=50)
    parser.add_argument("--iters", type=int, default=500)
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--device", default="auto",
                        help="'auto' (the card, or raise without one) or 'cpu'")
    args = parser.parse_args(argv)

    from torchdr_tpu_torch import UMAP
    from torchdr_tpu_torch.eval import silhouette_score

    X, lab = make_data(args.n, args.pca_dims)
    model = UMAP(n_neighbors=30, max_iter=args.iters, random_state=0,
                 distributed=args.distributed, device=args.device)
    t0 = time.perf_counter()
    Z = model.fit_transform(X)  # a numpy array: the fit has ended
    dt = time.perf_counter() - t0
    step = max(1, args.n // 5000)
    sil = silhouette_score(Z[::step], lab[::step], device=model.device_)
    print(f"UMAP n={args.n} d={args.pca_dims} iters={args.iters}: {dt:.1f}s silhouette={sil:.3f}")
    return {"n": args.n, "d": args.pca_dims, "iters": args.iters,
            "distributed": args.distributed, "seconds": dt, "silhouette": sil,
            "embedding": Z, "labels": lab}


if __name__ == "__main__":
    main()
