"""TSNE / LargeVis on single-cell RNA-seq data (counterpart of
``examples/single_cell/single_cell.py``).

The reference embeds the Macosko-2015 retina (PCA-50 features) with TSNE
and LargeVis. The script reads a local copy when one exists (``--data``,
else ``macosko_2015.pkl.gz`` beside this file; the opentsne benchmark
files' pickle format), and otherwise synthesizes single-cell-like PCA-50
features (many imbalanced cell-type clusters with branch-structured
trajectories) at the Macosko size, as the JAX script does.

Run: python -m torchdr_tpu_torch.examples.single_cell.single_cell [--n 44808] [--device cpu]
"""

import gzip
import os
import pickle
import tempfile

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, parser, timed_fit

SCRIPT = "single_cell/single_cell"
LOCAL_COPY = os.path.join(os.path.dirname(os.path.abspath(__file__)), "macosko_2015.pkl.gz")


def real_dataset(path):
    with gzip.open(path, "rb") as f:
        data = pickle.load(f)
    X = data["pca_50"].astype(np.float32)
    cell_types = np.asarray(data["CellType1"]).astype(str)
    _, y = np.unique(cell_types, return_inverse=True)
    return X, y


def synthetic_dataset(n, rng):
    """Single-cell-like PCA-50: imbalanced cell types + branch trajectories."""
    n_types = 12
    # Imbalanced cluster sizes (rod cells dominate Macosko retina data).
    weights = rng.dirichlet(np.ones(n_types) * 0.5)
    labels = rng.choice(n_types, size=n, p=weights)
    centers = rng.normal(size=(n_types, 50)) * 6.0
    X = centers[labels] + rng.normal(size=(n, 50))
    # Branch structure: half the types get a 1-d trajectory direction.
    for t in range(0, n_types, 2):
        mask = labels == t
        direction = rng.normal(size=50)
        direction /= np.linalg.norm(direction)
        X[mask] += np.outer(rng.uniform(0, 8, size=mask.sum()), direction)
    return X.astype(np.float32), labels


def main(argv=None) -> dict:
    p = parser(__doc__)
    p.add_argument("--n", type=int, default=44_808)  # Macosko-2015 size
    p.add_argument("--data", default=LOCAL_COPY, help="a local Macosko-2015 pickle")
    args = p.parse_args(argv)
    dev = args.device

    if os.path.exists(args.data):
        X, y = real_dataset(args.data)
        print(f"Macosko-2015: {X.shape}")
    else:
        print("(local dataset not found; using synthetic single-cell features)")
        X, y = synthetic_dataset(args.n, np.random.default_rng(0))

    models = {
        "TSNE": tdt.TSNE(perplexity=30, max_iter=500, random_state=0, verbose=True, device=dev),
        "LargeVis": tdt.LargeVis(
            perplexity=30, max_iter=1000, n_negatives=50, lr=1e0,
            random_state=0, verbose=True, device=dev,
        ),
    }
    fits = {}
    for name, model in models.items():
        Z, dt = timed_fit(model, X)
        sil = tdt.silhouette_score(Z, y, device=dev)
        print(f"{name}: {X.shape[0]} cells in {dt:.1f}s, cell-type silhouette {sil:.3f}")
        fits[name] = {"embedding": Z, "labels": y, "seconds": dt, "silhouette": sil,
                      "knn_acc": tdt.knn_label_accuracy(Z, y, k=10, device=dev)}

        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            plt.figure(figsize=(6, 6))
            plt.scatter(*Z.T, c=y, s=1, cmap="tab20")
            plt.title(f"{name} on single-cell PCA-50")
            out = os.path.join(tempfile.gettempdir(), f"single_cell_{name.lower()}.png")
            plt.savefig(out, dpi=120)
            plt.close()
            print(f"saved {out}")
        except ImportError:
            pass
    for name, fit in fits.items():
        check_fit(SCRIPT, name, fit)
    return {"fits": fits, "n": int(X.shape[0])}


if __name__ == "__main__":
    main()
