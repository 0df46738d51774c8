"""Euclidean TSNE vs hyperbolic COSNE on hierarchical data (counterpart of
``examples/basics/demo_tsne_vs_cosne.py``).

Run: python -m torchdr_tpu_torch.examples.basics.demo_tsne_vs_cosne [--device cpu]
"""

import os
import tempfile

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, parser, timed_fit

SCRIPT = "basics/demo_tsne_vs_cosne"


def hierarchical_blobs(n=400, seed=0):
    """Two-level cluster hierarchy: the regime hyperbolic space embeds
    with less distortion than the plane."""
    rng = np.random.default_rng(seed)
    tops = rng.normal(scale=20.0, size=(4, 16))
    X, y = [], []
    for t_idx, top in enumerate(tops):
        subs = top + rng.normal(scale=4.0, size=(3, 16))
        for sub in subs:
            X.append(sub + rng.normal(scale=0.5, size=(n // 12, 16)))
            y.append(np.full(n // 12, t_idx))
    return np.concatenate(X).astype(np.float32), np.concatenate(y)


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    X, y = hierarchical_blobs()
    Zt, t_tsne = timed_fit(tdt.TSNE(perplexity=20, max_iter=500, random_state=0, device=dev), X)
    Zc, t_cosne = timed_fit(tdt.COSNE(perplexity=20, max_iter=500, lr=1e-1, gamma=2.0,
                                      random_state=0, device=dev), X)
    sil_t = tdt.silhouette_score(Zt, y, device=dev)
    sil_c = tdt.silhouette_score(Zc, y, device=dev)
    max_norm = float(np.abs(Zc).max())
    print(f"TSNE  silhouette: {sil_t:.3f}")
    print(f"COSNE silhouette: {sil_c:.3f} "
          f"(Poincaré disk: max |z| = {max_norm:.3f} < 1)")

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        from torchdr_tpu_torch.utils.visu import plot_poincare_disk

        out = os.path.join(tempfile.gettempdir(), "cosne_disk.png")
        plot_poincare_disk(Zc, y)
        plt.savefig(out, dpi=120)
        plt.close()
        print(f"saved {out}")
    except ImportError:
        pass

    fits = {
        "TSNE": {"embedding": Zt, "labels": y, "seconds": t_tsne, "silhouette": sil_t,
                 "knn_acc": tdt.knn_label_accuracy(Zt, y, k=10, device=dev)},
        "COSNE": {"embedding": Zc, "labels": y, "seconds": t_cosne, "silhouette": sil_c,
                  "knn_acc": tdt.knn_label_accuracy(Zc, y, k=10, device=dev),
                  "max_norm": max_norm},
    }
    for name, fit in fits.items():
        check_fit(SCRIPT, name, fit)
    radius = float(np.linalg.norm(Zc.astype(np.float64), axis=1).max())
    if not radius < 1:
        raise AssertionError(f"{SCRIPT}: COSNE left the Poincaré disk (max ‖z‖ {radius})")
    return {"fits": fits}


if __name__ == "__main__":
    main()
