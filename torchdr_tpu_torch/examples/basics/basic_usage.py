"""Basic usage: UMAP / TSNE on a toy dataset with quality metrics
(counterpart of ``examples/basics/basic_usage.py``).

Run: python -m torchdr_tpu_torch.examples.basics.basic_usage [--device cpu]
"""

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, parser, timed_fit
from torchdr_tpu_torch.examples._data import make_moons

SCRIPT = "basics/basic_usage"


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    X, y = make_moons(n_samples=500, noise=0.05, random_state=0)
    X = X.astype(np.float32)

    fits = {}
    for name, model in [
        ("UMAP", tdt.UMAP(n_neighbors=15, random_state=0, device=dev)),
        ("TSNE", tdt.TSNE(perplexity=30, random_state=0, device=dev)),
        ("LargeVis", tdt.LargeVis(perplexity=30, random_state=0, device=dev)),
        ("PCA", tdt.PCA(device=dev)),
    ]:
        Z, seconds = timed_fit(model, X)
        fit = {
            "embedding": Z, "labels": y, "seconds": seconds,
            "silhouette": tdt.silhouette_score(Z, y, device=dev),
            "knn_acc": tdt.knn_label_accuracy(Z, y, k=10, device=dev),
            "preservation": tdt.neighborhood_preservation(X, Z, K=15, device=dev),
        }
        print(
            f"{name}: silhouette={fit['silhouette']:.3f} "
            f"knn-acc={fit['knn_acc']:.3f} "
            f"preservation={fit['preservation']:.3f}"
        )
        fits[name] = fit
    for name, fit in fits.items():
        check_fit(SCRIPT, name, fit)
    return {"fits": fits}


if __name__ == "__main__":
    main()
