"""Compare neighbor-embedding methods on one dataset
(counterpart of ``examples/basics/demo_ne_methods.py``).

Run: python -m torchdr_tpu_torch.examples.basics.demo_ne_methods [--device cpu]
"""

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, parser, timed_fit
from torchdr_tpu_torch.examples._data import make_moons

SCRIPT = "basics/demo_ne_methods"


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    X, y = make_moons(n_samples=500, noise=0.05, random_state=0)
    X = X.astype(np.float32)

    methods = {
        "TSNE": tdt.TSNE(perplexity=30, max_iter=500, random_state=0, device=dev),
        "SNE": tdt.SNE(perplexity=30, max_iter=500, random_state=0, device=dev),
        "UMAP": tdt.UMAP(n_neighbors=30, max_iter=500, random_state=0, device=dev),
        "LargeVis": tdt.LargeVis(perplexity=30, max_iter=500, random_state=0, device=dev),
        "InfoTSNE": tdt.InfoTSNE(perplexity=30, max_iter=500, random_state=0, device=dev),
        "PACMAP": tdt.PACMAP(n_neighbors=10, max_iter=450, random_state=0, device=dev),
    }
    fits = {}
    for name, model in methods.items():
        Z, seconds = timed_fit(model, X)
        sil = tdt.silhouette_score(Z, y, device=dev)
        print(f"{name:9s}  {seconds:6.1f}s  silhouette={sil:.3f}")
        fits[name] = {"embedding": Z, "labels": y, "seconds": seconds, "silhouette": sil,
                      "knn_acc": tdt.knn_label_accuracy(Z, y, k=10, device=dev)}
    for name, fit in fits.items():
        check_fit(SCRIPT, name, fit)
    return {"fits": fits}


if __name__ == "__main__":
    main()
