"""Parametric UMAP: train an encoder, embed unseen data (counterpart of
``examples/basics/parametric_umap.py``).

Run: python -m torchdr_tpu_torch.examples.basics.parametric_umap [--device cpu]
"""

import numpy as np

import torchdr_tpu_torch as tdt
from torchdr_tpu_torch.examples._common import check_fit, parser, timed_fit
from torchdr_tpu_torch.utils.encoders import make_mlp_encoder

SCRIPT = "basics/parametric_umap"


def main(argv=None) -> dict:
    args = parser(__doc__).parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=6.0, size=(5, 20))
    lab = rng.integers(0, 5, 1000)
    X = (centers[lab] + rng.normal(size=(1000, 20))).astype(np.float32)

    encoder = make_mlp_encoder(2, hidden=(64, 32))
    model = tdt.UMAP(
        n_neighbors=15, max_iter=300, optimizer="Adam", lr=1e-3,
        encoder=encoder, random_state=0, device=dev,
    )
    Z_train, seconds = timed_fit(model, X[:800])
    Z_new = np.asarray(model.transform(X[800:]))  # out-of-sample extension
    sil = tdt.silhouette_score(Z_new, lab[800:], device=dev)
    print("train:", Z_train.shape, "new:", Z_new.shape)
    print("silhouette (new data):", sil)

    fits = {
        "train": {"embedding": Z_train, "labels": lab[:800], "seconds": seconds,
                  "silhouette": tdt.silhouette_score(Z_train, lab[:800], device=dev),
                  "knn_acc": tdt.knn_label_accuracy(Z_train, lab[:800], k=10, device=dev)},
        "new": {"embedding": Z_new, "labels": lab[800:], "silhouette": sil,
                "knn_acc": tdt.knn_label_accuracy(Z_new, lab[800:], k=10, device=dev)},
    }
    for name, fit in fits.items():
        check_fit(SCRIPT, name, fit)
    return {"fits": fits, "silhouette_new": sil}


if __name__ == "__main__":
    main()
