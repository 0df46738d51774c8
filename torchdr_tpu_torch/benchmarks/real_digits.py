"""Real-data quality record on the handwritten digits (counterpart of
``benchmarks/real_digits.py``): 1,797 images of 8 x 8 pixels, 10 classes.

    python -m torchdr_tpu_torch.benchmarks.real_digits [--n N] [--max-iter T]
        [--device auto|cpu]

The digits are the one real image dataset that the repository holds
(``data/digits.csv.gz``, see :func:`load_digits`). Each of the JAX script's
six estimators, with its arguments, fits them twice (cold, then warm), and
each fit prints one ``JSON {...}`` line with the JAX script's keys: its
seconds, the silhouette, ``trustworthiness15`` (:func:`trustworthiness`),
the 10-NN label accuracy and the 15-NN neighbourhood preservation (the
port's ``eval``). scikit-learn's t-SNE, the external yardstick, cannot run
on the card's machine: its line is the one that the JAX script printed on
the CPU, read from ``real_digits_reference.json`` (``"recorded": "cpu"``,
no seconds), with the JAX script's own readings of the six fits, which
set the gates (:func:`gates`).

``--n`` keeps the first n rows and ``--max-iter`` sets every estimator's
``max_iter`` (for a short run on the CPU). ``main`` returns the readings,
each fit's embedding and steps, and the gates.
"""

from __future__ import annotations

import argparse
import gzip
import json
import pathlib
import time

import numpy as np
import torch

from ..examples._common import acc_gate

DATA = pathlib.Path(__file__).with_name("data") / "digits.csv.gz"
REFERENCE = pathlib.Path(__file__).with_name("real_digits_reference.json")


def load_digits():
    """The digits as ``sklearn.datasets.load_digits(return_X_y=True)``
    returns them: X float64 (1797, 64), pixel counts 0-16; y int, 0-9.

    ``data/digits.csv.gz`` is scikit-learn's bundled copy (1.9.0, byte for
    byte) of the test set of the UCI "Optical Recognition of Handwritten
    Digits" data set (E. Alpaydin, C. Kaynak, 1998;
    https://doi.org/10.24432/C50P49), under UCI's CC BY 4.0 licence, as
    distributed with scikit-learn under its BSD-3-Clause licence. Each row
    is 64 pixel counts then the class.
    """
    with gzip.open(DATA, mode="rt", encoding="utf-8") as f:
        data = np.loadtxt(f, delimiter=",")
    return data[:, :-1], data[:, -1].astype(int, copy=False)


def log(**kw):
    print("JSON " + json.dumps(kw), flush=True)


def reference() -> dict:
    """The JAX script's record on the CPU (``tests/_real_digits_reference.py``)."""
    return json.loads(REFERENCE.read_text())


def gates(name: str, ref: dict) -> dict:
    """Fit ``name``'s floors from the JAX script's CPU reading in ``ref``
    (:func:`reference`): 10-NN label accuracy by the gallery's rule
    (``examples._common.acc_gate``); trustworthiness that reading less 0.01."""
    jax = ref["fits"][name]
    return {"knn_acc10": acc_gate(jax["knn_acc10"]),
            "trustworthiness15": jax["trustworthiness15"] - 0.01}


def trustworthiness(X, Z, k: int = 15, device="cpu") -> float:
    """scikit-learn's ``trustworthiness(X, Z, n_neighbors=k)`` on ``device``:
    each point's k nearest embedded neighbours are ranked in its input-space
    order (itself excluded, ties in either space by a stable sort, so that
    Z = X reads 1), and the ranks' excess over k, summed, is scaled by
    2 / (n k (2n - 3k - 1)). Distances in float64 from the differences (no
    gram), so integer pixels tie exactly."""
    X = torch.as_tensor(np.asarray(X), dtype=torch.float64, device=device)
    Z = torch.as_tensor(np.asarray(Z), dtype=torch.float64, device=device)
    n = X.shape[0]
    mode = "donot_use_mm_for_euclid_dist"
    dX = torch.cdist(X, X, compute_mode=mode).fill_diagonal_(float("inf"))
    order = torch.argsort(dX, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(1, n + 1, device=X.device).expand(n, n))
    dZ = torch.cdist(Z, Z, compute_mode=mode).fill_diagonal_(float("inf"))
    nbrs = torch.argsort(dZ, dim=1, stable=True)[:, :k]
    excess = (torch.gather(rank, 1, nbrs) - k).clamp(min=0).sum()
    return 1.0 - float(excess) * (2.0 / (n * k * (2.0 * n - 3.0 * k - 1.0)))


def estimators(max_iter=None, device="auto") -> dict:
    """The JAX script's six estimators with its arguments."""
    from torchdr_tpu_torch import PACMAP, SNE, TSNE, UMAP, InfoTSNE, LargeVis

    def it(t):
        return t if max_iter is None else max_iter

    return {
        "UMAP": UMAP(n_neighbors=15, max_iter=it(500), random_state=0, device=device),
        "TSNE": TSNE(perplexity=30, max_iter=it(500), random_state=0, device=device),
        "LargeVis": LargeVis(n_neighbors=15, max_iter=it(500), random_state=0, device=device),
        "InfoTSNE": InfoTSNE(perplexity=30, max_iter=it(500), random_state=0, device=device),
        "PACMAP": PACMAP(n_neighbors=10, max_iter=it(450), random_state=0, device=device),
        "SNE": SNE(perplexity=30, max_iter=it(500), random_state=0, device=device),
    }


def main(argv=None, watch=None) -> dict:
    """``watch``, where given, is called as ``watch(name, model)`` around each
    fit and returns a context manager that the fit runs inside (the smoke
    run counts each fit's kernel launches so)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=None, help="keep the first n rows")
    parser.add_argument("--max-iter", type=int, default=None)
    parser.add_argument("--device", default="auto",
                        help="'auto' (the card, or raise without one) or 'cpu'")
    args = parser.parse_args(argv)

    from contextlib import nullcontext

    from torchdr_tpu_torch.base import resolve_device
    from torchdr_tpu_torch.eval import (
        knn_label_accuracy,
        neighborhood_preservation,
        silhouette_score,
    )

    dev = resolve_device(args.device)
    X, y = load_digits()
    X, y = X[:args.n].astype(np.float32), y[:args.n]
    n = X.shape[0]
    dataset = dict(name="sklearn_digits", n=n, d=X.shape[1], classes=int(y.max() + 1))
    log(step="dataset", **dataset)

    ref = reference()
    out = {"dataset": dataset, "fits": {}}
    for name, model in estimators(args.max_iter, dev).items():
        seconds = []
        for _ in ("cold", "warm"):
            with watch(name, model) if watch else nullcontext():
                t0 = time.perf_counter()
                Z = np.asarray(model.fit_transform(X))  # numpy: the fit has ended
                seconds.append(time.perf_counter() - t0)
        readings = dict(
            cold_s=round(seconds[0], 2), warm_s=round(seconds[1], 2),
            silhouette=round(silhouette_score(Z, y, device=dev), 4),
            trustworthiness15=round(trustworthiness(X, Z, 15, device=dev), 4),
            knn_acc10=round(knn_label_accuracy(Z, y, k=10, device=dev), 4),
            preservation15=round(neighborhood_preservation(X, Z, K=15, device=dev), 4))
        log(step="fit", model=name, **readings)
        out["fits"][name] = dict(readings, steps=model.n_iter_, embedding=Z, gates=gates(name, ref))

    # scikit-learn's t-SNE: the JAX script's CPU line (this machine may lack scikit-learn)
    sk = dict(cold_s=None, **ref["fits"]["sklearn_TSNE_cpu"], recorded="cpu",
              sklearn=ref["sklearn"], n=ref["dataset"]["n"])
    log(step="fit", model="sklearn_TSNE_cpu", **sk)
    out["sklearn_TSNE_cpu"] = sk
    return out


if __name__ == "__main__":
    main()
