"""One estimator's fit on ``chip_smoke.py``'s data: its steps, the gradient
norm at its last convergence check, wall time, 10-NN label accuracy
(``chip_smoke.knn_label_accuracy``) and the package's own silhouette and
k-means ARI of the embedding, in the JAX package (on the CPU) or in the port
(on the card by default). It is the evidence for the defaults that
``chip_smoke.py`` sets: a default that misses a gate or stops a fit early is
shown in both packages.

    python tests/_fit_quality.py jax InfoTSNE 60000
    python tests/_fit_quality.py port InfoTSNE 60000 lr=1500.0
    python tests/_fit_quality.py port TSNEkhorn 2000 min_grad_norm=1e-7 --device cpu
    python tests/_fit_quality.py jax PHATE 2000
    python tests/_fit_quality.py jax KernelPCA 5000 solver=lobpcg sigma=median

The rows are ``benchmarks.ivf_recall.make_clustered(n, 784, 50, seed=0)``;
each ``key=value`` is a constructor argument (``random_state=0`` always).
For KernelPCA, ``sigma=median`` (or a number) gives it
``NormalizedGaussianAffinity(sigma, normalization_dim=None)`` at the median
squared distance of ``chip_smoke.median_sq_distance``'s rows, and a LOBPCG
fit also reports its top eigenvalues' distance from the same package's eigh,
relative to λ₁ (the 1e-4 gate of ``chip_smoke.py``). It prints one JSON line.
"""

import argparse
import ast
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def _value(text):
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("package", choices=("jax", "port"))
    ap.add_argument("model")
    ap.add_argument("n", type=int)
    ap.add_argument("params", nargs="*", help="key=value constructor arguments")
    ap.add_argument("--device", default="auto", help="the port's device (auto: the card)")
    a = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from chip_smoke import knn_label_accuracy
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered

    params = dict(p.split("=", 1) for p in a.params)
    params = {k: _value(v) for k, v in params.items()}
    X, labels = make_clustered(a.n, 784, 50, seed=0)
    if a.package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        import torchdr_tpu as package

        device, kw = "cpu", {}
    else:
        import torchdr_tpu_torch as package

        device = str(package.base.resolve_device(a.device))
        kw = {"device": device}
    sigma = params.pop("sigma", None)
    if sigma is not None:
        from chip_smoke import median_sq_distance

        if sigma == "median":
            sigma = median_sq_distance(torch, X, device="cpu")

        def kernel():
            return package.NormalizedGaussianAffinity(sigma=sigma, normalization_dim=None, **kw)

        params["affinity"] = kernel()
    model = getattr(package, a.model)(random_state=0, **kw, **params)
    t0 = time.perf_counter()
    Z = np.asarray(model.fit_transform(X))
    wall = time.perf_counter() - t0
    dev = torch.device(device)
    acc = knn_label_accuracy(torch, torch.from_numpy(Z).to(dev), torch.from_numpy(labels).to(dev))
    out = {
        "package": a.package, "model": a.model, "n": a.n,
        "params": {k: v for k, v in params.items() if k != "affinity"}, "sigma": sigma,
        "steps": getattr(model, "n_iter_", None), "wall_s": wall, "knn10_label_acc": acc,
        "silhouette": float(package.silhouette_score(Z, labels, **kw)),
        "kmeans_ari": float(package.kmeans_ari(Z, labels, random_state=0, **kw)[0]),
        "finite": bool(np.isfinite(Z).all()),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    if hasattr(model, "_last_grad_norm_"):
        out["grad_norm"] = float(model._last_grad_norm_)
    if a.model == "KernelPCA":
        lam = np.asarray(model.eigenvalues_[:2])
        out["eigenvalues"] = lam.tolist()
        out["lobpcg_iterations"] = getattr(model, "lobpcg_iterations_", None)
        if params.get("solver") == "lobpcg":
            ref = package.KernelPCA(**kw, **{**params, "solver": "eigh",
                                              "affinity": kernel() if sigma else None})
            ref.fit_transform(X)
            ref_lam = np.asarray(ref.eigenvalues_[:2])
            out["eigh_eigenvalues"] = ref_lam.tolist()
            out["eig_gap_rel_to_lambda1"] = float(np.abs(lam - ref_lam).max() / ref_lam[0])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
