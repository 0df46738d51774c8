"""The JAX package's results for the port's examples gallery.

Runs the code of each JAX script under ``examples/`` on the CPU (8 virtual
devices, as ``scripts/run_examples.py`` runs them), at the runner's
``--fast`` sizes, and writes what the port's gates compare with to
``torchdr_tpu_torch/examples/jax_reference.json``: each labelled fit's
10-NN label accuracy and silhouette, the swiss roll's neighbourhood
preservation, the PCA-to-engine subspace alignment (the script's
no-scikit-learn data: 500 x 64 normal rows) and its fit's ``init="normal"``
draw, the incremental PCAs' explained variances and the entropic
affinity's calibrated bandwidths.
The JAX scripts' own helpers (data generators, the custom affinity) are
loaded from their files and used as they are.

    python tests/_examples_reference.py [--only SCRIPT ...] [--full] [--print]

``--full`` adds the single-cell LargeVis fit at the script's own 44,808
rows (``full_size``); ``--print`` prints the results instead of
writing the file;
``tests/test_torch_examples.py`` checks the file's cheap entries against
the JAX package in every run.
"""

import argparse
import json
import os
import pathlib
import runpy
import sys
import time

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
os.environ.setdefault("TORCHDR_TPU_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
OUT = ROOT / "torchdr_tpu_torch" / "examples" / "jax_reference.json"

import torchdr_tpu as tdr  # noqa: E402
from torchdr_tpu.parallel import make_mesh  # noqa: E402


def script_globals(rel: str) -> dict:
    """The JAX script's module globals (its helpers), without running main."""
    return runpy.run_path(str(ROOT / "examples" / rel), run_name="jax_example")


def scores(Z, y) -> dict:
    Z = np.asarray(Z)
    return {"knn_acc": float(tdr.knn_label_accuracy(Z, y, k=10)),
            "silhouette": float(tdr.silhouette_score(Z, y))}


def basic_usage() -> dict:
    from sklearn.datasets import make_moons

    X, y = make_moons(n_samples=500, noise=0.05, random_state=0)
    X = X.astype(np.float32)
    out = {}
    for name, model in [
        ("UMAP", tdr.UMAP(n_neighbors=15, random_state=0)),
        ("TSNE", tdr.TSNE(perplexity=30, random_state=0)),
        ("LargeVis", tdr.LargeVis(perplexity=30, random_state=0)),
        ("PCA", tdr.PCA()),
    ]:
        Z = np.asarray(model.fit_transform(X))
        out[name] = dict(scores(Z, y),
                         preservation=float(tdr.neighborhood_preservation(X, Z, K=15)))
    return {"fits": out}


def demo_ne_methods() -> dict:
    from sklearn.datasets import make_moons

    X, y = make_moons(n_samples=500, noise=0.05, random_state=0)
    X = X.astype(np.float32)
    methods = {
        "TSNE": tdr.TSNE(perplexity=30, max_iter=500, random_state=0),
        "SNE": tdr.SNE(perplexity=30, max_iter=500, random_state=0),
        "UMAP": tdr.UMAP(n_neighbors=30, max_iter=500, random_state=0),
        "LargeVis": tdr.LargeVis(perplexity=30, max_iter=500, random_state=0),
        "InfoTSNE": tdr.InfoTSNE(perplexity=30, max_iter=500, random_state=0),
        "PACMAP": tdr.PACMAP(n_neighbors=10, max_iter=450, random_state=0),
    }
    return {"fits": {name: scores(m.fit_transform(X), y) for name, m in methods.items()}}


def demo_tsne_swiss_roll() -> dict:
    from sklearn.datasets import make_swiss_roll

    X, _ = make_swiss_roll(n_samples=1000, noise=0.05, random_state=0)
    X = X.astype(np.float32)
    Z = np.asarray(tdr.TSNE(perplexity=30, max_iter=800, random_state=0).fit_transform(X))
    return {"preservation": float(tdr.neighborhood_preservation(X, Z, K=15))}


def demo_pca_via_affinity_matcher() -> dict:
    g = script_globals("basics/demo_pca_via_affinity_matcher.py")
    X = np.random.default_rng(0).normal(size=(500, 64)).astype(np.float32)
    X = X - X.mean(axis=0)
    Z_pca = np.asarray(tdr.PCA(n_components=2, random_state=0).fit_transform(X))
    model = tdr.AffinityMatcher(
        affinity_in=g["ScalarProductAffinity"](), affinity_out=g["ScalarProductAffinity"](),
        loss_fn="square_loss", init="normal", lr=1e1, max_iter=500, random_state=0,
    )
    Z_am = np.asarray(model.fit_transform(X))
    # init="normal"'s draw, before the fit scales it (affinity_matcher.py)
    draw = jax.random.normal(model._root_key(), X[:, :2].shape, dtype=X.dtype)
    return {"alignment": g["subspace_alignment"](Z_pca, Z_am),
            "init": np.asarray(draw, np.float64).tolist()}


def incremental_pca() -> dict:
    g = script_globals("basics/incremental_pca.py")
    ipca = tdr.IncrementalPCA(n_components=4)
    ipca.fit_transform(g["batch_stream"]())
    epca = tdr.ExactIncrementalPCA(n_components=4, batch_size=512)
    epca.fit_transform(list(g["batch_stream"]()))
    return {
        "IncrementalPCA": {
            "explained_variance": np.asarray(ipca.explained_variance_, np.float64).tolist(),
            "explained_variance_ratio":
                np.asarray(ipca.explained_variance_ratio_, np.float64).tolist()},
        "ExactIncrementalPCA": {
            "explained_variance": np.asarray(epca.explained_variance_, np.float64).tolist()},
    }


def parametric_umap() -> dict:
    from torchdr_tpu.utils.encoders import make_mlp_encoder

    rng = np.random.default_rng(0)
    centers = rng.normal(scale=6.0, size=(5, 20))
    lab = rng.integers(0, 5, 1000)
    X = (centers[lab] + rng.normal(size=(1000, 20))).astype(np.float32)
    model = tdr.UMAP(n_neighbors=15, max_iter=300, optimizer="Adam", lr=1e-3,
                     encoder=make_mlp_encoder(2, hidden=(64, 32)), random_state=0)
    Z_train = model.fit_transform(X[:800])
    Z_new = model.transform(X[800:])
    return {"fits": {"train": scores(Z_train, lab[:800]), "new": scores(Z_new, lab[800:])}}


def demo_tsne_vs_cosne() -> dict:
    g = script_globals("basics/demo_tsne_vs_cosne.py")
    X, y = g["hierarchical_blobs"]()
    Zt = tdr.TSNE(perplexity=20, max_iter=500, random_state=0).fit_transform(X)
    Zc = tdr.COSNE(perplexity=20, max_iter=500, lr=1e-1, gamma=2.0,
                   random_state=0).fit_transform(X)
    return {"fits": {"TSNE": scores(Zt, y), "COSNE": scores(Zc, y)}}


def demo_ea_adaptivity() -> dict:
    from torchdr_tpu.affinity import EntropicAffinity

    rng = np.random.default_rng(0)
    dense = rng.normal(scale=0.1, size=(150, 2))
    sparse = np.array([4.0, 0.0]) + rng.normal(scale=1.0, size=(150, 2))
    X = np.concatenate([dense, sparse]).astype(np.float32)
    ea = EntropicAffinity(perplexity=30, sparsity=False)
    ea(X)
    return {"eps": np.asarray(ea.eps_, np.float64).tolist()}


def distributed_umap() -> dict:
    n = 1024  # the runner's --fast size
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(8, 32))
    lab = rng.integers(0, 8, n)
    X = (centers[lab] + rng.normal(size=(n, 32))).astype(np.float32)
    model = tdr.UMAP(n_neighbors=15, max_iter=200, random_state=0, distributed=True,
                     mesh=make_mesh())
    return {"fits": {"UMAP": scores(model.fit_transform(X), lab)}}


def knn_accuracy_benchmark() -> dict:
    mesh = make_mesh(len(jax.devices()))
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(10, 32))
    y = rng.integers(0, 10, 20_000)
    X = (centers[y] + rng.normal(size=(20_000, 32))).astype(np.float32)
    Z = tdr.UMAP(n_neighbors=15, max_iter=200, random_state=0,
                 distributed=True, mesh=mesh).fit_transform(X)
    return {"fits": {"UMAP": scores(Z, y)}}


def neighborhood_preservation_benchmark() -> dict:
    mesh = make_mesh(len(jax.devices()))
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=6.0, size=(12, 32))
    y = rng.integers(0, 12, 10_000)
    X = (centers[y] + rng.normal(size=(10_000, 32))).astype(np.float32)
    fits = {}
    for name, model in {
        "UMAP": tdr.UMAP(n_neighbors=15, max_iter=300, random_state=0,
                         distributed=True, mesh=mesh),
        "LargeVis": tdr.LargeVis(perplexity=15, max_iter=300, random_state=0,
                                 distributed=True, mesh=mesh),
    }.items():
        Z = np.asarray(model.fit_transform(X))
        fits[name] = dict(scores(Z, y),
                          preservation=float(tdr.neighborhood_preservation(X, Z, K=15,
                                                                            mesh=mesh)))
    return {"fits": fits}


def single_cell(n: int = 3000, names=("TSNE", "LargeVis")) -> dict:
    """At the runner's --fast size; with ``--full``, LargeVis also at the
    script's own size (the Macosko-2015 row count; the exact t-SNE there
    takes hours on the CPU)."""
    g = script_globals("single_cell/single_cell.py")
    X, y = g["synthetic_dataset"](n, np.random.default_rng(0))
    models = {
        "TSNE": lambda: tdr.TSNE(perplexity=30, max_iter=500, random_state=0),
        "LargeVis": lambda: tdr.LargeVis(perplexity=30, max_iter=1000, n_negatives=50, lr=1e0,
                                         random_state=0),
    }
    return {"fits": {name: scores(models[name]().fit_transform(X), y) for name in names}}


FULL_SINGLE_CELL = 44_808  # the script's default, the Macosko-2015 size

SCRIPTS = {
    "basics/basic_usage": basic_usage,
    "basics/demo_ne_methods": demo_ne_methods,
    "basics/demo_tsne_swiss_roll": demo_tsne_swiss_roll,
    "basics/demo_pca_via_affinity_matcher": demo_pca_via_affinity_matcher,
    "basics/incremental_pca": incremental_pca,
    "basics/parametric_umap": parametric_umap,
    "basics/demo_tsne_vs_cosne": demo_tsne_vs_cosne,
    "affinities/demo_ea_adaptivity": demo_ea_adaptivity,
    "distributed/distributed_umap": distributed_umap,
    "distributed/knn_accuracy_benchmark": knn_accuracy_benchmark,
    "distributed/neighborhood_preservation_benchmark": neighborhood_preservation_benchmark,
    "single_cell/single_cell": single_cell,
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--print", action="store_true")
    args = ap.parse_args()
    results = json.loads(OUT.read_text()) if OUT.exists() else {}
    for name, fn in SCRIPTS.items():
        if args.only and name not in args.only:
            continue
        t0 = time.perf_counter()
        results[name] = fn()
        if args.full and name == "single_cell/single_cell":
            results[name]["full_size"] = dict(single_cell(FULL_SINGLE_CELL, ("LargeVis",)),
                                              n=FULL_SINGLE_CELL)
        print(f"{name}: {time.perf_counter() - t0:.1f} s {json.dumps(results[name])[:300]}",
              flush=True)
    if not args.print:
        OUT.write_text(json.dumps(dict(sorted(results.items())), indent=1) + "\n")


if __name__ == "__main__":
    main()
