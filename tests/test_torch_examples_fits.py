"""The gallery's basics scripts that fit neighbour embeddings, on the CPU
at the runner's ``--fast`` sizes (their only sizes), in-process on one
torch thread: each passes its own gates (``examples/_common.py``), and
parametric UMAP scores as the JAX package's fit does from the same encoder
weights (``utils/interop.load_encoder_variables``), within 0.05.
"""

import jax
import numpy as np
import pytest

from _examples_run import check_gates, run
from _torch_threads import worker_threads  # noqa: F401

QUALITY_TOL = 0.05


@pytest.mark.parametrize("script", ["basics/demo_ne_methods", "basics/demo_tsne_swiss_roll",
                                    "basics/demo_tsne_vs_cosne"])
def test_script_passes_its_gates(script):
    check_gates(run(script))


def test_parametric_umap_scores_as_the_jax_package_from_its_weights(monkeypatch):
    """The JAX script's fit, then the port's from the JAX fit's starting
    weights: the same quality within QUALITY_TOL."""
    from torchdr_tpu import UMAP as JaxUMAP
    from torchdr_tpu.eval import knn_label_accuracy, silhouette_score
    from torchdr_tpu.utils.encoders import make_mlp_encoder as jax_mlp

    import torchdr_tpu_torch.affinity_matcher as engine
    from torchdr_tpu_torch.utils.interop import load_encoder_variables

    rng = np.random.default_rng(0)
    centers = rng.normal(scale=6.0, size=(5, 20))
    lab = rng.integers(0, 5, 1000)
    X = (centers[lab] + rng.normal(size=(1000, 20))).astype(np.float32)
    jm = JaxUMAP(n_neighbors=15, max_iter=300, optimizer="Adam", lr=1e-3,
                 encoder=jax_mlp(2, hidden=(64, 32)), random_state=0)
    Z_train = np.asarray(jm.fit_transform(X[:800]))
    Z_new = np.asarray(jm.transform(X[800:]))
    weights = jax.tree_util.tree_map(np.asarray, jm._encoder_variables0_)
    loaded = []

    def jax_weights(encoder, X, generator):
        loaded.append(load_encoder_variables(encoder, weights))
        return loaded[-1]

    monkeypatch.setattr(engine, "init_encoder_variables", jax_weights)
    out = run("basics/parametric_umap")
    assert len(loaded) == 1
    for name, Z, y in (("train", Z_train, lab[:800]), ("new", Z_new, lab[800:])):
        fit = out["fits"][name]
        assert np.array_equal(fit["labels"], y)
        assert abs(fit["knn_acc"] - knn_label_accuracy(Z, y, k=10)) <= QUALITY_TOL
        assert abs(fit["silhouette"] - silhouette_score(Z, y)) <= QUALITY_TOL
    check_gates(out)
