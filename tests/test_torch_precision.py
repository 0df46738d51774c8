"""Full float32 at the port's public entry points, whatever the caller set.

The JAX package passes ``precision=HIGHEST`` on each product; torch has only
process-wide switches (``set_float32_matmul_precision``, ``allow_tf32`` and,
since torch 2.9, ``fp32_precision``), which a user's training script flips.
Each public entry point runs inside ``utils.wrappers.full_float32``: inside,
every float32 product runs without TF32; on return the caller's setting is
back, also after an exception. Importing the package changes nothing.

This file imports neither JAX nor the JAX package; its ``cuda`` test runs on
the card with ``python -m pytest --noconftest -q tests/test_torch_precision.py``.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torchdr_tpu_torch as tdt
from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu_torch.ops import kmeans, metrics
from torchdr_tpu_torch.utils.wrappers import full_float32

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def user_high():
    """The caller's ``set_float32_matmul_precision("high")``, undone after."""
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    yield
    torch.set_float32_matmul_precision(before)


@pytest.fixture
def products_seen(monkeypatch):
    """The precision (allow_tf32, matmul precision) that each float32 product
    of the port sees: ``torch.matmul``, ``bmm`` and ``baddbmm``, the metrics'
    gram, and k-means' distances from its ``@`` gram, recorded where they
    are called."""
    seen = []

    def record(fn):
        def inner(*args, **kwargs):
            seen.append((torch.backends.cuda.matmul.allow_tf32,
                         torch.get_float32_matmul_precision()))
            return fn(*args, **kwargs)
        return inner

    for name in ("matmul", "bmm", "baddbmm"):
        monkeypatch.setattr(torch, name, record(getattr(torch, name)))
    monkeypatch.setattr(metrics, "_gram", record(metrics._gram))
    monkeypatch.setattr(kmeans, "sq_dists_from_gram", record(kmeans.sq_dists_from_gram))
    return seen


def _rows(n=240, d=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=6.0, size=(4, d))
    labels = rng.integers(0, 4, n)
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32), labels


def _umap_fit(X, y):
    tdt.UMAP(n_neighbors=10, max_iter=5, random_state=0, device="cpu").fit_transform(X)


def _ivf(X, y):
    Xt = torch.from_numpy(X)
    tdt.ivf_knn(Xt, k=5, index=tdt.ivf_build(Xt, n_clusters=8, device="cpu"))


ENTRY_POINTS = {
    "UMAP.fit_transform": _umap_fit,
    "PCA.fit_transform": lambda X, y: tdt.PCA(method="covariance", device="cpu").fit_transform(X),
    "UMAPAffinity.__call__": lambda X, y: tdt.UMAPAffinity(n_neighbors=10, device="cpu")(X),
    "knn_graph": lambda X, y: tdt.knn_graph(torch.from_numpy(X), k=5),
    "pairwise_distances": lambda X, y: tdt.pairwise_distances(torch.from_numpy(X)),
    "ivf_build and ivf_knn": _ivf,
    "kmeans_fit": lambda X, y: tdt.kmeans_fit(torch.from_numpy(X), 4),
    "silhouette_score": lambda X, y: tdt.silhouette_score(X, y, device="cpu"),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_point_runs_at_full_float32_and_gives_the_user_s_setting_back(
        entry, user_high, products_seen):
    X, y = _rows()
    ENTRY_POINTS[entry](X, y)
    assert products_seen, "no float32 product recorded"
    assert set(products_seen) == {(False, "highest")}
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cuda.matmul.allow_tf32


def test_importing_the_port_changes_no_precision_setting():
    code = ("import torch; m = torch.backends.cuda.matmul; before = m.allow_tf32; "
            "torch.set_float32_matmul_precision('high'); import torchdr_tpu_torch; "
            "print(before, torch.get_float32_matmul_precision(), m.allow_tf32, "
            "torch.backends.cudnn.allow_tf32)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=180)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "high", "True", "True"]


def test_full_float32_nests_and_restores_on_an_exception(user_high):
    with pytest.raises(RuntimeError, match="inner"):
        with full_float32():
            assert torch.get_float32_matmul_precision() == "highest"
            with full_float32():
                assert not torch.backends.cuda.matmul.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
            raise RuntimeError("inner")
    assert torch.get_float32_matmul_precision() == "high"
    assert torch.backends.cuda.matmul.allow_tf32


def test_full_float32_gives_back_a_per_backend_setting():
    """A caller who set torch's per-backend switch (``fp32_precision``, where
    torch has it) gets exactly that back, though torch's legacy reading of
    that state raises."""
    matmul = torch.backends.cuda.matmul
    if getattr(matmul, "fp32_precision", None) is None:
        pytest.skip("this torch has no per-backend fp32_precision")
    before = matmul.fp32_precision
    matmul.fp32_precision = "tf32"
    try:
        with full_float32():
            assert matmul.fp32_precision == "ieee"
            assert not matmul.allow_tf32
        assert matmul.fp32_precision == "tf32"
    finally:
        matmul.fp32_precision = before
    assert matmul.fp32_precision == before


@pytest.mark.cuda
def test_knn_graph_ids_on_the_card_ignore_the_user_s_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=4.0, size=(50, 784))
    X = torch.from_numpy(
        (centers[rng.integers(0, 50, 8000)] + rng.normal(size=(8000, 784))).astype(np.float32)
    ).cuda()
    d0, i0 = tdt.knn_graph(X, k=15)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        d1, i1 = tdt.knn_graph(X, k=15)
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)
    assert torch.equal(i0, i1)
    torch.testing.assert_close(d1, d0, rtol=1e-6, atol=0)
