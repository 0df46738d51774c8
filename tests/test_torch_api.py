"""The port's public surface against the JAX package's: ``PCA.transform``
of new rows, the options ``AffinityMatcher`` takes (with their defaults,
and other values) and refuses, and ``Affinity.clear_memory``.

The same numpy inputs, made from a seed, go through both packages; the port
runs with ``device="cpu"``.
"""

import inspect

import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu import AffinityMatcher as JaxAffinityMatcher
from torchdr_tpu import PCA as JaxPCA
from torchdr_tpu import UMAPAffinity as JaxUMAPAffinity
from torchdr_tpu_torch import (
    PCA,
    TSNE,
    AffinityMatcher,
    NormalizedGaussianAffinity,
    NormalizedStudentAffinity,
    UMAPAffinity,
)


def _blobs(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(4, d))
    return (centers[rng.integers(0, 4, n)] + rng.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("method", ["svd", "covariance"])
@pytest.mark.parametrize("form", ["float32", "float64", "torch"])
def test_pca_transform_of_new_rows_matches_jax(method, form):
    """``transform`` of rows the fit did not see: (X − mean_) @ components_.T
    in float32 in both packages, within 1e-5 of the largest entry (the two
    fits' components agree to float32 rounding, and the signs follow the
    same convention); a tensor comes back as a tensor, and ``transform()``
    is still the training embedding."""
    X = _blobs(240, 12, 0)
    new = {"float32": X[200:], "float64": X[200:].astype(np.float64),
           "torch": torch.from_numpy(X[200:])}[form]
    jm = JaxPCA(n_components=3, method=method)
    jm.fit(X[:200])
    tm = PCA(n_components=3, method=method, device="cpu")
    emb = tm.fit_transform(X[:200])
    want = np.asarray(jm.transform(np.asarray(new)))
    got = tm.transform(new)
    assert isinstance(got, torch.Tensor) == (form == "torch")
    got = np.asarray(got)
    assert got.shape == (40, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)
    np.testing.assert_array_equal(tm.transform(), emb)


def test_pca_transform_before_fit_raises():
    with pytest.raises(ValueError, match="not fitted"):
        PCA(device="cpu").transform(np.zeros((3, 4), np.float32))


# The options of the JAX package's AffinityMatcher beyond the estimators'
# own (the generic loss, encoders, bounded dispatches), each with a value
# other than its default.
_OPTIONS = {
    "affinity_out": NormalizedStudentAffinity(device="cpu"),
    "kwargs_affinity_out": {"log": True},
    "loss_fn": "cross_entropy_loss",
    "kwargs_loss": {"log": True},
    "encoder": torch.nn.Linear(4, 2),
    "max_iters_per_dispatch": 2,
}


def test_affinity_matcher_takes_the_jax_options_with_their_defaults():
    """The six options have the JAX package's names and defaults, and are
    parameters of the port's constructor (not swallowed by ``**kwargs``)."""
    port = inspect.signature(AffinityMatcher.__init__).parameters
    ref = inspect.signature(JaxAffinityMatcher.__init__).parameters
    for name in _OPTIONS:
        assert name in port, name
        assert port[name].default == ref[name].default, name
    m = AffinityMatcher(UMAPAffinity(device="cpu"), device="cpu")
    for name in _OPTIONS:
        assert getattr(m, name) == ref[name].default


@pytest.mark.parametrize("option", sorted(_OPTIONS))
def test_affinity_matcher_refuses_an_unported_option(option):
    """Each option, refused before its port, is taken: the matcher (the
    generic cross-entropy between a Gaussian P and the Student affinity of
    Z) fits five steps with it, and an estimator built on the matcher keeps
    it."""
    X = _blobs(30, 4, 2)
    kw = {"affinity_out": NormalizedStudentAffinity(device="cpu"),
          "loss_fn": "cross_entropy_loss", option: _OPTIONS[option]}
    m = AffinityMatcher(NormalizedGaussianAffinity(device="cpu"), max_iter=5, random_state=0,
                        device="cpu", **kw)
    Z = m.fit_transform(X)
    assert getattr(m, option) is _OPTIONS[option]
    assert Z.shape == (30, 2) and np.isfinite(Z).all() and m.n_iter_ == 5
    assert getattr(TSNE(device="cpu", **{option: _OPTIONS[option]}), option) is _OPTIONS[option]


def test_affinity_matcher_precomputed_is_not_ported_and_unknown_loss_is_refused():
    """``"precomputed"`` is taken now; any other string, and an unknown
    loss, are refused as the JAX package refuses them."""
    assert AffinityMatcher("precomputed", device="cpu").affinity_in == "precomputed"
    with pytest.raises(ValueError, match="Affinity instance"):
        AffinityMatcher("umap", device="cpu")
    # the JAX package's own check of the name comes first
    for cls in (JaxAffinityMatcher, AffinityMatcher):
        with pytest.raises(ValueError, match="not supported"):
            cls(UMAPAffinity(device="cpu") if cls is AffinityMatcher else "precomputed",
                loss_fn="l2")


def _public_fitted(obj):
    return sorted(n for n in vars(obj) if n.endswith("_") and not n.startswith("_"))


def test_affinity_clear_memory_matches_jax():
    """After a call, ``clear_memory`` deletes every public fitted attribute
    (a name ending in ``_``) in both packages and keeps the constructor's
    parameters; the affinity computes the same values after it."""
    X = _blobs(120, 6, 1)
    jaff = JaxUMAPAffinity(n_neighbors=10)
    taff = UMAPAffinity(n_neighbors=10, device="cpu")
    jaff(X)
    P1, I1 = taff(X)
    assert _public_fitted(taff)  # the call's timings at least
    params = {n: v for n, v in vars(taff).items() if not n.endswith("_")}
    for aff in (jaff, taff):
        aff.clear_memory()
        assert _public_fitted(aff) == []
    assert {n: v for n, v in vars(taff).items() if not n.endswith("_")}.keys() == params.keys()
    assert taff.n_neighbors == 10 and taff.device == "cpu"
    P2, I2 = taff(X)
    assert torch.equal(P1, P2) and torch.equal(I1, I2)
    assert "knn" in taff.timings_
