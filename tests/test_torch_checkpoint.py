"""The port's estimator checkpoints (``utils/checkpoint.py``), alone and
against the JAX package's.

Both packages write the same ``<path>.npz`` (fitted arrays) and
``<path>.json`` (class, module, params), so a checkpoint of one loads into
the other for its fitted arrays: a PCA's ``transform`` and a UMAP's
``embedding_`` are held within 1e-5 across (float32 arrays, products summed
in other orders by XLA and torch), and bit for bit in a round trip within
the port. A parametric fit's encoder goes to the port's own
``<path>.encoder.npz``, held within the JAX package's own 1e-5
(``tests/test_parametric.py``); a flax ``.flax`` file is refused with the
way across named.
"""

import json

import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.models.neighbor.umap import UMAP as JaxUMAP
from torchdr_tpu.models.spectral.pca import PCA as JaxPCA
from torchdr_tpu.utils import checkpoint as jax_checkpoint
from torchdr_tpu_torch import PCA, UMAP, KernelPCA
from torchdr_tpu_torch.utils import load_estimator, make_mlp_encoder, save_estimator

TOL = 1e-5


@pytest.fixture(scope="module")
def X():
    return np.random.default_rng(0).normal(size=(80, 6)).astype(np.float32)


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(1)
    centres = rng.normal(scale=5.0, size=(3, 6))
    return (centres[rng.integers(0, 3, 60)] + rng.normal(size=(60, 6))).astype(np.float32)


def _umap(**kw):
    return UMAP(n_neighbors=5, max_iter=10, random_state=0, device="cpu", **kw)


def test_pca_round_trip_is_bit_for_bit(X, tmp_path):
    model = PCA(n_components=3, device="cpu")
    Z = model.fit_transform(X)
    save_estimator(model, str(tmp_path / "pca"))
    meta = json.loads((tmp_path / "pca.json").read_text())
    assert meta["class"] == "PCA" and meta["params"]["n_components"] == 3
    assert set(np.load(tmp_path / "pca.npz").files) == {"embedding_", "mean_", "components_"}

    fresh = load_estimator(PCA(n_components=3, device="cpu"), str(tmp_path / "pca"))
    assert fresh.is_fitted_ and fresh.device_ == torch.device("cpu")
    assert isinstance(fresh.mean_, torch.Tensor) and fresh.mean_.device.type == "cpu"
    np.testing.assert_array_equal(fresh.transform(X), model.transform(X))
    np.testing.assert_array_equal(fresh.transform(), Z)


def test_umap_round_trip_keeps_the_embedding_and_skips_non_arrays(blobs, tmp_path):
    model = _umap()
    model.fit_transform(blobs)
    save_estimator(model, str(tmp_path / "umap"))
    saved = set(np.load(tmp_path / "umap.npz").files)
    # device_ (a torch.device), timings_ (a dict) and is_fitted_ (a bool) are not arrays
    assert saved == {"embedding_", "n_iter_", "n_samples_in_", "n_features_in_"}

    fresh = load_estimator(_umap(), str(tmp_path / "umap"))
    assert torch.equal(fresh.embedding_, model.embedding_)
    assert fresh.n_iter_ == model.n_iter_ and isinstance(fresh.n_iter_, int)
    assert fresh._input_format_ == "numpy"
    np.testing.assert_array_equal(fresh.transform(), model.embedding_.numpy())


def test_parametric_umap_round_trip(blobs, tmp_path):
    def make():
        return _umap(encoder=make_mlp_encoder(2, (16,)), optimizer="Adam", lr=1e-3)

    model = make()
    model.fit_transform(blobs)
    ref = model.transform(blobs[:7])
    save_estimator(model, str(tmp_path / "pumap"))
    sidecar = np.load(tmp_path / "pumap.encoder.npz")
    assert sorted(sidecar.files) == sorted(model.encoder_variables_)

    fresh = load_estimator(make(), str(tmp_path / "pumap"))
    out = fresh.transform(blobs[:7])
    assert np.allclose(out, ref, atol=TOL)
    assert all(v.device.type == "cpu" for v in fresh.encoder_variables_.values())


def test_encoder_of_other_widths_is_refused(blobs, tmp_path):
    model = _umap(encoder=make_mlp_encoder(2, (16,)), optimizer="Adam", lr=1e-3)
    model.fit_transform(blobs)
    save_estimator(model, str(tmp_path / "pumap"))
    other = _umap(encoder=make_mlp_encoder(2, (8,)), optimizer="Adam", lr=1e-3)
    with pytest.raises(ValueError, match="encoder weights"):
        load_estimator(other, str(tmp_path / "pumap"))


def test_class_mismatch_raises(X, tmp_path):
    model = PCA(device="cpu").fit(X)
    save_estimator(model, str(tmp_path / "m"))
    with pytest.raises(ValueError, match="checkpoint"):
        load_estimator(KernelPCA(device="cpu"), str(tmp_path / "m"))


def test_flax_only_checkpoint_names_the_way_across(blobs, tmp_path):
    model = _umap()
    model.fit_transform(blobs)
    save_estimator(model, str(tmp_path / "pumap"))
    (tmp_path / "pumap.flax").write_bytes(b"\x80")  # what the JAX package writes beside
    fresh = _umap(encoder=make_mlp_encoder(2, (16,)), optimizer="Adam", lr=1e-3)
    with pytest.raises(ValueError, match="interop.load_encoder_variables"):
        load_estimator(fresh, str(tmp_path / "pumap"))
    assert not fresh.is_fitted_


def test_auto_device_load_raises_without_a_card(X, tmp_path, monkeypatch):
    save_estimator(PCA(device="cpu").fit(X), str(tmp_path / "pca"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        load_estimator(PCA(), str(tmp_path / "pca"))


def test_jax_pca_checkpoint_loads_into_the_port_and_back(X, tmp_path):
    jax_model = JaxPCA(n_components=3)
    jax_model.fit_transform(X)
    jax_Z = np.asarray(jax_model.transform(X))
    jax_checkpoint.save_estimator(jax_model, str(tmp_path / "jax_pca"))
    port = load_estimator(PCA(n_components=3, device="cpu"), str(tmp_path / "jax_pca"))
    np.testing.assert_allclose(port.transform(X), jax_Z, atol=TOL)

    port_model = PCA(n_components=3, device="cpu")
    port_model.fit_transform(X)
    save_estimator(port_model, str(tmp_path / "port_pca"))
    back = jax_checkpoint.load_estimator(JaxPCA(n_components=3), str(tmp_path / "port_pca"))
    np.testing.assert_allclose(np.asarray(back.transform(X)), port_model.transform(X), atol=TOL)


def test_umap_checkpoint_crosses_between_the_packages(blobs, tmp_path):
    jax_model = JaxUMAP(n_neighbors=5, max_iter=10, random_state=0)
    jax_model.fit_transform(blobs)
    jax_checkpoint.save_estimator(jax_model, str(tmp_path / "jax_umap"))
    port = load_estimator(_umap(), str(tmp_path / "jax_umap"))
    np.testing.assert_allclose(port.embedding_.numpy(), np.asarray(jax_model.embedding_),
                               atol=TOL)

    port_model = _umap()
    port_model.fit_transform(blobs)
    save_estimator(port_model, str(tmp_path / "port_umap"))
    back = jax_checkpoint.load_estimator(JaxUMAP(n_neighbors=5, max_iter=10, random_state=0),
                                         str(tmp_path / "port_umap"))
    np.testing.assert_allclose(np.asarray(back.transform()), port_model.embedding_.numpy(),
                               atol=TOL)
