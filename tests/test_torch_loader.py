"""Batch feeds of the PyTorch port (torchdr_tpu_torch/ops/loader.py and
utils/native_loader.py): every case of ``tests/test_loader.py`` and of
``TestNativeLoader`` (tests/test_ops.py) on the port, the JAX package's
``BatchSource`` beside the port's on the same feeds, and the C++ loader
built by the port from ``native/batch_loader.cpp`` into its own build
directory.
"""

import os

import numpy as np
import pytest
import torch
from torch.utils.data import DataLoader, TensorDataset

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.ops.loader import BatchSource as JaxBatchSource
from torchdr_tpu_torch.ops.ivf import ivf_build_from_batches, ivf_knn
from torchdr_tpu_torch.ops.loader import (
    BatchSource,
    get_loader_metadata,
    validate_deterministic_loader,
)
from torchdr_tpu_torch.ops.streaming import knn_graph_streaming
from torchdr_tpu_torch.utils import native_loader
from torchdr_tpu_torch.utils.native_loader import NpyBatchLoader


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=8.0, size=(16, 10))
    X = np.concatenate([c + rng.normal(size=(300, 10)) for c in centers]).astype(np.float32)
    rng.shuffle(X)
    return X


def _batches(X, size=1000):
    return [X[a : a + size] for a in range(0, X.shape[0], size)]


def test_list_is_buffered_and_replayable(data):
    src = BatchSource(_batches(data))
    assert src.buffered
    assert [b.shape[0] for b in src] == [b.shape[0] for b in src]


def test_one_shot_generator_is_buffered(data):
    src = BatchSource(b for b in _batches(data))
    assert src.buffered
    assert sum(b.shape[0] for b in src) == data.shape[0]
    assert sum(b.shape[0] for b in src) == data.shape[0]


def test_factory_is_replayed_not_buffered(data):
    calls = []

    def factory():
        calls.append(1)
        return iter(_batches(data))

    src = BatchSource(factory)
    assert not src.buffered
    assert sum(b.shape[0] for b in src) == data.shape[0]
    assert sum(b.shape[0] for b in src) == data.shape[0]
    assert len(calls) == 2


def test_single_array_is_one_batch(data):
    batches = list(BatchSource(data))
    assert len(batches) == 1 and batches[0].shape == data.shape


@pytest.mark.parametrize("kind", ["tuples", "tensors", "float64"])
def test_batches_normalized_as_the_jax_package_does(data, kind):
    feed = {
        "tuples": lambda: [(b, None) for b in _batches(data)],
        "tensors": lambda: [torch.from_numpy(b.copy()) for b in _batches(data)],
        "float64": lambda: [b.astype(np.float64) for b in _batches(data)],
    }[kind]
    got, want = list(BatchSource(feed())), list(JaxBatchSource(feed()))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.flags.c_contiguous
        np.testing.assert_array_equal(g, w)


def test_metadata_and_cache(data):
    passes = []

    def factory():
        passes.append(1)
        return iter(_batches(data, 700))

    src = BatchSource(factory)
    meta = src.metadata()
    assert meta["n_samples"] == data.shape[0] and meta["n_features"] == data.shape[1]
    assert meta["batch_sizes"][0] == 700
    n_after_first = len(passes)
    assert src.metadata() == meta  # from the per-object cache
    assert len(passes) == n_after_first
    assert get_loader_metadata(factory) == meta
    assert JaxBatchSource(lambda: iter(_batches(data, 700))).metadata() == meta


def test_shape_hint_reads_one_batch_of_a_dataloader(data):
    loader = DataLoader(TensorDataset(torch.from_numpy(data.copy())), batch_size=500)
    assert BatchSource(loader).shape_hint() == data.shape
    assert get_loader_metadata(loader) is None  # no counting pass was needed


def test_slice_replayed(data):
    src = BatchSource(lambda: iter(_batches(data, 500)))
    np.testing.assert_allclose(np.concatenate(list(src.slice(2, 4))), data[1000:2000])
    buffered = BatchSource(_batches(data, 500)).slice(2, 4)
    assert buffered.buffered
    np.testing.assert_allclose(np.concatenate(list(buffered)), data[1000:2000])


def test_empty_raises():
    with pytest.raises(ValueError, match="empty"):
        BatchSource([])
    with pytest.raises(ValueError, match="empty"):
        list(BatchSource(lambda: iter(())))


def test_bad_ndim_raises():
    with pytest.raises(ValueError, match="2-d"):
        BatchSource([np.zeros((4, 3, 2), np.float32)])


def test_shuffled_dataloader_rejected(data):
    loader = DataLoader(TensorDataset(torch.from_numpy(data.copy())), batch_size=1000,
                        shuffle=True)
    with pytest.raises(ValueError, match="shuffle=False"):
        BatchSource(loader)


def test_sequential_dataloader_accepted(data):
    loader = DataLoader(TensorDataset(torch.from_numpy(data.copy())), batch_size=1000,
                        shuffle=False)
    validate_deterministic_loader(loader)  # no raise
    src = BatchSource(loader)
    assert not src.buffered
    np.testing.assert_allclose(np.concatenate(list(src)), data)


def test_samplerless_source_warns():
    class Odd:
        dataset = None

    with pytest.warns(UserWarning, match="deterministically"):
        validate_deterministic_loader(Odd())


def test_ivf_build_from_factory_matches_list(data):
    """A replayed factory and a buffered list give the same index and
    search (one generator seed, one feed)."""
    idx_f = ivf_build_from_batches(lambda: iter(_batches(data)), n_clusters=16, device="cpu")
    idx_l = ivf_build_from_batches(_batches(data), n_clusters=16, device="cpu")
    assert idx_f.n == idx_l.n == data.shape[0]
    assert torch.equal(idx_f.ids_sorted, idx_l.ids_sorted)
    _, i_f = ivf_knn(None, k=10, nprobe=8, index=idx_f)
    _, i_l = ivf_knn(None, k=10, nprobe=8, index=idx_l)
    assert torch.equal(i_f, i_l)


def test_ivf_build_from_dataloader(data):
    loader = DataLoader(TensorDataset(torch.from_numpy(data.copy())), batch_size=1200,
                        shuffle=False)
    idx = ivf_build_from_batches(loader, n_clusters=16, device="cpu")
    assert idx.n == data.shape[0]
    ids = idx.ids_sorted.numpy()
    assert sorted(ids[ids >= 0].tolist()) == list(range(data.shape[0]))


def test_inconsistent_replay_rejected(data):
    state = {"calls": 0}

    def flaky():
        state["calls"] += 1
        # the first pass sees everything, later passes lose a batch
        keep = None if state["calls"] == 1 else -1
        return iter(_batches(data)[:keep])

    with pytest.raises(ValueError, match="replay|every pass|expected"):
        ivf_build_from_batches(flaky, n_clusters=16, device="cpu")


def test_knn_graph_streaming_from_factory(data):
    from torchdr_tpu_torch.ops.distance import knn_graph

    i0 = knn_graph(torch.from_numpy(data), k=8)[1].numpy()
    seg_bytes = 2 * 1000 * data.shape[1] * 4 + 1  # several segments
    _, i_s = knn_graph_streaming(lambda: iter(_batches(data)), k=8, nprobe=8, n_clusters=8,
                                 seg_bytes=seg_bytes, device="cpu")
    hits = (i0[:, :, None] == i_s[:, None, :]).any(-1).sum()
    assert hits / i0.size > 0.95
    assert not (i_s == np.arange(data.shape[0])[:, None]).any()


# --- the native loader ---


@pytest.mark.parametrize("force_numpy", [False, True])
def test_roundtrip_both_backends(tmp_path, force_numpy):
    X = np.random.default_rng(0).normal(size=(1000, 16)).astype(np.float32)
    path = str(tmp_path / "x.npy")
    np.save(path, X)
    ld = NpyBatchLoader(path, batch_rows=256, force_numpy=force_numpy)
    assert ld.backend == ("numpy" if force_numpy else "native")
    assert (ld.n_rows, ld.n_cols, len(ld)) == (1000, 16, 4)
    assert np.array_equal(np.concatenate(list(ld)), X)
    ld.close()


def test_random_access(tmp_path):
    X = np.arange(100 * 4, dtype=np.float32).reshape(100, 4)
    path = str(tmp_path / "y.npy")
    np.save(path, X)
    ld = NpyBatchLoader(path, batch_rows=30)
    assert ld.backend == "native"
    assert np.array_equal(ld.get_batch(3), X[90:])
    assert np.array_equal(ld.get_batch(0), X[:30])
    assert np.array_equal(ld.get_batch(1), X[30:60])
    with pytest.raises(IndexError):
        ld.get_batch(4)
    ld.close()


def test_library_built_into_the_port_s_build_directory():
    """The shared library lies in ``torchdr_tpu_torch/_build/`` under a name
    keyed by the source and the flags; nothing is written under
    ``native/``."""
    native = native_loader._SRC.parent
    before = sorted(os.listdir(native))
    assert native_loader.native_available()
    path = native_loader.library_path()
    assert path.exists() and path.parent.name == "_build"
    assert path.parent.parent.name == "torchdr_tpu_torch"
    assert sorted(os.listdir(native)) == before
    assert native_loader.CXX_FLAGS[:5] == ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread"]


def test_failed_build_falls_back_to_numpy_with_a_warning(tmp_path, monkeypatch, caplog):
    X = np.random.default_rng(1).normal(size=(50, 3)).astype(np.float32)
    path = str(tmp_path / "z.npy")
    np.save(path, X)

    def no_compiler():
        raise RuntimeError("no C++ compiler (g++) found")

    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "_build", no_compiler)
    warned = []
    monkeypatch.setattr(native_loader._logger, "warning", warned.append)
    ld = NpyBatchLoader(path, batch_rows=20)
    assert ld.backend == "numpy" and not native_loader.native_available()
    assert warned and "numpy" in warned[0]
    assert np.array_equal(np.concatenate(list(ld)), X)


def test_loader_feeds_the_batch_built_index(tmp_path, data):
    path = str(tmp_path / "d.npy")
    np.save(path, data)
    via_file = ivf_build_from_batches(lambda: NpyBatchLoader(path, 1000), n_clusters=16,
                                      device="cpu")
    via_list = ivf_build_from_batches(_batches(data), n_clusters=16, device="cpu")
    for name in ("ids_sorted", "X_sorted", "centroids"):
        assert torch.equal(getattr(via_file, name), getattr(via_list, name)), name


def test_non_float32_file_rejected(tmp_path):
    path = str(tmp_path / "i.npy")
    np.save(path, np.zeros((10, 2), np.int32))
    for force_numpy in (False, True):  # the C++ parser refuses it, then numpy does
        with pytest.raises(ValueError, match="float32"):
            NpyBatchLoader(path, batch_rows=4, force_numpy=force_numpy)
