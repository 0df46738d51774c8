"""The duplicate-row test of a fit's input: the public ``deduplicate``
(``utils/wrappers.py``) and the fit's ``deduplicate_fit_input``
(``ops/cuda/hash_kernel.py``), each held to the JAX package's
``deduplicate`` and its row hash ``_row_hashes``.

On the CPU the fit's test is ``deduplicate`` on the host; the row-hash
kernel and the test on the card are held to the port's ``_row_hashes`` and
``deduplicate`` in ``tests/test_torch_cuda.py``, and those two to the JAX
package's here.
"""

import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.utils import wrappers as jax_wrappers
from torchdr_tpu_torch import PCA, UMAP
from torchdr_tpu_torch.ops.cuda.hash_kernel import deduplicate_fit_input, row_hash
from torchdr_tpu_torch.utils import wrappers
from torchdr_tpu_torch.utils.wrappers import _row_hashes, deduplicate


def _rows(case, m, n=60, seed=0):
    rng = np.random.default_rng(seed + m)
    X = rng.normal(size=(n, m)).astype(np.float32)
    if case == "duplicates":
        X[40:50] = X[:10]
        X[55] = X[3]
    elif case == "signed_zero":  # rows equal as floats, not as bytes
        X[1] = 0.0
        X[2] = -0.0
        if m > 1:  # at width 1 these would repeat rows 1 and 2 byte for byte
            X[5] = X[4]
            X[4, 0] = 0.0
            X[5, 0] = -0.0
    return X


def _routes(X):
    """Both routes' (X_unique as numpy, inverse); the fit's returns the
    caller's copy itself where nothing repeats."""
    Xt = torch.from_numpy(X)
    rows, inverse = deduplicate_fit_input(X, Xt)
    assert isinstance(rows, torch.Tensor) and rows.device == Xt.device
    if inverse is None:
        assert rows is Xt  # the copy already on the device is the fit's input
    return {"deduplicate": deduplicate(X), "fit_input": (rows.numpy(), inverse)}


def _held(got, want):
    rows, inverse = got
    want_rows, want_inverse = want
    assert (inverse is None) == (want_inverse is None)
    assert rows.dtype == np.float32 and rows.shape == np.asarray(want_rows).shape
    assert np.array_equal(rows.view(np.uint32), np.asarray(want_rows).view(np.uint32))
    if inverse is not None:
        assert inverse.dtype == want_inverse.dtype and np.array_equal(inverse, want_inverse)


WIDTHS = [1, 50, 784, 785]


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("case", ["distinct", "duplicates", "signed_zero"])
def test_every_route_is_the_jax_deduplicate(case, m):
    X = _rows(case, m)
    want = jax_wrappers.deduplicate(X)
    before = deduplicate.exact_calls
    for got in _routes(X).values():
        _held(got, want)
    # numpy's row sort runs only where hashes collide: with repeated rows
    assert deduplicate.exact_calls - before == (2 if case == "duplicates" else 0)
    if case == "signed_zero":  # the prefilter compares bytes: nothing merged
        assert want[1] is None


@pytest.mark.parametrize("m", WIDTHS)
@pytest.mark.parametrize("case", ["distinct", "duplicates", "signed_zero"])
def test_a_forced_hash_collision_takes_the_exact_path(monkeypatch, case, m):
    """Every hash the same, in the port and in the JAX package: each route
    takes numpy's row sort, counted once a call, with the JAX package's
    result under the same collision (where rows differ only in a zero's
    sign, the float comparison merges them)."""
    def constant(Xn):
        return np.zeros(Xn.shape[0], dtype=np.uint64)

    monkeypatch.setattr(wrappers, "_row_hashes", constant)
    monkeypatch.setattr(jax_wrappers, "_row_hashes", constant)
    X = _rows(case, m)
    want = jax_wrappers.deduplicate(X)
    before = deduplicate.exact_calls
    for got in _routes(X).values():
        _held(got, want)
    assert deduplicate.exact_calls - before == 2
    if case == "signed_zero":
        assert want[1] is not None and want[1][1] == want[1][2]


@pytest.mark.parametrize("m", WIDTHS)
def test_the_host_row_hash_is_the_jax_row_hash(m):
    """The plain version that the kernel is held to on the card."""
    X = _rows("signed_zero", m)
    got = _row_hashes(X)
    assert got.dtype == np.uint64
    assert np.array_equal(got, jax_wrappers._row_hashes(X))
    assert got[1] != got[2]  # 0.0 and -0.0 rows


def test_the_row_hash_kernel_takes_only_a_cuda_tensor():
    with pytest.raises(ValueError, match="CUDA"):
        row_hash(torch.zeros(4, 3))


def test_a_fit_maps_duplicate_rows_to_equal_embedding_rows():
    rng = np.random.default_rng(3)
    centers = rng.normal(scale=6.0, size=(3, 8))
    X = (centers[rng.integers(0, 3, 150)] + rng.normal(size=(150, 8))).astype(np.float32)
    X[120:150] = X[:30]
    before = deduplicate.exact_calls
    model = UMAP(n_neighbors=10, max_iter=30, random_state=0, device="cpu")
    Z = model.fit_transform(X)
    assert deduplicate.exact_calls == before + 1
    assert model.n_samples_in_ == 120 and Z.shape == (150, 2)
    assert np.array_equal(Z[120:], Z[:30])
    assert [k for k in model.timings_ if k.startswith("api.")] == [
        "api.check", "api.h2d", "api.dedup", "api.d2h"]


def test_without_process_duplicates_no_test_runs():
    X = _rows("duplicates", 6)
    before = deduplicate.exact_calls
    model = PCA(n_components=2, device="cpu")
    assert model.process_duplicates is False
    Z = model.fit_transform(X)
    assert Z.shape == (60, 2) and "api.dedup" not in model.timings_
    assert deduplicate.exact_calls == before
