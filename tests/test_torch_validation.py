"""The port's validation checks (``torchdr_tpu_torch/utils/validation.py``)
against the JAX package's, on the same numpy inputs: each raises where the
JAX check raises, with the same exception type, and passes where it passes.
The port's checks also take torch tensors."""

import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.utils import validation as jax_validation
from torchdr_tpu_torch.utils import validation


def _sym(n, seed):
    A = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    return (A + A.T) / 2


def _row_normalized(n, seed):
    P = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    return P / P.sum(1, keepdims=True)


def _log_P_with_entropy(n, seed):
    log_P = np.log(_row_normalized(n, seed))
    return log_P, -np.sum(np.exp(log_P) * (log_P - 1.0), axis=1)


def _dense_and_sparse(seed, perturb):
    dense = np.random.default_rng(seed).random((6, 6)).astype(np.float32)
    idx = np.array([[1, 2, -1]] * 6, dtype=np.int32)
    vals = dense[np.arange(6)[:, None], np.maximum(idx, 0)].copy()
    vals[idx < 0] = 7.0  # padding slots are not compared
    vals[3, 1] += perturb
    return dense, vals, idx


_NAN = np.array([[0.0, np.nan], [1.0, 2.0]], dtype=np.float32)
_P = _row_normalized(5, 1)
_LOG_P, _H = _log_P_with_entropy(5, 2)

#: (check, args, kwargs): the same numpy inputs for both packages
CASES = {
    "NaNs clean": ("check_NaNs", (np.ones((3, 2), np.float32),), {}),
    "NaNs present": ("check_NaNs", (_NAN,), {}),
    "NaNs message": ("check_NaNs", (_NAN, "custom message"), {}),
    "nonnegativity ok": ("check_nonnegativity", (np.array([0.0, 1.0, 2.0]),), {}),
    "nonnegativity within tol": ("check_nonnegativity", (np.array([-1e-9, 1.0]),), {}),
    "nonnegativity negative": ("check_nonnegativity", (np.array([-1e-3, 1.0]),), {}),
    "nonnegativity loose tol": ("check_nonnegativity", (np.array([-1e-3, 1.0]),), {"tol": 1e-2}),
    "shape ok": ("check_shape", (np.zeros((4, 3)), (4, 3)), {}),
    "shape list ok": ("check_shape", (np.zeros((4, 3)), [4, 3]), {}),
    "shape wrong": ("check_shape", (np.zeros((4, 3)), (3, 4)), {}),
    "shape wrong rank": ("check_shape", (np.zeros((4,)), (4, 1)), {}),
    "symmetry ok": ("check_symmetry", (_sym(5, 0),), {}),
    "symmetry broken": ("check_symmetry", (_sym(5, 0) + np.eye(5, k=1, dtype=np.float32),), {}),
    "symmetry within tol": ("check_symmetry", (_sym(5, 0) + 1e-7 * np.eye(5, k=1),), {}),
    "marginal rows ok": ("check_marginal", (_P, np.ones(5)), {}),
    "marginal rows off": ("check_marginal", (_P, np.full(5, 1.1)), {}),
    "marginal cols": ("check_marginal", (_P, _P.sum(0)), {"dim": 0}),
    "marginal cols off": ("check_marginal", (_P, np.ones(5)), {"dim": 0}),
    "marginal log ok": ("check_marginal", (np.log(_P), np.zeros(5)), {"log": True}),
    "marginal log off": ("check_marginal", (np.log(_P), np.full(5, 0.1)), {"log": True}),
    "marginal log -inf entries": (
        "check_marginal", (np.where(_P > 0.25, np.log(_P), -np.inf), np.log(
            np.where(_P > 0.25, _P, 0.0).sum(1))), {"log": True}),
    "entropy ok": ("check_entropy", (_LOG_P, _H), {}),
    "entropy off": ("check_entropy", (_LOG_P, _H + 0.01), {}),
    "entropy loose tol": ("check_entropy", (_LOG_P, _H + 0.01), {"tol": 0.1}),
    "type ok": ("check_type", (3, int), {}),
    "type tuple ok": ("check_type", (3.0, (int, float)), {}),
    "type wrong": ("check_type", ("3", int), {}),
    "dense/sparse ok": ("check_similarity_dense_sparse", _dense_and_sparse(0, 0.0), {}),
    "dense/sparse within tol": ("check_similarity_dense_sparse", _dense_and_sparse(0, 1e-6), {}),
    "dense/sparse off": ("check_similarity_dense_sparse", _dense_and_sparse(0, 1e-3), {}),
    "dense/sparse loose tol": (
        "check_similarity_dense_sparse", _dense_and_sparse(0, 1e-3), {"tol": 1e-2}),
}


def _outcome(fn, args, kwargs):
    """None when ``fn`` passes, else the type of the exception it raises."""
    try:
        fn(*args, **kwargs)
    except Exception as exc:  # noqa: BLE001 (the type is what is compared)
        return type(exc)
    return None


@pytest.mark.parametrize("case", sorted(CASES))
def test_check_matches_jax(case):
    name, args, kwargs = CASES[case]
    want = _outcome(getattr(jax_validation, name), args, kwargs)
    assert _outcome(getattr(validation, name), args, kwargs) is want
    # and on torch tensors, where the check takes arrays
    targs = tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a for a in args)
    assert _outcome(getattr(validation, name), targs, kwargs) is want


def test_cases_cover_every_check_both_ways():
    """Each of the JAX package's checks is ported and exercised here on
    inputs where it passes and inputs where it raises."""
    names = {n for n in dir(jax_validation) if n.startswith("check_")}
    assert names == {n for n in dir(validation) if n.startswith("check_")}
    outcomes = {}
    for name, args, kwargs in CASES.values():
        outcomes.setdefault(name, set()).add(_outcome(getattr(jax_validation, name), args, kwargs))
    assert set(outcomes) == names - {"check_neighbor_param"}
    for name, seen in outcomes.items():
        assert None in seen and len(seen) > 1, name


def test_nan_message_is_kept():
    with pytest.raises(ValueError, match="custom message"):
        validation.check_NaNs(_NAN, "custom message")


@pytest.mark.parametrize("param, n", [(5, 10), (9, 10), (12, 10), (1, 2)])
def test_check_neighbor_param_matches_jax(param, n):
    want = jax_validation.check_neighbor_param(param, n)
    assert validation.check_neighbor_param(param, n) == want


def test_check_neighbor_param_refuses_zero_as_jax_does():
    assert _outcome(validation.check_neighbor_param, (0, 10), {}) is ValueError
    assert _outcome(jax_validation.check_neighbor_param, (0, 10), {}) is ValueError
