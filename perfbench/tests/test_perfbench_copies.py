"""Each frozen copy in the harness equals the function it came from.

The originals are imported here only; the copies import nothing of the
program."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.data.clustered import make_clustered
from perfbench.reference.quality import recall, trustworthiness
from perfbench.roofline import k1, peaks, rowlse

ROOT = Path(__file__).resolve().parents[2]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_original", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("n,d,clusters,decay,seed", [
    (500, 784, 50, 0.0, 0), (1000, 50, 50, 1.0, 7), (64, 3, 5, 0.5, 2**31 + 3)])
def test_make_clustered_is_the_original(n, d, clusters, decay, seed):
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered as original

    X, y = make_clustered(n, d, clusters, decay, seed)
    X0, y0 = original(n, d, clusters, decay, seed)
    assert X.dtype == X0.dtype == np.float32
    assert np.array_equal(X, X0) and np.array_equal(y, y0)


@pytest.mark.parametrize("shape", [(10, 5), (200, 30)])
def test_recall_is_the_original(shape):
    from torchdr_tpu_torch.benchmarks.ivf_recall import recall as original

    g = torch.Generator().manual_seed(0)
    got = torch.randint(0, 50, shape, generator=g)
    want = torch.randint(0, 50, shape, generator=g)
    assert torch.equal(recall(got, want), original(got, want))


@pytest.mark.parametrize("n,k", [(120, 5), (300, 15)])
def test_trustworthiness_is_the_original(n, k):
    from torchdr_tpu_torch.benchmarks.real_digits import trustworthiness as original

    X, _ = make_clustered(n, 20, 4, seed=n)
    Z = X[:, :2].copy()
    assert trustworthiness(X, Z, k) == original(X, Z, k)


@pytest.mark.parametrize("n,S,d", [(60_000, 512, 2), (1_300_000, 512, 2), (60_000, 512, 3),
                                   (1797, 2048, 2)])
def test_k1_bound_is_the_original(n, S, d):
    assert k1.bound_ms(n, S, d) == _chip_smoke().k1_bound_ms(n, S, d)


@pytest.mark.parametrize("n,d,which,kernel", [
    (10_000, 2, "K2", "student"), (10_000, 2, "K3", "student"), (70_000, 2, "K2", "student"),
    (70_000, 2, "K3", "student"), (50_000, 3, "K3", "gaussian")])
def test_rowlse_bound_is_the_original(n, d, which, kernel):
    assert rowlse.bound_ms(n, d, which, kernel) == _chip_smoke().rowlse_bound_ms(n, d, which, kernel)


def test_peaks_are_the_originals():
    smoke = _chip_smoke()
    assert peaks.H100_FP32_FLOPS == smoke.H100_FP32_FLOPS
    assert peaks.H100_BYTES_PER_S == smoke.H100_BYTES_PER_S
