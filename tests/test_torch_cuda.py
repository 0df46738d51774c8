"""Tests of the PyTorch port that need an NVIDIA card (marker ``cuda``).

A CUDA kernel has no CPU mode, so these skip without a card. This file
imports neither JAX nor the JAX package, so on the machine with the card
it runs without them:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from torchdr_tpu_torch import TSNE, UMAP
from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
    rowlse_bwd,
    rowlse_bwd_plain,
    rowlse_fwd,
    rowlse_fwd_plain,
)
from torchdr_tpu_torch.ops.cuda.umap_kernel import fused_shared_repulsion, shared_repulsion_plain

A, B, EPS = 1.577, 0.8951, 1e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 2, 3, 8])
def test_k1_kernel_matches_plain(cuda, d):
    """Same arithmetic on both sides (-fmad=false, float64 sums): 1e-5."""
    rng = np.random.default_rng(d)
    n, S = 5003, 300  # ragged n, S neither a tile nor a lane multiple
    Z = torch.from_numpy((3.0 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    neg = torch.from_numpy(rng.integers(0, n, S)).to(cuda)
    w = torch.from_numpy((rng.integers(0, 40, n) / S).astype(np.float32)).to(cuda)
    before = fused_shared_repulsion.launches
    got = fused_shared_repulsion(Z, neg, w, A, B, EPS)
    assert fused_shared_repulsion.launches == before + 1
    want = shared_repulsion_plain(Z, neg, w, A, B, EPS)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_k1_rejects_wide_embeddings_on_the_card(cuda):
    Z = torch.zeros((16, 9), device=cuda)
    with pytest.raises(ValueError, match="d <= 8"):
        fused_shared_repulsion(Z, torch.arange(4, device=cuda), torch.ones(16, device=cuda), A, B)


@pytest.mark.cuda
def test_fit_on_the_card_launches_k1_every_step(cuda):
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(4, 16))
    X = (centers[rng.integers(0, 4, 2000)] + rng.normal(size=(2000, 16))).astype(np.float32)
    fused_shared_repulsion.launches = 0
    model = UMAP(n_neighbors=15, max_iter=100, random_state=0)
    Z = model.fit_transform(X)
    assert fused_shared_repulsion.launches == model.n_iter_ == 100
    assert Z.shape == (2000, 2) and np.all(np.isfinite(Z))


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("n, d", [(5003, 2), (777, 3), (1, 2), (130, 8)])
def test_k2_k3_kernels_match_plain(cuda, kernel, n, d):
    """K2: 1e-5 of max(1, |lse|) (float32 tile sums against one float64 sum
    of the same float32 terms); K3: 1e-4 of max |dZ| (the same products,
    summed in float32 tiles then float64, against float64)."""
    rng = np.random.default_rng(n + d)
    Z = torch.from_numpy((3.0 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    before = (rowlse_fwd.launches, rowlse_bwd.launches)
    lse = rowlse_fwd(Z, kernel)
    want = rowlse_fwd_plain(Z, kernel)
    if n == 1:  # a row with no term: -inf in both, and a zero gradient
        assert torch.isneginf(lse).all() and torch.isneginf(want).all()
        assert float(rowlse_bwd(Z, want, torch.ones_like(want), kernel).abs().max()) == 0.0
        return
    assert float((lse - want).abs().max()) <= 1e-5 * max(1.0, float(want.abs().max()))
    g = torch.softmax(want, 0)
    got = rowlse_bwd(Z, want, g, kernel)
    ref = rowlse_bwd_plain(Z, want, g, kernel)
    assert (rowlse_fwd.launches, rowlse_bwd.launches) == (before[0] + 1, before[1] + 1)
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_k2_keeps_underflowing_gaussian_rows_exact(cuda):
    g = (torch.arange(20, dtype=torch.float32) * 11.0).to(cuda)
    Z = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2).contiguous()
    lse = rowlse_fwd(Z, "gaussian")
    assert torch.isfinite(lse).all() and float(lse.max()) < -100
    assert float((lse - rowlse_fwd_plain(Z, "gaussian")).abs().max()) <= 1e-5 * float(lse.abs().max())


@pytest.mark.cuda
def test_tsne_fit_on_the_card_launches_k2_k3_every_step(cuda):
    rng = np.random.default_rng(1)
    centers = rng.normal(scale=8.0, size=(4, 16))
    X = (centers[rng.integers(0, 4, 1500)] + rng.normal(size=(1500, 16))).astype(np.float32)
    rowlse_fwd.launches = rowlse_bwd.launches = 0
    model = TSNE(perplexity=20, max_iter=120, random_state=0)
    Z = model.fit_transform(X)
    assert rowlse_fwd.launches == rowlse_bwd.launches == model.n_iter_ == 120
    assert Z.shape == (1500, 2) and np.all(np.isfinite(Z))
