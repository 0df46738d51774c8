"""K1 of the PyTorch port (ops/cuda/umap_kernel.py) against the JAX package.

The same numpy inputs go through the JAX kernel in interpret mode
(``torchdr_tpu/ops/pallas/umap_kernel.py``), an f64 direct-difference
reference, and the port's plain version, which the port's wrapper takes
for every CPU tensor.

Tolerances. The port sums coef·(z_i − z_s) directly (float64 sums), the
TPU kernel forms (Σ coef)·z_i − Σ coef·z_s in float32, which cancels at
near-collisions (|coef| up to 2b/eps ≈ 1.8e3): on these inputs the JAX
kernel itself is 4.6e-5 from the f64 reference. So the port is held to
the f64 reference at 1e-5, and to the JAX kernel at 1e-4, the tolerance
the JAX package's own test (tests/test_ops.py) holds that kernel to
against the same f64 reference.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import warm_worker_threads  # noqa: F401
from torchdr_tpu.ops.pallas.umap_kernel import fused_shared_repulsion as jax_k1
from torchdr_tpu_torch.ops.cuda.umap_kernel import (
    fused_shared_repulsion,
    shared_repulsion_plain,
)


A, B, EPS = 1.577, 0.8951, 1e-3


def _reference_f64(Z, neg, w):
    """f64 direct-difference reference (as tests/test_ops.py:764-771)."""
    Z64 = np.asarray(Z, np.float64)
    Zn = Z64[neg]
    D = ((Z64[:, None, :] - Zn[None, :, :]) ** 2).sum(-1)
    coef = -2.0 * B / ((D + EPS) * (1.0 + A * D**B))
    valid = np.asarray(neg)[None, :] != np.arange(Z.shape[0])[:, None]
    coef = np.where(valid, coef, 0.0) * np.asarray(w, np.float64)[:, None]
    return np.clip(coef.sum(1)[:, None] * Z64 - coef @ Zn, -4.0, 4.0)


def _inputs(d, n=700, S=256, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.normal(size=(n, d)).astype(np.float32)
    neg = rng.integers(0, n, S).astype(np.int32)
    w = (rng.integers(0, 40, n) / S).astype(np.float32)
    return Z, neg, w


def _port(Z, neg, w):
    out = fused_shared_repulsion(
        torch.from_numpy(Z), torch.from_numpy(neg).long(), torch.from_numpy(w), A, B, EPS
    )
    return out.numpy()


@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_jax_interpret(d):
    Z, neg, w = _inputs(d)
    want = np.asarray(
        jax_k1(jnp.asarray(Z), jnp.asarray(neg), jnp.asarray(w), A, B, EPS,
               block=128, interpret=True)
    )
    assert np.abs(_port(Z, neg, w) - want).max() <= 1e-4


@pytest.mark.parametrize("d", [2, 3])
def test_plain_matches_f64_reference(d):
    Z, neg, w = _inputs(d)
    assert np.abs(_port(Z, neg, w) - _reference_f64(Z, neg, w)).max() <= 1e-5


@pytest.mark.parametrize("scale", [3.0, 10.0])
def test_plain_matches_f64_at_embedding_scales(scale):
    Z, neg, w = _inputs(2, seed=3)
    Z = (scale * Z).astype(np.float32)
    assert np.abs(_port(Z, neg, w) - _reference_f64(Z, neg, w)).max() <= 1e-5


def test_self_collision_masked_and_ragged_n():
    rng = np.random.default_rng(1)
    n, S = 150, 128  # every sample collides with its own row; n not a block multiple
    Z = rng.normal(size=(n, 2)).astype(np.float32)
    neg = np.arange(S, dtype=np.int32)
    w = np.ones(n, np.float32)
    got = _port(Z, neg, w)
    assert got.shape == (n, 2)
    assert np.abs(got - _reference_f64(Z, neg, w)).max() <= 1e-5


def test_chunking_does_not_change_the_result():
    Z, neg, w = _inputs(3)
    args = (torch.from_numpy(Z), torch.from_numpy(neg).long(), torch.from_numpy(w), A, B, EPS)
    whole = shared_repulsion_plain(*args)
    chunked = shared_repulsion_plain(*args, chunk_pairs=256 * 37)
    assert torch.equal(whole, chunked)


def test_cpu_tensor_takes_plain_and_counts_no_launch():
    Z, neg, w = _inputs(2, n=64, S=32)
    before = fused_shared_repulsion.launches
    _port(Z, neg, w)
    assert fused_shared_repulsion.launches == before


@pytest.mark.parametrize(
    "bad",
    ["float64", "d9", "weight_shape", "noncontiguous", "float_ids"],
)
def test_wrapper_rejects_bad_inputs(bad):
    Z = torch.zeros((16, 2))
    neg = torch.arange(4)
    w = torch.ones(16)
    if bad == "float64":
        Z = Z.double()
    elif bad == "d9":
        Z = torch.zeros((16, 9))
    elif bad == "weight_shape":
        w = torch.ones(15)
    elif bad == "noncontiguous":
        Z = torch.zeros((2, 16)).T
    elif bad == "float_ids":
        neg = neg.float()
    with pytest.raises(ValueError):
        fused_shared_repulsion(Z, neg, w, A, B, EPS)
