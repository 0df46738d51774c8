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

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.ops.pallas.umap_kernel import fused_shared_repulsion as jax_k1
import re
from pathlib import Path

import torchdr_tpu_torch.ops.cuda.umap_kernel as umap_kernel
from torchdr_tpu_torch.ops.cuda.umap_kernel import (
    fused_shared_repulsion,
    record_bytes,
    repulsion_grid,
    rows_per_tile,
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


def test_plain_needs_no_id_mask_for_positive_eps():
    """What the kernel's unmasked instantiation rests on: the negative is
    read from Z by its id, so at s == i the difference is 0 bit for bit,
    coef = -2b/eps is finite, and the term is 0 with or without the test."""
    rng = np.random.default_rng(1)
    n, S = 150, 128  # the self-collision inputs above, with duplicate ids
    Z = torch.from_numpy(rng.normal(size=(n, 2)).astype(np.float32))
    neg = torch.from_numpy(np.concatenate([np.arange(S - 8), np.arange(8)]))
    w = torch.ones(n)
    masked = shared_repulsion_plain(Z, neg, w, A, B, EPS)
    unmasked = shared_repulsion_plain(Z, neg, w, A, B, EPS, mask_self=False)
    assert torch.isfinite(unmasked).all() and torch.equal(masked, unmasked)
    # eps = 0 is where the mask is needed: coef is infinite at D = 0
    assert not torch.isfinite(shared_repulsion_plain(Z, neg, w, A, B, 0.0, mask_self=False)).all()
    assert torch.isfinite(shared_repulsion_plain(Z, neg, w, A, B, 0.0)).all()


def _source_constant(name):
    src = (Path(umap_kernel.__file__).parents[1] / "csrc" / "umap_repulsion.cu").read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))


def _lane_negatives(S, d, s_tile, lanes, lane):
    """The negatives that lane ``lane`` of ``lanes`` evaluates, as the
    kernel's loops walk them: per staged tile, runs of kChunk per lane,
    each walked a step of 8 (4 above d = 2) at a time, ``lanes`` steps
    apart."""
    unroll, run = (8 if d <= 2 else 4), _source_constant("kChunk")
    taken = []
    for s0 in range(0, S, s_tile):
        length = min(s_tile, S - s0)
        for base in range(0, length, lanes * run):
            stop = min(length, base + lanes * run)
            for t in range(base + lane * unroll, stop, lanes * unroll):
                taken.extend(range(s0 + t, s0 + min(t + unroll, stop)))
    return taken


@pytest.mark.parametrize("S", [1, 7, 512, 2048, 2051, 8192])
@pytest.mark.parametrize("n", [1, 127, 60_000, 1_000_000])
def test_grid_covers_every_row_and_negative_once(n, S):
    """The index arithmetic the wrapper keeps in Python, for every width,
    with and without the staged ids, on 132 SMs: the row tiles cover the
    rows with no empty block, the lanes' shares and the staged tiles
    partition the sample, a block's staged bytes leave room for the blocks
    an SM is counted on to hold, and the lanes are the fewest that fill three
    quarters of those places (or as many as the warp or the sample allows)."""
    threads, per_sm, cap = umap_kernel._THREADS, umap_kernel._BLOCKS_PER_SM, umap_kernel._STAGED_BYTES
    places = 132 * per_sm
    assert per_sm * (cap + 1024) <= 227 * 1024 and per_sm * threads <= 2048
    for d in range(1, 9):
        for masked in (False, True):
            lanes, blocks, s_tile = repulsion_grid(n, S, d, 132, masked)
            assert lanes in (1, 2, 4, 8, 16, 32)
            tile = rows_per_tile(d, lanes)
            assert tile * lanes == threads * (2 if d <= 4 else 1)
            assert (blocks - 1) * tile < n <= blocks * tile
            assert 1 <= s_tile <= S
            assert s_tile * (record_bytes(d) + 4 * masked) <= cap
            assert record_bytes(d) % 4 == 0 and record_bytes(d) >= 4 * d
            if s_tile < S:  # tiles end on whole steps of a warp
                assert s_tile % (32 * 8) == 0
            can_split = lanes < 32 and S >= 4 * lanes * 8
            assert 4 * blocks >= 3 * places or not can_split
            if lanes > 1:  # half as many lanes would not have filled them
                assert 4 * -(-n // rows_per_tile(d, lanes // 2)) < 3 * places
                assert S >= 2 * lanes * 8  # a lane keeps two full steps
            if (n, masked) == (127, False):  # the partition, once per (S, d)
                taken = [s for lane in range(lanes) for s in _lane_negatives(S, d, s_tile, lanes, lane)]
                assert sorted(taken) == list(range(S))


@pytest.mark.parametrize("n, S, d, lanes", [
    (60_000, 512, 2, 4), (60_000, 512, 3, 4), (1_000_000, 512, 2, 1), (10_000, 2048, 2, 16),
])
def test_grid_at_the_timed_shapes(n, S, d, lanes):
    """The lanes the card measured as best, or within 3 % of it, at the four
    shapes the kernel is timed at (PERF.md): the whole sample staged at once."""
    assert repulsion_grid(n, S, d, 132) == (lanes, -(-n // rows_per_tile(d, lanes)), S)


def test_grid_constants_are_the_sources():
    """The wrapper's copies of the kernel's constants agree with the source."""
    src = (Path(umap_kernel.__file__).parents[1] / "csrc" / "umap_repulsion.cu").read_text()
    assert _source_constant("kThreads") == umap_kernel._THREADS
    assert _source_constant("kBlocksPerSM") == umap_kernel._BLOCKS_PER_SM
    assert _source_constant("kChunk") % 8 == 0  # a run is whole steps
    assert "kUnroll = D <= 2 ? 8 : 4;" in src and umap_kernel._UNROLL == 8
    assert "kRows = D <= 4 ? 2 : 1;" in src
    assert "kMaxStaged = 227 * 1024 / kBlocksPerSM - 1024;" in src
    assert umap_kernel._STAGED_BYTES == 227 * 1024 // umap_kernel._BLOCKS_PER_SM - 1024


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
