"""The row log-sum reductions of the PyTorch port (K2, K3 and their plain
versions, ``ops/reduce.py``) against the JAX package.

The same numpy inputs, made from a seed, go to both. On the CPU the port's
wrappers take the plain versions; the JAX package's
``pairwise_logkernel_rowlse`` takes its blockwise XLA tier, and its TPU
kernels run in interpret mode, as ``tests/test_ops.py`` runs them.

Tolerances:

- forward against the XLA tier and the interpret-mode TPU kernel: abs 1e-5
  (float32 row sums of up to 400 terms in other orders; the JAX package's
  own tolerance for its kernel). The XLA tier is evaluated in float64: a
  float32 evaluation of the JAX package has once come out 3.1e-4 off in a
  multi-worker run of the suite (``tests/_torch_threads.py``);
- gradient against ``jax.grad`` of the XLA tier, also in float64: abs 1e-5
  (the gradients here are below 1e-1 in size, the port's float32 values
  agree to ~1e-7 of that);
- gradient against the interpret-mode TPU backward: abs 1e-4, the JAX
  package's own tolerance for that kernel (``tests/test_ops.py``);
- far-apart gaussian rows: rtol 1e-6 with abs 1e-5 against the XLA tier
  evaluated in float64 (the float32 gram form of the XLA tier cancels at
  |z|² ≫ d² there; the values are ~-110, where one float32 ulp is 7.6e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import worker_threads  # noqa: F401
from torchdr_tpu.ops.pallas.reduce_kernel import rowlse_bwd_pallas, rowlse_fwd_pallas
from torchdr_tpu.ops.reduce import pairwise_logkernel_logsumexp as jax_logsumexp_red
from torchdr_tpu.ops.reduce import pairwise_logkernel_rowlse as jax_rowlse
from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
    _BLOCKS_PER_SM as BLOCKS_PER_SM,
    _LANES as LANES,
    _STAGED_BYTES as STAGED_BYTES,
    _THREADS as THREADS,
    column_bytes,
    column_chunks,
    general_bwd_grid,
    k2_general_grid,
    rows_per_block,
    rowlse_bwd,
    rowlse_bwd_plain,
    rowlse_fwd,
    rowlse_fwd_plain,
    staged_bytes,
)
from torchdr_tpu_torch.ops.reduce import (
    pairwise_logkernel_logsumexp,
    pairwise_logkernel_rowlse,
)


def _Z(n, d=2, seed=0, scale=2.0):
    return (scale * np.random.default_rng(seed).normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("n", [257, 130])
@pytest.mark.parametrize("exclude_diag", [True, False])
def test_rowlse_matches_jax_xla_tier(kernel, n, exclude_diag):
    """n not a multiple of the block (64): the ragged last block."""
    Z = _Z(n, seed=n)
    with jax.enable_x64(True):
        want = np.asarray(jax_rowlse(jnp.asarray(Z, jnp.float64), kernel, exclude_diag, 64))
    got = pairwise_logkernel_rowlse(torch.from_numpy(Z), kernel, exclude_diag, 64).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_rowlse_matches_jax_tpu_kernel_interpret(kernel):
    Z = _Z(300, seed=3, scale=1.0)
    want = np.asarray(
        rowlse_fwd_pallas(jnp.asarray(Z), kernel, True, q_tile=64, db_tile=128, interpret=True)
    )
    got = rowlse_fwd(torch.from_numpy(Z), kernel, True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _far_apart(spacing=10.5, side=3):
    """A centred grid: every pair is at least ``spacing`` apart, so
    exp(-d²) underflows in float32 (d² > 104) for every term of every row."""
    g = (np.arange(side) - (side - 1) / 2) * spacing
    Z = np.stack(np.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    return (Z + 0.01 * np.random.default_rng(4).random(Z.shape)).astype(np.float32)


def test_far_apart_gaussian_rows_stay_exact():
    """The TPU kernel sums exp(-d²) with no max shift and clamps the sum at
    1e-30, so such rows read log(1e-30) = -69.08; the port follows the XLA
    tier's logsumexp and returns the exact, finite values."""
    Z = _far_apart()
    pallas = np.asarray(
        rowlse_fwd_pallas(jnp.asarray(Z), "gaussian", True, q_tile=8, db_tile=128, interpret=True)
    )
    np.testing.assert_allclose(pallas, np.log(np.float32(1e-30)), rtol=1e-6)
    with jax.enable_x64(True):
        want = np.asarray(jax_rowlse(jnp.asarray(Z, jnp.float64), "gaussian", True, 64))
    got = pairwise_logkernel_rowlse(torch.from_numpy(Z), "gaussian").numpy()
    assert np.all(np.isfinite(got)) and got.max() < -100
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    # and its backward stays finite where every exp(-d²) underflows
    Zt = torch.from_numpy(Z).requires_grad_(True)
    (grad,) = torch.autograd.grad(pairwise_logkernel_rowlse(Zt, "gaussian").sum(), Zt)
    assert torch.isfinite(grad).all()


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
@pytest.mark.parametrize("reduction", ["logsumexp", "mean"])
def test_rowlse_gradient_matches_jax_grad(kernel, reduction):
    """t-SNE's logsumexp of the rows and SNE's mean of the rows, through the
    port's autograd Function (K3's plain version) and ``jax.grad``."""
    Z = _Z(211, seed=5)

    def jax_loss(Zj):
        if reduction == "logsumexp":
            return jax_logsumexp_red(Zj, kernel, True, 64)
        return jnp.sum(jax_rowlse(Zj, kernel, True, 64)) / Zj.shape[0]

    with jax.enable_x64(True):
        want = np.asarray(jax.grad(jax_loss)(jnp.asarray(Z, jnp.float64)))
    Zt = torch.from_numpy(Z).requires_grad_(True)
    if reduction == "logsumexp":
        loss = pairwise_logkernel_logsumexp(Zt, kernel, True, 64)
    else:
        loss = pairwise_logkernel_rowlse(Zt, kernel, True, 64).sum() / Z.shape[0]
    (got,) = torch.autograd.grad(loss, Zt)
    assert np.abs(want).max() < 1e-1
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("kernel", ["student", "gaussian"])
def test_rowlse_backward_matches_jax_tpu_kernel_interpret(kernel):
    Z = _Z(200, seed=6, scale=1.0)
    Zj = jnp.asarray(Z)
    lse = rowlse_fwd_pallas(Zj, kernel, True, q_tile=64, db_tile=128, interpret=True)
    g = jax.nn.softmax(lse)
    want = np.asarray(
        rowlse_bwd_pallas(Zj, lse, g, kernel, True, q_tile=64, db_tile=128, interpret=True)
    )
    got = rowlse_bwd(
        torch.from_numpy(Z), torch.from_numpy(np.array(lse)), torch.from_numpy(np.array(g)),
        kernel,
    ).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_plain_backward_is_the_f64_gradient():
    """K3's plain version against the gradient of the row log-sums computed
    in float64 numpy by hand: 1e-6 relative to the largest entry."""
    Z = _Z(150, seed=7)
    Zt = torch.from_numpy(Z)
    lse = rowlse_fwd_plain(Zt, "student")
    g = torch.softmax(lse, 0)
    got = rowlse_bwd_plain(Zt, lse, g, "student").numpy()
    Z64 = Z.astype(np.float64)
    diff = Z64[:, None, :] - Z64[None, :, :]
    q = 1.0 / (1.0 + (diff**2).sum(-1))
    np.fill_diagonal(q, 0.0)
    lse64 = np.log(q.sum(1))
    g64 = np.exp(lse64 - lse64.max())
    g64 /= g64.sum()
    c = -(g64 * np.exp(-lse64))[:, None] * q**2
    want = 2.0 * ((c + c.T)[:, :, None] * diff).sum(1)
    np.testing.assert_allclose(got, want, atol=1e-6 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("n", [1, 127, 300, 10_000, 60_000])
def test_column_chunks_cover_every_column(n):
    """The kernels' grid at d = 2 on 132 SMs: chunks tile [0, n) with no
    empty chunk, and at the sizes of a fit the (row tiles x chunks) grid
    fills whole waves of resident blocks to nine tenths and never runs a
    little over one."""
    for backward in (False, True):
        n_chunks, chunk = column_chunks(n, 132, 2, backward)
        assert n_chunks >= 1 and chunk >= 1
        assert (n_chunks - 1) * chunk < n <= n_chunks * chunk
        if n >= 10_000:
            blocks = -(-n // rows_per_block(2)) * n_chunks
            wave = 132 * BLOCKS_PER_SM
            assert 0.9 * wave * -(-blocks // wave) <= blocks


@pytest.mark.parametrize("sm_count", [1, 108, 132])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 9_973, 10_000, 50_000])
def test_grid_covers_every_column_once_within_shared_memory(n, sm_count):
    """The index arithmetic the wrapper keeps in Python, for every width and
    both kernels: each column lies in exactly one chunk, no chunk is empty,
    the row tiles cover the rows, and the dynamic shared memory a block asks
    for stays within the 48 KB the sources accept, far under the 232,448
    bytes a block of an H100 may use."""
    for d in range(1, 9):
        assert rows_per_block(d) == (512 if d <= 4 else 256)
        assert -(-n // rows_per_block(d)) * rows_per_block(d) >= n
        for backward in (False, True):
            n_chunks, chunk = column_chunks(n, sm_count, d, backward)
            covered = np.zeros(n, dtype=np.int64)
            for k in range(n_chunks):
                lo, hi = k * chunk, min(n, (k + 1) * chunk)
                assert lo < hi
                covered[lo:hi] += 1
            assert np.all(covered == 1)
            assert column_bytes(d, backward) % 4 == 0 and column_bytes(d, backward) >= 4 * d
            assert staged_bytes(chunk, d, backward) <= 232_448
            # the blocks per SM that a wave counts on are resident: their
            # staged chunks, with 1 KB reserved per block, fit an SM's 227 KB
            # of shared memory, and their threads its 2,048
            assert BLOCKS_PER_SM * (staged_bytes(chunk, d, backward) + 1024) <= 227 * 1024
            assert BLOCKS_PER_SM * THREADS <= 2048
            if n >= 9_973:  # enough columns to fill the card: no tiny chunks
                assert chunk >= 64


@pytest.mark.parametrize("n_rows, n", [(2_500, 10_000), (2_501, 10_001), (12_500, 50_000),
                                       (10_000, 2_500), (50_000, 12_500), (5, 40), (1, 1)])
def test_general_grid_covers_every_column_once_in_whole_waves(n_rows, n):
    """The general kernels' grid: a shard of n_rows rows against n columns
    (and pass B of the general K3, the database's rows against the shard's):
    each column in one chunk within the staging budget, and at a mesh
    shard's sizes fewer row tiles take more chunks, so the grid still fills
    whole waves to nine tenths and never runs a little over one."""
    for d in (1, 2, 3, 8):
        for backward in (False, True):
            n_chunks, chunk = column_chunks(n, 132, d, backward, n_rows=n_rows)
            assert (n_chunks - 1) * chunk < n <= n_chunks * chunk
            assert BLOCKS_PER_SM * (staged_bytes(chunk, d, backward) + 1024) <= 227 * 1024
            if n >= 2_500 and n_rows >= 2_500:
                assert chunk >= 32
                blocks = -(-n_rows // rows_per_block(d)) * n_chunks
                wave = 132 * BLOCKS_PER_SM
                assert 0.9 * wave * -(-blocks // wave) <= blocks
    assert column_chunks(10_000, 132, 2, False, n_rows=10_000) == column_chunks(10_000, 132)


def _general_k3_walk(lane: int):
    """The general K3's walk of one block of 32 staged columns, as
    ``column_block`` in ``rowlse_bwd.cu`` indexes it: (the record lane
    ``lane`` loads at step t, the column whose running sum it holds then)
    for t = 0..31, and the column whose sum it holds after the last step.
    A block is staged twice, record e holding column e mod 32; the sum
    moves one lane down after each step."""
    steps = [(lane + t, (lane + t) % LANES) for t in range(LANES)]
    return steps, (lane + LANES) % LANES


def test_general_k3_walk_takes_each_pair_once_and_ends_on_its_own_column():
    """Every lane takes each of the block's 32 columns once, from its
    doubled record; at each step the 32 lanes take 32 distinct columns; the
    running sum a lane holds at step t came from lane + 1 at step t - 1,
    which held the same column; after 32 steps lane l holds column l."""
    walks = [_general_k3_walk(lane) for lane in range(LANES)]
    for lane, (steps, last) in enumerate(walks):
        assert sorted(col for _, col in steps) == list(range(LANES))
        assert all(rec % LANES == col and rec < 2 * LANES for rec, col in steps)
        assert last == lane
    for t in range(LANES):
        assert sorted(walks[lane][0][t][1] for lane in range(LANES)) == list(range(LANES))
        if t:
            for lane in range(LANES):
                assert walks[lane][0][t][1] == walks[(lane + 1) % LANES][0][t - 1][1]


@pytest.mark.parametrize("n_rows, n", [(2_500, 10_000), (2_501, 10_001), (12_500, 50_000),
                                       (10_000, 2_500), (5, 40), (1, 1)])
def test_general_k3_grid_and_scratch_cover_every_partial_once(n_rows, n):
    """The one-pass general K3's grid (:func:`general_bwd_grid`): chunks of
    whole 32-column blocks tile the columns, each (chunk, row) slot of the
    dZq partial and each (row tile, column) slot of the dZdb partial is
    written by one block, the scratch holds exactly those slots, a block's
    staging (each column twice, and each warp's column sums) fits kMaxStaged
    with six blocks resident per SM, and at the mesh's shard sizes (rows of
    the shard against the whole database) the grid fills whole waves to
    nine tenths and never runs a little over one."""
    for d in (1, 2, 3, 8):
        tiles, n_chunks, chunk, scratch = general_bwd_grid(n_rows, n, 132, d)
        assert chunk % LANES == 0 and chunk >= LANES
        assert (tiles - 1) * rows_per_block(d) < n_rows <= tiles * rows_per_block(d)
        q_slots = np.zeros((n_chunks, n_rows), dtype=np.int64)
        db_slots = np.zeros((tiles, n), dtype=np.int64)
        for t in range(tiles):
            rows = slice(t * rows_per_block(d), min(n_rows, (t + 1) * rows_per_block(d)))
            for k in range(n_chunks):
                lo, hi = k * chunk, min(n, (k + 1) * chunk)
                assert lo < hi
                q_slots[k, rows] += 1
                db_slots[t, lo:hi] += 1
        assert np.all(q_slots == 1) and np.all(db_slots == 1)
        assert scratch == (q_slots.size + db_slots.size) * d
        assert staged_bytes(chunk, d, True, columns_summed=True) <= STAGED_BYTES
        assert column_bytes(d, True, columns_summed=True) == 4 * (
            2 * (1 if d == 1 else 2 if d == 2 else 4 if d <= 4 else 8) + THREADS // LANES * d)
        assert BLOCKS_PER_SM * (staged_bytes(chunk, d, True, columns_summed=True) + 1024) <= 227 * 1024
        if 2_500 <= n_rows <= n:
            blocks = tiles * n_chunks
            wave = 132 * BLOCKS_PER_SM
            assert 0.9 * wave * -(-blocks // wave) <= blocks
    # the shard of a 4-way mesh at n = 50,000, d = 2: 92 chunks of 544
    # columns, 25 row tiles, (92 x 12,500 + 25 x 50,000) x 2 doubles of
    # scratch (18.4 MB and 20.0 MB)
    assert general_bwd_grid(12_500, 50_000, 132, 2) == (25, 92, 544, 4_800_000)


@pytest.mark.parametrize("m, n, off, shared", [
    (2_500, 10_000, 7_500, False),  # one wave of 64-column chunks: the rule refuses
    (2_501, 10_001, 7_503, False),
    (12_500, 50_000, 0, True),      # three waves of 544-column chunks
    (12_500, 50_000, 37_500, True),
    (12_500, 50_000, 40_000, False),  # the shard's rows run past the columns
])
def test_k2_general_grid_shares_the_own_block_where_whole_waves_remain(m, n, off, shared):
    """The general K2's rule (:func:`k2_general_grid`): the shard's own
    block is shared only for the student kernel, only when the caller
    states that the shard's rows are the database's, and only where a grid
    of three whole waves has chunks of at least a float32 run (256
    columns); its chunks are whole blocks of 32 columns within the staging
    budget, cover every column once and span three waves; otherwise the
    plain grid is the one :func:`column_chunks` gives."""
    wave = 132 * BLOCKS_PER_SM
    for d in (1, 2, 3, 8):
        plain = column_chunks(n, 132, d, backward=False, n_rows=m)
        tiles = -(-m // rows_per_block(d))
        for kernel, of_db in (("gaussian", True), ("student", False)):
            assert k2_general_grid(m, n, off, 132, d, kernel, of_db) == (False, *plain, tiles)
        got, n_chunks, chunk, got_tiles = k2_general_grid(m, n, off, 132, d, "student", True)
        assert got == shared and got_tiles == tiles
        if not shared:
            assert (n_chunks, chunk) == plain
            continue
        assert chunk % LANES == 0 and chunk >= 256
        assert (n_chunks - 1) * chunk < n <= n_chunks * chunk
        assert staged_bytes(chunk, d, False, columns_summed=True) <= STAGED_BYTES
        assert column_bytes(d, False, columns_summed=True) == 4 * (
            3 * (1 if d == 1 else 2 if d == 2 else 4 if d <= 4 else 8) + THREADS // LANES)
        assert tiles * n_chunks > 2 * wave
    assert k2_general_grid(12_500, 50_000, 0, 132, 2, "student", True) == (True, 92, 544, 25)


def test_general_k3_constants_are_the_sources():
    """The wrapper's grid constants are the general K3's (``rowlse_bwd.cu``)."""
    import re
    from pathlib import Path

    from torchdr_tpu_torch.ops.cuda import reduce_kernel

    src = (Path(reduce_kernel.__file__).parents[1] / "csrc" / "rowlse_bwd.cu").read_text()
    const = dict(re.findall(r"constexpr (?:int|size_t) (k\w+) = ([^;]+);", src))
    assert int(const["kThreads"]) == THREADS and int(const["kBlocksPerSM"]) == BLOCKS_PER_SM
    assert int(const["kLanes"]) == LANES and const["kWarps"] == "kThreads / kLanes"
    assert const["kMaxStaged"] == "227 * 1024 / kBlocksPerSM - 1024"
    assert STAGED_BYTES == 227 * 1024 // BLOCKS_PER_SM - 1024
    assert "static constexpr int kColFloats = 2 * kRec + kWarps * D;" in src


def test_wrappers_check_their_inputs():
    Z = torch.zeros((16, 2))
    with pytest.raises(ValueError, match="kernel"):
        rowlse_fwd(Z, "cauchy")
    with pytest.raises(ValueError, match="float32"):
        rowlse_fwd(Z.double())
    with pytest.raises(ValueError, match="contiguous"):
        rowlse_fwd(torch.zeros((2, 16)).T)
    with pytest.raises(ValueError, match="shape"):
        rowlse_bwd(Z, torch.zeros(15), torch.zeros(16))
