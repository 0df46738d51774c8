"""K2 and K3: the row log-sum of the pairwise embedding kernel, and its
recomputing backward.

Replace the TPU kernels ``torchdr_tpu/ops/pallas/reduce_kernel.py``
(``rowlse_fwd_pallas_general`` and ``rowlse_bwd_pallas_general``, through
their square wrappers ``rowlse_fwd_pallas`` and ``rowlse_bwd_pallas``). The
CUDA sources are ``ops/csrc/rowlse_fwd.cu`` and ``ops/csrc/rowlse_bwd.cu``;
their notes give the bound on the card (the n² pairs' arithmetic, never
memory; at most one special-function call per ordered pair) and what the design
does about it (a register tile of several rows per thread, approximate
reciprocal and exp2, fused multiply-adds, the diagonal test out of the inner
loop, column chunks across blocks so that the grid is whole waves of
resident blocks, each chunk staged once in shared memory, float32 tile sums
into float64 accumulators, no n×n array).

For Z (n, d) and the student kernel k = 1/(1+d²) or the gaussian
k = e^(−d²):

- :func:`rowlse_fwd` gives out_i = log Σ_{j≠i} k(‖z_i − z_j‖²) (the diagonal
  kept when ``exclude_diag`` is False), exact for any spread in the
  gaussian mode, as the JAX package's XLA tier is;
- :func:`rowlse_bwd` gives, for the forward's output ``row_lse`` and its
  cotangent ``g``, dZ_m = 2 Σ_{j≠m} (c_mj + c_jm)(z_m − z_j) with
  c_ij = −g_i e^(−lse_i) q_ij² (student) or −g_i e^(−d²_ij − lse_i)
  (gaussian): the TPU kernel's dZq + dZdb, for Zq = Zdb = Z.

Each launches its kernel for a CUDA tensor and takes its plain version
(:func:`rowlse_fwd_plain`, :func:`rowlse_bwd_plain`: the JAX package's
blockwise XLA tier, by direct differences as the kernels form them) only
for a CPU tensor. Each counts its launches in ``.launches``. In the
student mode (:func:`square_grid`'s rule: while the scratch stays within
``_SYMMETRIC_SCRATCH_BYTES``) the kernels evaluate each unordered pair
once, its value added to its row and to its column, in place of both
orders; ``.symmetric_launches`` counts those calls.

The general form, with the TPU kernels' signature, takes a query shard Zq
(m, d) whose rows have the global ids ``row_offset + i``, the database Zdb
(n_db, d), and ``n_total``: rows and columns whose global id is at or past
it are masked. It serves the row-sharded row log-sum
(``ops/reduce.pairwise_logkernel_rowlse_sharded``):

- :func:`rowlse_fwd_general` gives out_i = log Σ_{j<n_total, j≠row_offset+i}
  k(‖zq_i − zdb_j‖²), −inf for a row past ``n_total``;
- :func:`rowlse_bwd_general` gives (dZq, dZdb): dZq_i = 2 Σ_j c_ij (zq_i −
  zdb_j) and dZdb_j = 2 Σ_i c_ij (zdb_j − zq_i), with the one-sided
  c_ij = −g_i e^(−lse_i) q_ij² or −g_i e^(−d²_ij − lse_i), in one pass
  over the pairs: each pair is evaluated once and its term added to its
  row's sum and its column's (:func:`general_bwd_grid` sizes the grid and
  the scratch).

They have their own kernels and C entry points, count their launches apart
(``rowlse_fwd_general.launches``, ``rowlse_bwd_general.launches``; the
kernels a ``rowlse_bwd_general`` call launched, a pair loop and a merge,
in ``rowlse_bwd_general.kernel_launches``), and take their plain versions
(:func:`rowlse_fwd_general_plain`, :func:`rowlse_bwd_general_plain`: the
JAX package's ``_rowlse_fwd_general`` and ``_rowlse_bwd_general``) only for
CPU tensors. The kernels read no row of Zdb at or past ``min(n_db,
n_total)`` and no row of Zq past ``n_total``: the wrappers pass the live
rows and columns only and fill the others (−inf, zeros).
"""

from __future__ import annotations

import ctypes

import torch

from .build import launch, load_function, sm_count

#: largest embedding width the kernels are instantiated for
MAX_D = 8
KERNELS = ("student", "gaussian")

# The sources' constants, which the grid below must agree with.
_THREADS = 128  # kThreads
_ROWS_PER_THREAD = 4  # Shape<D>::kRows at d <= 4; half of it above
_BLOCKS_PER_SM = 6  # kBlocksPerSM: resident blocks per SM, which the launch bounds allow for
# kMaxStaged, the most a block stages: an SM's 227 KB of shared memory, 1 KB
# of it reserved per block, holds that many blocks
_STAGED_BYTES = 227 * 1024 // _BLOCKS_PER_SM - 1024
_MIN_CHUNK = 64  # fewest columns worth a block of its own
_LANES = 32  # the general kernels walk summed columns in blocks of a warp's width
_WARPS = _THREADS // _LANES
# the kernels that evaluate each unordered pair once (the general K2 sharing
# the shard's own block, the square K2's and K3's symmetric walk): their
# grid's waves; the general K2's shortest chunk (a float32 run, kTile)
_SHARED_WAVES = 3
_SHARED_MIN_CHUNK = 256
# the most scratch the square symmetric walk takes: its row tiles' column
# sums grow as n²/512 (0.11 and 0.29 GB for K2 and K3 at n = 70,000, d = 2),
# so past n of about 218,000 (K2) or 135,000 (K3) at d = 2 the call keeps
# both orders, whose scratch grows 4 to 8 times slower
_SYMMETRIC_SCRATCH_BYTES = 1 << 30


def _check_z(Z, kernel):
    if kernel not in KERNELS:
        raise ValueError(f"[TorchDR-Torch] unknown kernel {kernel!r}; expected one of {KERNELS}.")
    if Z.ndim != 2 or Z.dtype != torch.float32:
        raise ValueError(f"Z must be a 2D float32 tensor, got {Z.dtype} {tuple(Z.shape)}.")
    if not Z.is_contiguous():
        raise ValueError("Z must be contiguous.")


def _check_vec(name, v, Z):
    if v.shape != (Z.shape[0],) or v.dtype != torch.float32:
        raise ValueError(f"{name} must be float32 of shape ({Z.shape[0]},).")
    if v.device != Z.device or not v.is_contiguous():
        raise ValueError(f"{name} must be contiguous and on Z's device.")


def _check_cuda(Z, fn_name):
    if Z.device.type != "cuda":
        raise ValueError(f"{fn_name}: unsupported device {Z.device}.")
    if not 1 <= Z.shape[1] <= MAX_D:
        raise ValueError(f"{fn_name} takes 1 <= d <= {MAX_D} on the card, got d={Z.shape[1]}.")


def _round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple


def rows_per_block(d: int) -> int:
    """Rows of Z one block owns: each thread a register tile of 4 rows, or
    2 above d = 4."""
    return _THREADS * (_ROWS_PER_THREAD if d <= 4 else (_ROWS_PER_THREAD + 1) // 2)


def _z_record(d: int) -> int:
    """Floats of one staged z_j, padded to an aligned vector (``kRec`` of
    K2's ``Shape<D>`` and the general K3's ``General<D>``)."""
    return 1 if d == 1 else 2 if d == 2 else 4 if d <= 4 else 8


def column_bytes(d: int, backward: bool, columns_summed: bool = False) -> int:
    """Bytes of shared memory one staged column takes: z_j padded to an
    aligned vector (K2); z_j with u_j, or g_j and lse_j, padded to whole
    float4s (the square K3). Where the kernel also sums over its columns
    (``columns_summed``), each block of 32 columns is staged twice beside
    each warp's float32 column sums: z_j twice and d sums (the general K3),
    or z_j three times and one sum (the general K2 sharing the shard's own
    block)."""
    rec = _z_record(d)
    if columns_summed:
        return 4 * (2 * rec + _WARPS * d) if backward else 4 * (3 * rec + _WARPS)
    if backward:
        return 4 * ((d + 2 + 3) // 4 * 4)
    return 4 * rec


def symmetric_column_bytes(d: int, backward: bool) -> int:
    """Bytes of shared memory one staged column takes in the square kernels'
    symmetric walk: each block of 32 columns staged twice beside each warp's
    float32 column sums: z_j twice and one sum (K2, ``rowlse_fwd.cu``), or
    z_j with u_j, padded to an aligned vector (``Sym<D>::kRec``), twice and
    d sums (K3, ``rowlse_bwd.cu``)."""
    if backward:
        rec = 2 if d + 1 <= 2 else _round_up(d + 1, 4)
        return 4 * (2 * rec + _WARPS * d)
    return 4 * (2 * _z_record(d) + _WARPS)


def column_chunks(n: int, sm_count: int, d: int = 2, backward: bool = False,
                  n_rows: int | None = None, columns_summed: bool = False):
    """(n_chunks, chunk): column chunk k covers [k·chunk, min(n, (k+1)·chunk)).

    The (row tiles × column chunks) grid fills whole waves of resident
    blocks and never a little more than one (blocks are equal, so a few
    blocks over a wave would cost a whole one): one wave where a chunk then
    fits the staging budget, else the fewest waves that do. A chunk holds
    at least ``_MIN_CHUNK`` columns, unless n is smaller. The grid has
    ``n_rows`` rows (default n, the square form): fewer rows, more chunks.
    A kernel that sums over its columns (``columns_summed``) takes chunks
    of whole blocks of 32 columns.
    """
    granule = _LANES if columns_summed else 1
    row_tiles = -(-(n if n_rows is None else n_rows) // rows_per_block(d))
    wave = sm_count * _BLOCKS_PER_SM
    most = _STAGED_BYTES // column_bytes(d, backward, columns_summed) // granule * granule
    fewest = -(-n // most)
    waves = max(1, -(-row_tiles * fewest // wave))
    n_chunks = max(fewest, min(waves * wave // row_tiles, -(-n // _MIN_CHUNK)))
    chunk = _round_up(-(-n // n_chunks), granule)
    return -(-n // chunk), chunk


def general_bwd_grid(m: int, n_cols: int, sm_count: int, d: int = 2):
    """The general K3's grid and scratch for m live rows against n_cols
    live columns: (row tiles, n_chunks, chunk, scratch doubles). Row tile t
    covers rows [t·rows_per_block(d), ...); column chunk k covers [k·chunk,
    min(n_cols, (k+1)·chunk)), chunk a multiple of 32; the scratch holds
    each chunk's partial of dZq, (n_chunks, m, d), then each row tile's
    partial of dZdb, (row tiles, n_cols, d)."""
    n_chunks, chunk = column_chunks(n_cols, sm_count, d, backward=True, n_rows=m,
                                    columns_summed=True)
    row_tiles = -(-m // rows_per_block(d))
    return row_tiles, n_chunks, chunk, (n_chunks * m + row_tiles * n_cols) * d


def _shared_chunk(m: int, n_cols: int, sm_count: int, d: int, col_bytes: int) -> int:
    """The chunk of a grid that evaluates each unordered pair once, m rows
    against n_cols columns: ``_SHARED_WAVES`` waves of chunks of whole
    blocks of 32 columns, within the staging budget of ``col_bytes`` a
    column. The blocks left idle below the diagonal free their slots to
    later waves, where in one wave the blocks that share (more work each)
    would set the time."""
    row_tiles = -(-m // rows_per_block(d))
    most = _STAGED_BYTES // col_bytes // _LANES * _LANES
    n_chunks = max(1, _SHARED_WAVES * sm_count * _BLOCKS_PER_SM // row_tiles)
    return min(most, _round_up(-(-n_cols // n_chunks), _LANES))


def square_grid(n: int, sm_count: int, d: int = 2, kernel: str = "student",
                backward: bool = False):
    """The square K2's (``backward`` False) or K3's grid: (symmetric,
    n_chunks, chunk, row tiles, scratch doubles).

    ``symmetric``: each unordered pair evaluated once, its value added to
    its row and to its column, on :func:`_shared_chunk`'s grid with the
    staging of :func:`symmetric_column_bytes`. Taken for the student
    kernel while its scratch, the chunks' row sums, (n_chunks, n), then the
    row tiles' column sums, (row tiles, n), each times d for K3, stays
    within ``_SYMMETRIC_SCRATCH_BYTES``; never for the gaussian kernel,
    whose terms are relative to their row's shift. Otherwise both orders of
    each pair on :func:`column_chunks`' grid: the chunks' sums (K2; twice
    that for the gaussian shifts) or (n_chunks, n, d) (K3).
    """
    row_tiles = -(-n // rows_per_block(d))
    width = d if backward else 1
    if kernel == "student":
        chunk = _shared_chunk(n, n, sm_count, d, symmetric_column_bytes(d, backward))
        n_chunks = -(-n // chunk)
        scratch = (n_chunks + row_tiles) * n * width
        if 8 * scratch <= _SYMMETRIC_SCRATCH_BYTES:
            return True, n_chunks, chunk, row_tiles, scratch
    n_chunks, chunk = column_chunks(n, sm_count, d, backward)
    sums = 2 if kernel == "gaussian" and not backward else 1
    return False, n_chunks, chunk, row_tiles, sums * n_chunks * n * width


def k2_general_grid(m: int, n_cols: int, row_offset: int, sm_count: int, d: int = 2,
                    kernel: str = "student", shard_of_db: bool = False):
    """The general K2's grid for m live rows against n_cols live columns:
    (shared, n_chunks, chunk, row tiles).

    ``shared``: the shard's own m × m block evaluates each unordered pair
    once, on :func:`_shared_chunk`'s grid. Taken for the student kernel,
    where the shard's rows are the database's rows [row_offset, row_offset
    + m) (``shard_of_db``), and where that grid's chunks hold at least
    ``_SHARED_MIN_CHUNK`` columns; otherwise the plain grid
    (:func:`column_chunks`).
    """
    row_tiles = -(-m // rows_per_block(d))
    if kernel == "student" and shard_of_db and row_offset + m <= n_cols:
        chunk = _shared_chunk(m, n_cols, sm_count, d, column_bytes(d, False, columns_summed=True))
        if chunk >= _SHARED_MIN_CHUNK:
            return True, -(-n_cols // chunk), chunk, row_tiles
    n_chunks, chunk = column_chunks(n_cols, sm_count, d, backward=False, n_rows=m)
    return False, n_chunks, chunk, row_tiles


def staged_bytes(chunk: int, d: int, backward: bool, columns_summed: bool = False) -> int:
    """Dynamic shared memory a block of the kernel asks for."""
    return chunk * column_bytes(d, backward, columns_summed)


def _sq_block(Zb, Z):
    """(block, n) squared distances and (block, n, d) differences, summed
    over the coordinates in the kernels' order."""
    diff = Zb[:, None, :] - Z[None, :, :]
    sq = diff[..., 0] * diff[..., 0]
    for c in range(1, Z.shape[1]):
        sq = sq + diff[..., c] * diff[..., c]
    return sq, diff


def _diag(r0, b, n, device):
    rows = torch.arange(r0, r0 + b, device=device)
    return rows[:, None] == torch.arange(n, device=device)[None, :]


def rowlse_fwd_plain(Z, kernel="student", exclude_diag=True, block_size=1024):
    """K2's function in plain PyTorch: the JAX package's blockwise XLA tier
    (row blocks, log-kernel, max-shifted log-sum-exp), O(block · n) memory,
    with the sums over j in float64."""
    n = Z.shape[0]
    block = min(block_size, max(8, n))
    out = torch.empty((n,), dtype=Z.dtype, device=Z.device)
    for r0 in range(0, n, block):
        Zb = Z[r0 : r0 + block]
        sq, _ = _sq_block(Zb, Z)
        logq = -torch.log1p(sq) if kernel == "student" else -sq
        if exclude_diag:
            mask = _diag(r0, Zb.shape[0], n, Z.device)
            logq = torch.where(mask, torch.full_like(logq, float("-inf")), logq)
        m = torch.amax(logq, dim=1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))  # a row with no term
        s = torch.exp(logq - m).double().sum(dim=1)
        out[r0 : r0 + block] = (torch.log(s) + m[:, 0].double()).float()
    return out


def rowlse_bwd_plain(Z, row_lse, g, kernel="student", block_size=1024):
    """K3's function in plain PyTorch, over row blocks: the products in
    float32 as the kernel forms them, the sums over j in float64."""
    n = Z.shape[0]
    block = min(block_size, max(8, n))
    u = -(g * torch.exp(-row_lse)) if kernel == "student" else g
    out = torch.empty_like(Z)
    for r0 in range(0, n, block):
        Zb = Z[r0 : r0 + block]
        b = Zb.shape[0]
        sq, diff = _sq_block(Zb, Z)
        if kernel == "student":
            q = 1.0 / (1.0 + sq)
            coef = (u[r0 : r0 + b, None] + u[None, :]) * (q * q)
        else:
            lse_b = row_lse[r0 : r0 + b, None]
            coef = -(g[r0 : r0 + b, None] * torch.exp(-sq - lse_b)
                     + g[None, :] * torch.exp(-sq - row_lse[None, :]))
        coef = torch.where(_diag(r0, b, n, Z.device), torch.zeros_like(coef), coef)
        out[r0 : r0 + b] = (2.0 * (coef[:, :, None] * diff).double().sum(dim=1)).float()
    return out


def _live(m: int, n_db: int, row_offset: int, n_total: int):
    """(rows of the shard, columns of the database) whose global ids lie
    below ``n_total``: a prefix of each."""
    return max(0, min(m, n_total - row_offset)), min(n_db, n_total)


def _check_general(Zq, Zdb, row_offset, n_total, kernel):
    _check_z(Zq, kernel)
    _check_z(Zdb, kernel)
    if Zq.shape[1] != Zdb.shape[1] or Zq.device != Zdb.device:
        raise ValueError("Zq and Zdb must have the same width and device.")
    if int(row_offset) < 0 or int(n_total) < 0:
        raise ValueError("row_offset and n_total must be non-negative.")


def rowlse_fwd_general_plain(Zq, Zdb, row_offset, n_total, kernel="student", exclude_diag=True,
                             block_size=1024):
    """K2's general function in plain PyTorch: the JAX package's
    ``_rowlse_fwd_general`` (row blocks of the shard, max-shifted
    log-sum-exp), by direct differences, the sums over j in float64; −inf
    for a row whose global id is at or past ``n_total``."""
    m = Zq.shape[0]
    m_live, n_cols = _live(m, Zdb.shape[0], int(row_offset), int(n_total))
    out = torch.full((m,), float("-inf"), dtype=Zq.dtype, device=Zq.device)
    Zc = Zdb[:n_cols]
    block = min(block_size, max(8, m))
    for r0 in range(0, m_live, block):
        Zb = Zq[r0 : min(m_live, r0 + block)]
        sq, _ = _sq_block(Zb, Zc)
        logq = -torch.log1p(sq) if kernel == "student" else -sq
        if exclude_diag:
            mask = _diag(int(row_offset) + r0, Zb.shape[0], n_cols, Zq.device)
            logq = torch.where(mask, torch.full_like(logq, float("-inf")), logq)
        mx = torch.amax(logq, dim=1, keepdim=True)
        mx = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))  # a row with no term
        s = torch.exp(logq - mx).double().sum(dim=1)
        out[r0 : r0 + Zb.shape[0]] = (torch.log(s) + mx[:, 0].double()).float()
    return out


def rowlse_bwd_general_plain(Zq, Zdb, row_offset, n_total, row_lse, g, kernel="student",
                             block_size=1024):
    """K3's general function in plain PyTorch: the JAX package's
    ``_rowlse_bwd_general``, over row blocks of the shard: the one-sided
    coefficients in float32 as the kernel forms them, the sums over j (dZq)
    and over i (dZdb) in float64. Returns (dZq (m, d), dZdb (n_db, d))."""
    m, n_db = Zq.shape[0], Zdb.shape[0]
    m_live, n_cols = _live(m, n_db, int(row_offset), int(n_total))
    dZq = torch.zeros_like(Zq)
    dZdb = torch.zeros((n_db, Zdb.shape[1]), dtype=torch.float64, device=Zdb.device)
    Zc = Zdb[:n_cols]
    block = min(block_size, max(8, m))
    for r0 in range(0, m_live, block):
        Zb = Zq[r0 : min(m_live, r0 + block)]
        b = Zb.shape[0]
        sq, diff = _sq_block(Zb, Zc)
        lse_b, g_b = row_lse[r0 : r0 + b, None], g[r0 : r0 + b, None]
        if kernel == "student":
            q = 1.0 / (1.0 + sq)
            coef = -(g_b * torch.exp(-lse_b)) * (q * q)
        else:
            coef = -(g_b * torch.exp(-sq - lse_b))
        mask = _diag(int(row_offset) + r0, b, n_cols, Zq.device)
        coef = torch.where(mask, torch.zeros_like(coef), coef)
        terms = (coef[:, :, None] * diff).double()
        dZq[r0 : r0 + b] = (2.0 * terms.sum(dim=1)).float()
        dZdb[:n_cols] -= 2.0 * terms.sum(dim=0)
    return dZq, dZdb.float()


def rowlse_fwd_general(Zq, Zdb, row_offset, n_total, kernel="student", exclude_diag=True,
                       block_size=1024, shard_of_db=False):
    """Row log-sum of a query shard against the database: (m,) float32.

    ``row_offset`` is the global id of Zq's first row; rows and columns of
    global id ≥ ``n_total`` are masked (a masked row reads −inf).
    ``block_size`` sets the row blocks of the plain version. ``shard_of_db``
    states that Zq's live rows are Zdb's rows ``row_offset`` onwards (the
    row-sharded caller's case): the kernel may then evaluate the shard's
    own block once a pair (:func:`k2_general_grid`).
    """
    _check_general(Zq, Zdb, row_offset, n_total, kernel)
    if Zq.device.type == "cpu":
        return rowlse_fwd_general_plain(Zq, Zdb, row_offset, n_total, kernel, exclude_diag,
                                        block_size)
    _check_cuda(Zq, "rowlse_fwd_general")
    fn = load_function("rowlse_fwd", "rowlse_fwd_general")
    (m, d), row_offset = Zq.shape, int(row_offset)
    m_live, n_cols = _live(m, Zdb.shape[0], row_offset, int(n_total))
    out = torch.full((m,), float("-inf"), dtype=torch.float32, device=Zq.device)
    if m_live == 0:
        return out
    if n_cols == 0:
        raise ValueError("rowlse_fwd_general: no column below n_total.")
    gaussian = kernel == "gaussian"
    shared, n_chunks, chunk, tiles = k2_general_grid(
        m_live, n_cols, row_offset, sm_count(Zq.device.index), d, kernel, shard_of_db)
    # the chunks' sums, then the gaussian chunks' shifts or the shared row
    # tiles' column sums
    extra = n_chunks if gaussian else tiles if shared else 0
    part = torch.empty(((n_chunks + extra) * m_live,), dtype=torch.float64, device=Zq.device)
    rc = launch(
        fn, Zq, Zq.data_ptr(), Zdb.data_ptr(), out.data_ptr(), part.data_ptr(),
        m_live, n_cols, row_offset, d, n_chunks, chunk, int(gaussian), int(bool(exclude_diag)),
        int(shared),
    )
    if rc != 0:
        raise RuntimeError(f"rowlse_fwd_general launch failed: cudaError {rc}.")
    rowlse_fwd_general.launches += 1
    return out


def rowlse_bwd_general(Zq, Zdb, row_offset, n_total, row_lse, g, kernel="student",
                       exclude_diag=True, block_size=1024):
    """Gradients of Σ_i g_i · rowlse_fwd_general(Zq, Zdb, ...)_i: (dZq (m, d),
    dZdb (n_db, d)), the TPU kernel's two outputs.

    A term of equal global ids carries zq_i − zdb_j = 0 when Zq's rows are
    Zdb's, as in the row-sharded caller, so ``exclude_diag`` does not
    enter; that term is dropped always. Rows and columns past ``n_total``
    get zeros. ``block_size`` sets the row blocks of the plain version.
    """
    _check_general(Zq, Zdb, row_offset, n_total, kernel)
    _check_vec("row_lse", row_lse, Zq)
    _check_vec("g", g, Zq)
    if Zq.device.type == "cpu":
        return rowlse_bwd_general_plain(Zq, Zdb, row_offset, n_total, row_lse, g, kernel,
                                        block_size)
    _check_cuda(Zq, "rowlse_bwd_general")
    fn = load_function("rowlse_bwd", "rowlse_bwd_general")
    (m, d), n_db, row_offset = Zq.shape, Zdb.shape[0], int(row_offset)
    m_live, n_cols = _live(m, n_db, row_offset, int(n_total))
    if m_live == 0 or n_cols == 0:
        return torch.zeros_like(Zq), torch.zeros_like(Zdb)
    # the kernels write the live rows; the others stay zero
    dZq = (torch.empty_like if m_live == m else torch.zeros_like)(Zq)
    dZdb = (torch.empty_like if n_cols == n_db else torch.zeros_like)(Zdb)
    _, n_chunks, chunk, scratch = general_bwd_grid(m_live, n_cols, sm_count(Zq.device.index), d)
    part = torch.empty((scratch,), dtype=torch.float64, device=Zq.device)
    kernels = ctypes.c_int(0)
    rc = launch(
        fn, Zq, Zq.data_ptr(), Zdb.data_ptr(), row_lse.data_ptr(), g.data_ptr(),
        dZq.data_ptr(), dZdb.data_ptr(), part.data_ptr(), m_live, n_cols, row_offset, d,
        n_chunks, chunk, int(kernel == "gaussian"), ctypes.byref(kernels),
    )
    rowlse_bwd_general.kernel_launches += kernels.value
    if rc != 0:
        raise RuntimeError(f"rowlse_bwd_general launch failed: cudaError {rc}.")
    rowlse_bwd_general.launches += 1
    return dZq, dZdb


def rowlse_fwd(Z, kernel="student", exclude_diag=True, block_size=1024):
    """Row log-sum of the pairwise kernel: (n,) float32.

    ``block_size`` sets the row blocks of the plain version; the kernel
    chooses its own grid and walk (:func:`square_grid`).
    """
    _check_z(Z, kernel)
    if Z.device.type == "cpu":
        return rowlse_fwd_plain(Z, kernel, exclude_diag, block_size)
    _check_cuda(Z, "rowlse_fwd")
    fn = load_function("rowlse_fwd", "rowlse_fwd")
    n, d = Z.shape
    symmetric, n_chunks, chunk, _, scratch = square_grid(n, sm_count(Z.device.index), d, kernel)
    out = torch.empty((n,), dtype=torch.float32, device=Z.device)
    part = torch.empty((scratch,), dtype=torch.float64, device=Z.device)
    rc = launch(
        fn, Z, Z.data_ptr(), out.data_ptr(), part.data_ptr(),
        n, d, n_chunks, chunk, int(kernel == "gaussian"), int(bool(exclude_diag)), int(symmetric),
    )
    if rc != 0:
        raise RuntimeError(f"rowlse_fwd launch failed: cudaError {rc}.")
    rowlse_fwd.launches += 1
    rowlse_fwd.symmetric_launches += int(symmetric)
    return out


def rowlse_bwd(Z, row_lse, g, kernel="student", block_size=1024):
    """Gradient of Σ_i g_i · rowlse_fwd(Z)_i with respect to Z: (n, d).

    The diagonal term carries z_m − z_m = 0, so the forward's
    ``exclude_diag`` does not enter. ``block_size`` sets the row blocks of
    the plain version.
    """
    _check_z(Z, kernel)
    _check_vec("row_lse", row_lse, Z)
    _check_vec("g", g, Z)
    if Z.device.type == "cpu":
        return rowlse_bwd_plain(Z, row_lse, g, kernel, block_size)
    _check_cuda(Z, "rowlse_bwd")
    fn = load_function("rowlse_bwd", "rowlse_bwd")
    n, d = Z.shape
    symmetric, n_chunks, chunk, _, scratch = square_grid(
        n, sm_count(Z.device.index), d, kernel, backward=True)
    out = torch.empty_like(Z)
    part = torch.empty((scratch,), dtype=torch.float64, device=Z.device)
    rc = launch(
        fn, Z, Z.data_ptr(), row_lse.data_ptr(), g.data_ptr(), out.data_ptr(), part.data_ptr(),
        n, d, n_chunks, chunk, int(kernel == "gaussian"), int(symmetric),
    )
    if rc != 0:
        raise RuntimeError(f"rowlse_bwd launch failed: cudaError {rc}.")
    rowlse_bwd.launches += 1
    rowlse_bwd.symmetric_launches += int(symmetric)
    return out


rowlse_fwd.launches = 0
rowlse_bwd.launches = 0
rowlse_fwd.symmetric_launches = 0
rowlse_bwd.symmetric_launches = 0
rowlse_fwd_general.launches = 0
rowlse_bwd_general.launches = 0
rowlse_bwd_general.kernel_launches = 0
