"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi);
2. build: every CUDA kernel, from the sources in the checkout (one nvcc per
   source, started together);
3. kernels: each kernel of the fits (K1, K2, K3) against its plain PyTorch
   version on the card (K1 also against a float64 evaluation), at the main
   paths' shapes plus edge cases, with its time, the plain version's time
   and its bound;
4. fits, each with every kernel launch counter set to 0 just before and
   read just after: ``UMAP(random_state=0).fit_transform(X)`` on 60,000 x
   784 float32 synthetic data (50 Gaussian clusters, seeded), then
   ``TSNE(random_state=0)`` and ``SNE(random_state=0, lr=n/12)`` on
   10,000 x 784 from the same generator; phase times, peak memory, launches, NaN check and a
   10-NN label accuracy of the embedding;
5. the estimators without a kernel of their own, as in phase 4 (every
   launch counter must read 0): ``LargeVis(random_state=0)``,
   ``InfoTSNE(random_state=0, lr=INFOTSNE_LR)`` (n/40: "auto" misses the
   accuracy gate here, in the JAX package too) and
   ``PACMAP(random_state=0)`` on the 60,000 x 784 rows, and
   ``TSNEkhorn(random_state=0, min_grad_norm=TSNEKHORN_MIN_GRAD_NORM)`` on
   the 10,000 x 784 rows (at the default 1e-4 it stops after its first
   step, in the JAX package too);
6. IVF: ``ivf_build`` and a second, synchronised ``ivf_knn`` on 1,300,000 x 50
   float32 clustered rows (``benchmarks.ivf_recall.make_clustered``: 50
   Gaussian clusters, component j scaled by 1/(j + 1), seed 0), timed, with
   the knobs the defaults resolve to and a query block of one chunk of the
   index; recall@30 of that graph on 2,000 rows against the exact
   ``knn_graph`` (fails below 0.95); then ``UMAP(random_state=0,
   knn_mode=KnnConfig(mode="ivf", precision="high", ivf_block=chunk))`` (the
   IVF preset at that block) on the same rows, as in phase 4;
7. gather: the bucketed gathers G1-G3 against their plain versions bit for
   bit, at small windows, at edge cases of their walks over k-steps and
   members, and at the attraction-gather microbenchmark's full shape (20,312
   windows of 512 rows, 1,024 ids each, D = 8), with their eager times,
   their times replayed from a CUDA graph and the times of one
   ``torch.gather`` for the same function (medians of 7 alternating
   repeats, with their spread); then that microbenchmark
   (``torchdr_tpu_torch.benchmarks.gather_microbench.main``) with every
   launch counter set to 0 just before and read just after;
8. spectral, as in phase 4 (every launch counter must read 0; none of
   these has a kernel), each fit also scored by the port's own ``eval``
   (10-NN label agreement, silhouette, ARI of 50-means): cuSOLVER's SVD
   drivers on one IncrementalPCA update; ``IncrementalPCA`` and
   ``ExactIncrementalPCA`` at k = 50 on the 60,000 x 784 rows, each
   capturing the variance of the port's ``PCA`` within 1e-4 (and
   ``IncrementalPCA`` at k = 2, reported); ``KernelPCA`` on 10,000 x 784
   rows with a Gaussian kernel at the median squared distance, by eigh and
   by LOBPCG at ``tol`` KPCA_TOL (top eigenvalues within 1e-4 lambda_1 of
   eigh's; the JAX package's stop is reported beside it) and with the
   self-tuning kernel (dense LOBPCG, reported); the matrix-free LOBPCG on
   the 60,000 rows, with its iterations, one product's time and each pair's
   residual |HKHv - lambda v| (within 1e-3 lambda_1); ``PHATE(random_state=0)``
   on the 10,000 rows at its defaults (10-NN accuracy at least 0.9);
9. mesh: on a 4-way mesh of the one card (``make_mesh(devices=["cuda:0"] *
   4)``; a device may repeat in a mesh), the general K2 and K3 against
   their plain versions on every shard of n = 10,000 (2,500 rows a shard),
   10,001 (a padded last shard), d = 3, the underflowing gaussian grid and
   n = 50,000, in both modes; the sharded row log-sum and its gradient
   against the square kernels at n = 10,000 and 50,000; the general
   kernels' times on one shard (eager and replayed from a CUDA graph) and
   one sharded step beside one square step; then ``TSNE(random_state=0,
   mesh=M4)`` and ``SNE(random_state=0, lr=n/12, mesh=M4)`` on the 10,000
   rows (the general kernels launched 4 times a step, the square ones
   never; the input affinity equal to the one without the mesh) and
   ``UMAP(random_state=0, mesh=M4)`` on the 60,000 rows (the symmetrized
   affinity equal to the one without the mesh; K1 once a step), each
   beside its fit without the mesh; where more than one card is visible,
   the t-SNE fit on a mesh of the real cards;
10. engine: ``COSNE(random_state=0)`` on the 10,000 x 784 rows at its
    defaults (inside the ball, 10-NN accuracy at least
    COSNE_DEFAULT_MIN_ACC: its norm-matching term drives the points to the
    ball's edge here, in the JAX package too; every launch counter 0), with
    its steps' time and one forward-plus-backward of its O(n^2) row log-sum
    timed alone, then with ``learning_rate_for_h_loss=0`` (accuracy at
    least 0.9); parametric UMAP on the 60,000 rows
    (``encoder=make_mlp_encoder(2, (256, 256))``, Adam at lr 1e-3; K1 once a
    step; ``transform`` of the training rows equal to ``embedding_`` within
    1e-5, and of 10,000 new rows from the same clusters, scored by their 10
    nearest training rows); parametric t-SNE on the 10,000 rows with the
    same encoder (K2 and K3 once a step); ``UMAP(random_state=0,
    edge_schedule="bands")`` on the 60,000 rows (K1 once a step, its band
    widths printed), each with 10-NN accuracy at least 0.9 and beside the
    phase-4 fit of the same estimator;
11. kNN tiers, at the JAX package's 10M operating point (10,000,000 x 128
    float32 rows around 10,000 centres drawn N(0, 10^2), unit noise, made
    on the card; recall@15 against the exact kNN of 2,000 seeded rows;
    k = 15, nprobe 12, budget 128): (a) ``ivf_build`` at its defaults,
    where ``storage="auto"`` must take the bf16 residual split, and
    ``ivf_knn`` (recall at least 0.99; also ``scan_fidelity="hi"``,
    reported), with build and search seconds, peak and resident GB and the
    resolved knobs; (b) ``storage="int8"``, symmetric and asymmetric
    scoring (each at least 0.95); (c) supers nomination
    (``nprobe_supers=16``) beside flat and adjacency, reported; (d) each
    tier (split, int8, int8 with supers) built from the first 20,000 rows
    on the card, searched there and, moved by ``index_from_numpy``, on the
    CPU (ids equal on at least 0.999 of the pairs, distances within 1e-4
    relative); (e) ``knn_graph_streaming`` over the rows written to a
    ``.npy`` in a temporary directory (deleted after), read by
    ``NpyBatchLoader`` in batches of 2^18 rows (backend "native"), in two
    segments, its builds, queries and host merges timed apart (at least
    0.95); (f) ``knn_graph_from_batches`` over 64 batches of bench.py's
    data (1,000,000 x 128, 1,000 centres), equal as sets to ``knn_graph``
    on 2,000 rows; (g) ``pq_knn`` on its first 100,000 rows at M = 16, the
    refined recall at least 0.1 above the ADC's; (h) recall@30 of the int8
    and float32 graphs of phase 6's rows, then ``UMAP(random_state=0,
    knn_mode=KnnConfig(mode="ivf", precision="high", ivf_block=chunk,
    storage="int8"))`` there, as in phase 4 (K1 once a step); (i)
    ``ivf_knn_sharded`` on the int8 index over a 4-way mesh of the card,
    each row's ids equal as sets to the single-device search's on at
    least 0.999 of the rows;
12. the user API: ``python -m torchdr_tpu_torch.cli info`` names the card;
    ``cli run`` of a script that fits ``UMAP(random_state=0)`` on the
    60,000 rows and prints its fit seconds, K1 launches (1,000) and 10-NN
    accuracy (at least 0.9), and of one whose ``make_mesh()`` under
    ``--virtual-cpu-devices 2`` must be two CPU devices; phase 4's UMAP,
    ``PCA(n_components=50)`` on the 60,000 rows and phase 10's parametric
    UMAP saved by ``utils.save_estimator`` and loaded onto the card by
    ``load_estimator`` (the embedding and PCA's ``transform`` bit for bit,
    the parametric ``transform`` of the 10,000 new rows within 1e-6), with
    save and load seconds and file sizes; ``TSNE(random_state=0,
    max_iter=100)`` on the 10,000 rows and ``UMAP(random_state=0,
    max_iter=100)`` on the 60,000 under ``utils.device_trace``, the trace's
    events of each hand kernel (by its ``__global__`` name) equal to its
    wrapper's launch count, with their traced device time; the four parts
    timed by ``utils.PhaseTimer``;
13. the examples gallery: each script of ``torchdr_tpu_torch/examples/`` at
    its full default size, in-process through its ``main([])`` (which raises
    when one of its gates fails), every launch counter set to 0 just before
    and read just after: K1 must launch on each UMAP script, K2 and K3 on
    each t-SNE/SNE script, and no kernel elsewhere (``EXAMPLE_KERNELS``);
    one JSON line a script (seconds, numbers, launches); then the runner
    ``python -m torchdr_tpu_torch.examples --match basic_usage`` once in a
    fresh process, its exit code and summary line checked;
14. the benchmarks: (a) after ``torch.set_float32_matmul_precision("high")``,
    ``knn_graph`` (k = 15) on the 60,000 x 784 rows gives the ids of a call
    without it, distances within 1e-6 relative, and the user's "high" reads
    back after the call (the same search outside the port's entry point, at
    the user's TF32, reported beside it); (b) the package without
    ``_build/`` copied into a read-only temporary directory, imported by a
    fresh process with a temporary HOME (as the user nobody when this runs
    as root), builds K1 into ``~/.cache/torchdr_tpu_torch/build`` and
    launches it against its plain version, with nothing written inside the
    copy; (c) ``python -m torchdr_tpu_torch.cli bench``, the headline 1M x
    128 IVF kNN, its JSON line printed and its recall@15 held to 0.95; (d)
    ``benchmarks.knn_benchmark`` at its defaults (100,000 x 128; every tier
    at recall 0.999 or more); (e) ``benchmarks.umap_single_cell`` at its
    defaults (200,000 x 50, 500 steps), plain and ``--distributed``, every
    launch counter set to 0 just before and read just after: K1 once a
    step, every other kernel 0, 10-NN accuracy at least 0.9;
15. with ``--sass`` only: the registers of the d = 2 and d = 3 kernels (d = 8
   for the gathers; ``cuobjdump -res-usage``) and the instruction counts of
   those kernels' inner loops, per tensor-core product where they make any
   (``cuobjdump -sass``);
16. with ``--profile`` only: device time by kernel and the device's idle
    share over 200 optimizer steps of the UMAP fit and of the t-SNE fit,
    and over 100 steps of each fit of phase 5 (torch.profiler);
17. real data: ``benchmarks.real_digits`` on the 1,797 x 64 handwritten
    digits (the JAX script's six estimators, each fitted cold and warm), every
    launch counter set to 0 just before each fit and read just after: K1 once
    a step on UMAP, K2 and K3 on TSNE and SNE, no kernel on LargeVis,
    InfoTSNE and PACMAP; each fit's 10-NN accuracy and trustworthiness held
    to the JAX script's CPU reading (``real_digits.gates``), and each
    embedding's trustworthiness on the card to the CPU's within 1e-5; before
    the fits, K1 at their shape (1,797 rows, 2,048 shared negatives: more
    than the rows) and K2, K3 at 1,797 rows in both modes, each against its
    plain version as in phase 3; then ``benchmarks.profile_umap_step`` at its
    full shape (60,000 rows, 240 neighbours, 150 negatives), its seven
    readings with their CUDA-event times, its outputs finite, and one more
    call of each part on the card held to the same part on the CPU on the
    same inputs.

With ``--k1`` it builds, checks and times K1 alone and stops after phase 3
(with ``--sass``, K1's report): the quick way to compare two versions of that
kernel in one call. With ``--gather`` it builds the gathers alone and runs
phase 7 only (with ``--sass``, their report). With ``--ivf`` it builds K1 and
runs phase 6 alone. With ``--ne`` it builds nothing and runs phase 5 alone;
with ``--spectral``, phase 8 alone; with ``--mesh`` it builds K1, K2 and K3
and runs phase 9 alone (with the three fits without a mesh beside it). With
``--engine`` it builds K1, K2 and K3 and runs phase 10 alone, with the
UMAP and t-SNE fits of phase 4 beside it. With ``--tiers`` it builds K1
and runs phase 11 alone (~7 min). With ``--api`` it builds K1, K2 and K3,
fits phase 4's UMAP and phase 10's parametric UMAP, and runs phase 12. With
``--examples`` it builds K1, K2 and K3 and runs phase 13 alone. With
``--bench`` it builds K1 and runs phase 14 alone. With ``--digits`` it
builds K1, K2 and K3 and runs phase 17 alone. With
``--rowlse`` it builds K2 and K3 alone, checks and times the square ones as
in phase 3 and the general ones, the sharded row log-sum and its step as in
phase 9, and stops (~1 min): the quick way to compare two versions of the
row log-sum kernels in one call, this script being copied into the other
tree's checkout. Each of these prints no result line.

It prints one JSON line of kernel records, the card's name and power limit,
and as its last line ``{"ok": true, "device": {...}}``. Without a CUDA
device, or without the rest of the repository beside it, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

N, D_IN, N_CLUSTERS, SEED = 60_000, 784, 50, 0
N_TSNE = 10_000  # the exact t-SNE/SNE paths' size
# TSNEkhorn's default min_grad_norm (1e-4) lies above its gradient's norm at
# the PCA init scaled to 1e-4, so the fit stops at its first convergence
# check, after one step, in the JAX package too; the other estimators'
# default lets its 2,000 steps run
TSNEKHORN_MIN_GRAD_NORM = 1e-7
# InfoTSNE's lr="auto" (n/4 = 15,000 after the exaggeration phase) leaves the
# 60,000 rows at 10-NN accuracy 0.847 after its 1,000 steps (0.864 in the
# JAX package on the CPU; 1.0 at n = 5,000 in both): its clusters have not
# separated yet. n/40 reads 0.9993 on the card, n/12 0.9781
INFOTSNE_LR = N / 40
N_LARGE = 50_000  # K2/K3 are also timed here: the pair work grows as n squared
# K1 is timed at (n, S, d): the UMAP path's shape, the same in 3-D, a size
# where the device and not the host bounds a step, the sample of 2048 that
# the estimator draws at small n, and the IVF path's shape
K1_SHAPES = ((60_000, 512, 2), (60_000, 512, 3), (1_000_000, 512, 2), (10_000, 2048, 2),
             (1_300_000, 512, 2))
# The IVF path: BASELINE.json's "UMAP on 1.3M-cell scRNA-seq" at its 50
# principal components, on clustered rows whose component j is scaled by
# 1/(j + 1). That spectrum is an assumption, not taken from published
# single-cell data: of the decays tried (0, 0.5, 1) it is the smallest at
# which recall@30 clears IVF_RECALL_MIN. Isotropic 50-D noise is the worst
# case of any IVF index: at nprobe 16 of the ~91 cells of a cluster,
# recall@30 is 0.34 with either nomination (PERF.md section 5). The search
# and the fit take a query block of one chunk of the index (the chunk
# depends on n and the cell count only: 384 here), so that no block
# straddles two cells: adjacency nomination samples a block's home cell at
# its first row only, as the JAX package does (ops/ivf.py), and at the
# default block of 256 the rows of a block's second cell lose recall.
N_IVF, D_IVF, IVF_DECAY, IVF_K, IVF_NPROBE = 1_300_000, 50, 1.0, 30, 16
IVF_EVAL_ROWS, IVF_RECALL_MIN = 2_000, 0.95
K1_SFU_CALLS = 2.5  # per pair, as K1 is built: lg2, ex2, and one reciprocal for two pairs
# The spectral phase. IncrementalPCA is approximate: each update keeps k
# components of the augmented matrix. At k = 2 the first two of the rows' 49
# between-cluster directions (eigenvalues 383.9, 368.6, 358.0, 355.4) are
# too close for that: it captures 1.42 % less variance than PCA, as
# sklearn's IncrementalPCA does on the same rows (1e-8 from the port, on the
# CPU). At k = 50, the 49 directions and one of noise, it is within 1e-5, so
# both incremental PCAs are held to PCA there; k = 2 is reported beside it.
IPCA_K = 50
CAPTURED_TOL = 1e-4  # |captured - PCA's| / PCA's
# KernelPCA's LOBPCG stops, as in the JAX package, when every pair's residual
# is below 10 n eps (|AX| + theta): 0.0119 at n = 10,000 and 0.0715 at
# 60,000, so the near-degenerate top pairs of these 50 clusters stop far from
# converged (on 5,000 rows of this generator: lambda_2 8.9e-4 lambda_1 from
# eigh's, residual 1.0e-2 lambda_1, on the CPU). The fits set a relative
# residual tolerance instead; the default is run and reported at 10,000.
KPCA_TOL = 1e-4
KPCA_EIG_TOL = 1e-4  # |LOBPCG - eigh| / lambda_1 on the top two eigenvalues
KPCA_RESID_TOL = 1e-3  # |HKHv - lambda v| / lambda_1
S_MAIN = 512  # shared negatives of the UMAP path at n = 60k
# K1 is held to a float64 evaluation of its function (the plain version on
# double tensors) and to the plain version:
#   max |kernel - float64| <= K1_HARD, the JAX package's own tolerance for its
#     kernel against a float64 reference;
#   max |kernel - float64| <= 3 max(max |plain - float64|, 2e-6): the kernel is
#     not much further from the truth than the plain version is;
#   max |kernel - plain| <= TOL_K1. The largest error sits in one term: a
#     negative at D ~ eps from its row gives |coef (z_i - z_s)| up to
#     b / sqrt(eps) = 28, times a weight of up to 1.2. Each version rounds
#     that term four or five times in float32 (2^-24 each: the plain version
#     alone is 4e-6 to 9e-6 from float64 on these inputs), and not at the same
#     places (fused multiply-adds, an approximate reciprocal of a product of
#     two), so they differ by up to ~1e-5 there. The kernel's float32 runs
#     (16 terms after such a term, each rounded at ulp(28) = 1.9e-6) add a few
#     1e-6. Measured 6e-6 to 9.1e-6; with summation made exact it was still
#     5.7e-6 to 7.2e-6, so 1e-5 would hold by chance only.
K1_HARD = 1e-4
TOL_K1 = 2e-5
# K2: |kernel - plain| <= TOL_K2 * max(1, |plain|). Float32 tile sums of at
# most 256 terms (kernel) against one float32 logsumexp over the row
# (plain): both ~1e-6 relative in the row sum, so ~1e-6 in the log.
TOL_K2 = 1e-5
# K3: max |kernel - plain| <= TOL_K3 * max |plain|. The same float32
# products, summed in float32 tiles then float64 (kernel) or in float64
# (plain); a force is a sum of terms of both signs, so the tiles' error is
# relative to the sum of |terms|, which exceeds |force|.
TOL_K3 = 1e-4
# The gathers G1-G3 are held to their plain versions bit for bit: each output
# element is one term. Small cases: one window of 128 ids at each (D, R);
# the full shape is compared GATHER_CHUNK windows at a time.
GATHER_CASES = tuple((d, r) for d in (1, 2, 3, 8) for r in (32, 64, 512))
# Edge cases of the walks (G2 visits only the k-steps of 16 window rows that
# a tile's 16 ids hit, G3 only the column tiles that hold a row's member of
# its group of 32): (ids, D, R, c), 16 windows each. R = 1024 and 2048 give
# G3 two and four stage-1 k-steps; c = 40 leaves a warp part of a tile.
GATHER_ID_KINDS = ("one k-step", "every k-step", "k-step edges", "one member", "every member")
GATHER_EDGE_CASES = tuple(
    (kind, d, r, 1024) for kind in GATHER_ID_KINDS for d in (3, 8) for r in (512, 1024, 2048)
) + tuple(("uniform", d, r, 40) for d in (1, 8) for r in (512, 2048))
GATHER_CHUNK = 2048
GATHER_REPEATS = 7  # eager, graph and library times: medians of alternating repeats
# The mesh phase: a 4-way mesh of the one card (a device may repeat in a
# mesh); the general K2 and K3 are held to their plain versions on each
# shard's rows, at the shards of these (n, d, kernel) cases, and the sharded
# row log-sum to the square kernels.
MESH_WORLD = 4
MESH_CASES = (
    ("main d=2", N_TSNE, 2, "student"),
    ("main d=2 gaussian", N_TSNE, 2, "gaussian"),
    ("padded last shard", N_TSNE + 1, 2, "student"),
    ("padded last shard gaussian", N_TSNE + 1, 2, "gaussian"),
    ("d=3", N_TSNE, 3, "student"),
    ("d=3 gaussian", N_TSNE, 3, "gaussian"),
    ("large", N_LARGE, 2, "student"),
    ("large gaussian", N_LARGE, 2, "gaussian"),
)
# The sharded input affinity against the single-device one: the same rows,
# kNN blocks of other heights (another gram algorithm may round the last
# bit), so the values are held to 1e-6 rather than bit for bit.
MESH_AFFINITY_TOL = 1e-6

# The engine phase. The parametric fits train the JAX package's MLP encoder
# at hidden widths (256, 256) with Adam at lr 1e-3: the estimators' default
# SGD at lr "auto" (n/4 and more) is a rate for the coordinates of a free
# embedding, not for network weights
ENCODER_HIDDEN = (256, 256)
ENCODER_LR = 1e-3
N_NEW = 10_000  # new rows that a parametric UMAP's transform embeds
# COSNE at its defaults matches each point's hyperbolic distance to the
# origin, squared, to its input's squared norm (~1.3e4 on these rows): that
# term drives every point to the ball's float32 edge, and the 10-NN accuracy
# there is 0.5495 in the JAX package and 0.5485 in the port on 2,000 of
# these rows on the CPU (tests/_fit_quality.py; silhouette 0.0096 in both).
# The defaults' fit is held to COSNE_DEFAULT_MIN_ACC; a second fit without
# that term (learning_rate_for_h_loss=0: 1.0 in the JAX package on the same
# 2,000 rows) is held to the 0.9 of every other fit
COSNE_DEFAULT_MIN_ACC = 0.5
TRANSFORM_TOL = 1e-5  # |transform(X) - embedding_| on the training rows

# The kNN tiers phase at the JAX package's 10M operating point
# (benchmarks/_ivf10m_driver2.py): 10,000,000 x 128 float32 rows around
# 10,000 centres drawn N(0, 10^2), unit noise, made on the card in 1M-row
# segments from a torch.Generator seeded 0; ground truth the exact kNN of
# TIERS_EVAL_ROWS seeded rows. The split tier is held to 0.99 (the JAX
# package's TPU run read 0.99913 at budget 128, docs/ROUND5_STATUS.md), int8
# to 0.95, under its quantizer's ceiling there (0.982). Supers have no
# recall gate: at this density the JAX package measured them losing recall.
N_TIERS, D_TIERS, TIERS_CENTERS, TIERS_SEG = 10_000_000, 128, 10_000, 1_000_000
TIERS_K, TIERS_NPROBE, TIERS_BUDGET, TIERS_SUPERS = 15, 12, 128, 16
TIERS_EVAL_ROWS = 2_000
SPLIT_RECALL_MIN, INT8_RECALL_MIN, STREAM_RECALL_MIN = 0.99, 0.95, 0.95
# card against CPU: each tier built on the card from the first
# TIERS_CPU_ROWS rows, then searched there and, moved, on the CPU
TIERS_CPU_ROWS, CPU_AGREE_MIN, CPU_DIST_RTOL = 20_000, 0.999, 1e-4
# the streaming run: STREAM_ROWS of the rows written to a .npy, read by the
# native loader in batches of STREAM_BATCH rows, in two segments
STREAM_ROWS, STREAM_BATCH = N_TIERS, 1 << 18
# the exact tier over batches and PQ, on bench.py's data (1M x 128, 1,000
# centres drawn N(0, 10^2), unit noise, k = 15)
N_BENCH, BENCH_CENTERS, EXACT_BATCHES, N_PQ, PQ_M, PQ_GAIN = 1_000_000, 1_000, 64, 100_000, 16, 0.1
SHARDED_AGREE_MIN = 0.999  # rows whose sharded ids equal the single-device ones as sets

# The user-API phase. The CLI-run UMAP fit on the 60,000 rows reads K1
# 1,000 times (once a step) and a 10-NN accuracy of at least API_MIN_ACC; a
# loaded parametric UMAP's transform of the N_NEW new rows is held within
# PUMAP_LOAD_TOL of the fitted one's (the same weights, read back from float32
# files, on the same card); the loaded UMAP's embedding and PCA's transform
# are held bit for bit. The traced fits run TRACE_STEPS steps.
API_MIN_ACC, API_UMAP_STEPS, PUMAP_LOAD_TOL, TRACE_STEPS = 0.9, 1000, 1e-6, 100
# each launch-counting wrapper of the traced fits, and the __global__ kernels
# one of its calls launches, once each (matched as substrings of the traced
# names, mangled or demangled; no name is a substring of another)
TRACED_KERNELS = {
    "fused_shared_repulsion": ("repulsion_kernel",),
    "rowlse_fwd": ("rowlse_partial_kernel", "rowlse_merge_kernel"),
    "rowlse_bwd": ("rowlse_bwd_partial_kernel", "rowlse_bwd_merge_kernel"),
}
# the script that the CLI runs: the north-star fit, its K1 launches and its
# 10-NN accuracy as one JSON line (chip_smoke is importable: the CLI runs
# from the checkout's root)
CLI_UMAP_SCRIPT = """
import json, sys, time
import torch
from chip_smoke import knn_label_accuracy
from torchdr_tpu_torch import UMAP
from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered
from torchdr_tpu_torch.ops.cuda.umap_kernel import fused_shared_repulsion

n, d, clusters, seed = (int(a) for a in sys.argv[1:5])
X, labels = make_clustered(n, d, clusters, seed=seed)
model = UMAP(random_state=0, device="auto")
fused_shared_repulsion.launches = 0
t0 = time.perf_counter()
Z = model.fit_transform(X)
fit_s = time.perf_counter() - t0
acc = knn_label_accuracy(torch, torch.from_numpy(Z).cuda(), torch.from_numpy(labels).cuda())
print(json.dumps({"fit_s": fit_s, "steps": model.n_iter_,
                  "k1_launches": fused_shared_repulsion.launches, "knn10_label_acc": acc}))
"""
CLI_MESH_SCRIPT = """
from torchdr_tpu_torch.parallel import make_mesh
print("MESH", [str(d) for d in make_mesh().devices])
"""

# The examples gallery (phase 13): every script of torchdr_tpu_torch/examples/
# at its full default size, in-process through its main(), with the kernels
# it must launch (every other counter must read 0), and the runner once in a
# fresh process on the script EXAMPLE_RUNNER_MATCH names
K2_K3 = ("rowlse_fwd", "rowlse_bwd")
EXAMPLE_KERNELS = {
    "affinities/demo_ea_adaptivity": (),
    "affinities/single_vs_multi_device_umap_affinity": (),
    "basics/basic_usage": ("fused_shared_repulsion", *K2_K3),
    "basics/demo_ne_methods": ("fused_shared_repulsion", *K2_K3),
    "basics/demo_pca_via_affinity_matcher": (),
    "basics/demo_tsne_swiss_roll": K2_K3,
    "basics/demo_tsne_vs_cosne": K2_K3,
    "basics/incremental_pca": (),
    "basics/parametric_umap": ("fused_shared_repulsion",),
    "distributed/distributed_umap": ("fused_shared_repulsion",),
    "distributed/knn_accuracy_benchmark": ("fused_shared_repulsion",),
    "distributed/neighborhood_preservation_benchmark": ("fused_shared_repulsion",),
    "single_cell/single_cell": K2_K3,
}
EXAMPLE_RUNNER_MATCH = "basic_usage"

# The benchmarks phase (14). (a) the float32 grams: knn_graph on phase 4's
# rows after the user's set_float32_matmul_precision("high") gives the ids of
# a call without it, with distances within F1_DIST_RTOL relative (a TF32
# gram keeps ~3 digits: the same search outside the port's entry point is
# reported beside it); (b) an installed, read-only copy of the package (the
# files a wheel ships: the package without _build/) builds K1 into
# ~/.cache/torchdr_tpu_torch/build and launches it against its plain version;
# (c) the headline bench through the CLI, held to the recall@15 bar of
# PERF.md section 2; (d) the kNN benchmark at its defaults, every tier
# computing the exact float32 graph in the port; (e) the single-cell UMAP
# benchmark at its defaults, plain and --distributed, K1 once a step and no
# other kernel, held to the 10-NN accuracy of run_fit.
F1_K, F1_DIST_RTOL = 15, 1e-6
BENCH_RECALL_MIN, KNN_BENCH_RECALL_MIN, SINGLE_CELL_MIN_ACC = 0.95, 0.999, 0.9
NOBODY = 65534  # the uid and gid the read-only copy runs under when this runs as root
F2_CHILD = """
import json, os, torch
import torchdr_tpu_torch
from torchdr_tpu_torch.models.neighbor.umap import find_ab_params
from torchdr_tpu_torch.ops.cuda.build import build_dir
from torchdr_tpu_torch.ops.cuda.umap_kernel import fused_shared_repulsion, shared_repulsion_plain

g = torch.Generator(device="cuda")
g.manual_seed(0)
n, S = 60_000, 512
Z = 3.0 * torch.randn((n, 2), generator=g, device="cuda")
neg = torch.randint(0, n, (S,), generator=g, device="cuda")
w = torch.randint(0, 600, (n,), generator=g, device="cuda").float() / S
a, b = find_ab_params(1.0, 0.1)
got = fused_shared_repulsion(Z, neg, w, a, b, 1e-3)
launches = fused_shared_repulsion.launches
plain = shared_repulsion_plain(Z, neg, w, a, b, 1e-3)
torch.cuda.synchronize()
print(json.dumps({"package": os.path.dirname(torchdr_tpu_torch.__file__),
                  "build_dir": str(build_dir()), "launches": launches,
                  "max_abs_err": float((got - plain).abs().max()),
                  "finite": bool(torch.isfinite(got).all())}))
"""

# The real-data phase (17): the digits record (benchmarks.real_digits) on the
# card, each fit held to the JAX script's CPU reading by real_digits.gates,
# each of its two fits (cold, warm) to DIGITS_KERNELS once a step taken and
# every other kernel 0, and each embedding's torch trustworthiness on the card
# to the same function on the CPU within DIGITS_TW_TOL; then the UMAP step
# decomposition (benchmarks.profile_umap_step) at its full shape, its outputs
# finite, and each part on the card within STEP_ATOL + STEP_RTOL * |cpu| of
# the same part on the CPU (float32 sums of up to 240 terms in another order;
# the parts' CPU functions are held to the JAX formulas at 1e-5 in the tests)
DIGITS_KERNELS = {"UMAP": ("fused_shared_repulsion",), "TSNE": K2_K3, "LargeVis": (),
                  "InfoTSNE": (), "PACMAP": (), "SNE": K2_K3}
DIGITS_TW_TOL = 1e-5
STEP_ATOL, STEP_RTOL = 1e-4, 1e-5

# kernels one call of the general K3 launches: its pair loop and its merge
GENERAL_K3_KERNELS = 2
H100_FP32_FLOPS = 67e12  # float32 outside the tensor cores (data sheet)
H100_BYTES_PER_S = 3.35e12
# special-function unit (reciprocal, exp2): 16 results per clock per SM, 132
# SMs at the 1.98 GHz boost clock
H100_SFU_PER_S = 16 * 132 * 1.98e9


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int = 50) -> float:
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, calls: int = 10, reps: int = 10) -> float:
    """Device time of one call of ``fn``, replayed from a CUDA graph of
    ``calls`` calls: no host time between the launches."""
    import torch

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_time_ms(graph.replay, reps) / calls


def sass_report(libraries) -> None:
    """For each built library: the registers and stack of its d = 2 and d = 3
    kernels (d = 8 for the gathers, the microbenchmark's width; ``cuobjdump
    -res-usage``), and each innermost loop (a backward branch with no loop
    inside) of its d = 2 kernels (d = 8 for the gathers) with its
    instruction count by opcode (``cuobjdump -sass``), and over its tensor-core
    products (``HMMA``) where it has any. A loop's instructions over the
    pairs (or products) one iteration makes are the issue slots each costs."""
    import collections
    import re

    def shown(mangled, widths):
        if "bucket" in mangled:
            widths = ("ILi8E",)
        return any(w in mangled for w in widths)

    def label(mangled):
        m = re.search(r"\d\d((?:rowlse|repulsion|bucket)\w*?kernel)ILi(\d)E(?:Lb([01])E)?"
                      r"(?:Lb([01])E)?", mangled)
        if m is None:
            return mangled
        modes = {"rep": ("", ", masked"), "row": (", student", ", gaussian"),
                 "buc": (", k-steps walked", ", one k-step")}[m.group(1)[:3]]
        mode = "" if m.group(3) is None else modes[int(m.group(3))]
        # the general K2's sharing of the shard's own block
        shared = ", own block shared" if m.group(4) == "1" else ""
        return f"{m.group(1)}<d={m.group(2)}{mode}{shared}>"

    for lib in libraries:
        print(f"== {lib.name}")
        for flag in ("-res-usage", "-sass"):
            text = subprocess.run(["cuobjdump", flag, str(lib)], capture_output=True, text=True,
                                  check=True).stdout
            if flag == "-res-usage":
                for name, regs, stack in re.findall(
                        r"Function (\S+):\s*REG:(\d+) STACK:(\d+)", text):
                    if shown(name, ("ILi2E", "ILi3E")):
                        print(f"{label(name)}: {regs} registers, stack {stack}")
                continue
            for name, body in re.findall(r"Function : (\S+)(.*?)(?=Function : |\Z)", text, re.S):
                if not shown(name, ("ILi2E",)):
                    continue
                instrs = [(int(a, 16), re.sub(r"^@!?U?P\d+\s+", "", t))
                          for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", body)]
                loops = [(int(m.group(1), 16), a) for a, t in instrs if t.startswith("BRA")
                         for m in [re.search(r"0x([0-9a-f]+)", t)] if m and int(m.group(1), 16) <= a]
                for lo, hi in loops:
                    if any((a, b) != (lo, hi) and lo <= a and b <= hi for a, b in loops):
                        continue
                    ops = collections.Counter(
                        t.split()[0] if t.startswith("MUFU") else t.split()[0].split(".")[0]
                        for a, t in instrs if lo <= a <= hi)
                    total = sum(ops.values())
                    per_mma = f", {total / ops['HMMA']:.2f} per HMMA" if ops["HMMA"] else ""
                    print(f"{label(name)}: loop {lo:#x}-{hi:#x}, {total} "
                          f"instructions{per_mma} {dict(ops.most_common())}")


def k1_bound_ms(n: int, S: int, d: int) -> tuple:
    """Least time for K1's work on an H100: the larger of its bytes over
    memory rate (Z, w, ids read once; out written once) and its float32
    operations over the float32 rate, counting each of the 5d + 10
    operations per pair (exp, log and divide as one each) once."""
    bytes_moved = 4 * n * d + 4 * n + 8 * S + 4 * n * d
    ops = n * S * (5 * d + 10)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_sfu_floor_ms(n: int, S: int, calls_per_pair: float) -> float:
    """Least time of K1 as it is built: each of the n·S pairs with the
    special-function results (lg2, ex2, reciprocal) the design takes per pair,
    at 16 per clock per SM. It lies above ``k1_bound_ms``, which counts each
    of them as one float32 operation."""
    return n * S * calls_per_pair / H100_SFU_PER_S * 1e3


def k1_inputs(torch, gen, n: int, S: int, d: int, neg=None):
    dev = torch.device("cuda")
    Z = (3.0 * torch.randn((n, d), generator=gen, device=dev)).contiguous()
    if neg is None:
        neg = torch.randint(0, n, (S,), generator=gen, device=dev)
    w = torch.randint(0, 600, (n,), generator=gen, device=dev).float() / S
    return Z, neg, w


def hold_k1(torch, label, Z, neg, w, a, b, eps=1e-3) -> tuple:
    """One K1 case against the float64 evaluation and the plain version, at
    the three limits stated beside ``TOL_K1``. Returns max |kernel - plain|
    and the time of the one plain call."""
    from torchdr_tpu_torch.ops.cuda.umap_kernel import (
        fused_shared_repulsion,
        shared_repulsion_plain,
    )

    got = fused_shared_repulsion(Z, neg, w, a, b, eps)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    plain = shared_repulsion_plain(Z, neg, w, a, b, eps)
    end.record()
    ref = shared_repulsion_plain(Z.double(), neg, w.double(), a, b, eps)
    torch.cuda.synchronize()
    e_plain = float((got - plain).abs().max())
    e_64 = float((got.double() - ref).abs().max())
    plain_64 = float((plain.double() - ref).abs().max())
    lim_64 = min(K1_HARD, 3.0 * max(plain_64, 2e-6))
    n, d = Z.shape
    print(
        f"K1 {label}: n={n} S={neg.shape[0]} d={d} eps={eps:g} max|kernel-plain|={e_plain:.3e} "
        f"(limit {TOL_K1:.1e}) max|kernel-float64|={e_64:.3e} (limit {lim_64:.1e}) "
        f"max|plain-float64|={plain_64:.3e}",
        flush=True,
    )
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K1 {label}: non-finite values")
    if not e_64 <= lim_64:
        raise AssertionError(f"K1 {label}: max |kernel - float64| {e_64} > {lim_64}")
    if not e_plain <= TOL_K1:
        raise AssertionError(f"K1 {label}: max |kernel - plain| {e_plain} > {TOL_K1}")
    return e_plain, start.elapsed_time(end)


def check_k1(torch, gen, a: float, b: float) -> dict:
    """K1 against the float64 evaluation and its plain version on the card,
    then its times (:func:`time_k1`). ``gen`` draws the cases that the
    script has always had, so the later phases see the inputs they always
    saw; the newer cases draw from a generator of their own."""
    dev = torch.device("cuda")
    gen_new = torch.Generator(device="cuda")
    gen_new.manual_seed(SEED + 1)
    worst = 0.0
    for label, n, collide in (
        ("main d=2", N, False), ("main d=3", N, False), ("ragged n", N - 37, False),
        ("self-collisions", N, True),
    ):
        d = 3 if label == "main d=3" else 2
        neg = torch.arange(S_MAIN, device=dev) if collide else None
        worst = max(worst, hold_k1(torch, label, *k1_inputs(torch, gen, n, S_MAIN, d, neg), a, b)[0])
    first = k1_inputs(torch, gen, *K1_SHAPES[0])

    # the sample of 2048 at small n, with its own rows in it
    Z, neg, w = k1_inputs(torch, gen_new, N_TSNE, 2048, 2)
    neg[::2] = torch.arange(1024, device=dev)
    worst = max(worst, hold_k1(torch, "S=2048, half self-collisions", Z, neg, w, a, b)[0])
    # two rows 1e-4 apart, one of them in the sample: |coef| ~ 2b/eps
    Z, neg, w = k1_inputs(torch, gen_new, N, S_MAIN, 2)
    Z[1] = Z[0] + 1e-4
    neg[0] = 0
    worst = max(worst, hold_k1(torch, "near-collision", Z, neg, w, a, b)[0])
    # eps = 0: coef is infinite at D = 0, so the kernel tests the ids
    Z, neg, w = k1_inputs(torch, gen_new, N, S_MAIN, 2, torch.arange(S_MAIN, device=dev))
    worst = max(worst, hold_k1(torch, "eps=0, self-collisions", Z, neg, w, a, b, eps=0.0)[0])
    # int32 ids, as the estimator's sampler may hand them
    Z, neg, w = k1_inputs(torch, gen_new, 5003, 301, 2)
    worst = max(worst, hold_k1(torch, "int32 ids, ragged S", Z, neg.int(), w, a, b)[0])
    return time_k1(torch, gen_new, a, b, first, worst)


def time_k1(torch, gen, a: float, b: float, first, worst: float) -> dict:
    """K1's times at ``K1_SHAPES``: the eager call, as the fit makes it, over
    many calls, and the device time of the call replayed from a CUDA graph
    (the host's time to enqueue a call is of the same order at the UMAP
    path's size); the plain version timed beside it (at n = 1,000,000 its
    one comparison call). The record is the first shape's, the UMAP path's."""
    from torchdr_tpu_torch.ops.cuda.umap_kernel import (
        fused_shared_repulsion,
        shared_repulsion_plain,
    )

    times, record = [], None
    for i, (n, S, d) in enumerate(K1_SHAPES):
        Z, neg, w = first if i == 0 else k1_inputs(torch, gen, n, S, d)
        err, plain_once = hold_k1(torch, f"timed shape {i}", Z, neg, w, a, b)
        large = n * S > 1 << 26
        fn = lambda: fused_shared_repulsion(Z, neg, w, a, b)  # noqa: E731
        ms = cuda_time_ms(fn, reps=20 if large else 200)
        device_ms = graph_ms(fn)
        plain_ms = plain_once if large else cuda_time_ms(
            lambda: shared_repulsion_plain(Z, neg, w, a, b), reps=10)
        bound_ms, bound_by = k1_bound_ms(n, S, d)
        floor_ms = k1_sfu_floor_ms(n, S, K1_SFU_CALLS)
        print(
            f"K1 time n={n} S={S} d={d}: kernel {ms:.4f} ms ({device_ms:.4f} ms replayed from a "
            f"CUDA graph), plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"special-function floor {floor_ms:.5f} ms ({K1_SFU_CALLS:g} per pair)",
            flush=True,
        )
        times.append({"kernel": "K1", "n": n, "S": S, "d": d, "ms": ms, "device_ms": device_ms,
                      "plain_ms": plain_ms, "bound_ms": bound_ms, "sfu_floor_ms": floor_ms,
                      "max_abs_err": err})
        if i == 0:
            record = {
                "name": "umap_shared_repulsion (K1)",
                "route": "cuda",
                "source": "torchdr_tpu_torch/ops/csrc/umap_repulsion.cu",
                "replaces": "torchdr_tpu/ops/pallas/umap_kernel.py:68",
                "launches": None,
                "max_abs_err": None,
                "ms": ms,
                "graph_ms": device_ms,  # the call replayed from a CUDA graph
                "plain_ms": plain_ms,
                "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": None,  # no single PyTorch call computes this function
            }
        worst = max(worst, err)
    record["max_abs_err"] = worst
    print("k1_times " + json.dumps(times), flush=True)
    return record


def rowlse_bound_ms(n: int, d: int, which: str, kernel: str) -> tuple:
    """Least time for K2's or K3's work on an H100: the larger of its bytes
    over memory rate (Z, and for K3 lse and g, read once; the output
    written once) and its float32 operations over the float32 rate. Both
    functions are symmetric in the pair, so each of the n(n - 1)/2
    unordered pairs is evaluated once. K2: 3d + 3 per pair (d differences,
    d squares, d - 1 adds, the kernel value in 2, the adds into rows i and
    j) and a log per row. K3: 6d + 4 per pair for student (d differences,
    2d - 1 for d², 3 for q², u_i + u_j, the coefficient, d products, 2d
    accumulations into rows i and j; gaussian one fewer) and d + 3 per row
    (u_i = -g_i e^(-lse_i), the factor 2). Each exp, log and divide counts
    as one operation."""
    pairs = n * (n - 1) // 2
    if which == "K2":
        bytes_moved = 4 * n * d + 4 * n
        ops = pairs * (3 * d + 3) + n
    else:
        bytes_moved = 4 * n * d + 8 * n + 4 * n * d
        ops = pairs * (6 * d + 4 - (1 if kernel == "gaussian" else 0)) + n * (d + 3)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def sfu_floor_ms(n: int, which: str, kernel: str) -> float:
    """Least time of K2 and K3 as they are built: each of the n² ordered
    pairs evaluated, with the special-function calls (reciprocal, exp2) the
    design makes per pair: one, but a half in K2's student mode (one
    reciprocal serves two columns) and two in K3's gaussian mode (one
    exp(-d² - lse) per weight). It lies above ``rowlse_bound_ms``, which
    counts unordered pairs at the float32 rate."""
    calls = {("K2", "student"): 0.5, ("K3", "gaussian"): 2.0}.get((which, kernel), 1.0)
    return n * n * calls / H100_SFU_PER_S * 1e3


def rowlse_general_bound_ms(m: int, n: int, d: int, which: str, kernel: str) -> tuple:
    """Least time for one shard's general K2 or K3 on an H100: m rows of
    the shard against n columns. A pair with both ends in the shard is
    symmetric and counted once, as in ``rowlse_bound_ms``; a pair (i, j)
    with j outside it feeds row i only (K2: 3d + 2 operations, one add) or
    is one-sided (K3: the weight of row i alone, 6d + 3, gaussian 6d + 2,
    accumulated into dZq_i and dZdb_j). Bytes: Zq and Zdb read once (K3
    also lse and g), the output written once (K3 both outputs)."""
    inner, cross = m * (m - 1) // 2, m * (n - m)
    if which == "K2":
        bytes_moved = 4 * (m * d + n * d + m)
        ops = inner * (3 * d + 3) + cross * (3 * d + 2) + m
    else:
        g = 1 if kernel == "gaussian" else 0
        bytes_moved = 4 * (m * d + n * d + 2 * m + m * d + n * d)
        ops = inner * (6 * d + 4 - g) + cross * (6 * d + 3 - g) + m * (d + 3)
    t_bytes = bytes_moved / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_FP32_FLOPS * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def shard_kwargs(fn) -> dict:
    """The keyword by which ``rowlse_fwd_general`` is told that a shard's
    rows are Z's own (as the row-sharded caller tells it), where the wrapper
    takes one: an older tree's does not, and runs here unchanged."""
    import inspect

    return {"shard_of_db": True} if "shard_of_db" in inspect.signature(fn).parameters else {}


def mesh_shards(torch, Z, world: int):
    """(offset, padded row chunk) of each shard, as the sharded row log-sum
    cuts Z: rows past n are zeros, which n_total masks."""
    n, d = Z.shape
    chunk = -(-n // world)
    Zp = torch.zeros((chunk * world, d), dtype=Z.dtype, device=Z.device)
    Zp[:n] = Z
    return [(r * chunk, Zp[r * chunk : (r + 1) * chunk]) for r in range(world)]


def check_general_k2_k3(torch, gen) -> dict:
    """The general K2 and K3 against their plain versions on the card, on
    every shard of MESH_CASES and of the underflowing gaussian grid; each
    output within TOL_K2 / TOL_K3 as the square kernels are held. K3 is
    called twice and must give the same bits, and where its wrapper counts
    the kernels a call launches (``kernel_launches``), it must read
    GENERAL_K3_KERNELS."""
    from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
        rowlse_bwd_general,
        rowlse_bwd_general_plain,
        rowlse_fwd_general,
        rowlse_fwd_general_plain,
    )

    dev = torch.device("cuda")
    worst = {"K2": 0.0, "K3": 0.0}
    g = torch.arange(64, device=dev, dtype=torch.float32) * 15.0
    grid = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
    grid = (grid + 0.01 * torch.rand(grid.shape, generator=gen, device=dev)).contiguous()
    cases = [(label, (5.0 * torch.randn((n, d), generator=gen, device=dev)).contiguous(), kernel)
             for label, n, d, kernel in MESH_CASES]
    cases.append(("underflowing gaussian", grid, "gaussian"))
    for label, Z, kernel in cases:
        n = Z.shape[0]
        for off, Zq in mesh_shards(torch, Z, MESH_WORLD):
            out = rowlse_fwd_general(Zq, Z, off, n, kernel, **shard_kwargs(rowlse_fwd_general))
            ref = rowlse_fwd_general_plain(Zq, Z, off, n, kernel)
            live = max(0, min(Zq.shape[0], n - off))
            lse = ref.clone()
            lse[live:] = 0.0
            g_q = (torch.rand((Zq.shape[0],), generator=gen, device=dev) / n).contiguous()
            g_q[live:] = 0.0
            kernels = getattr(rowlse_bwd_general, "kernel_launches", None)
            dZq, dZdb = rowlse_bwd_general(Zq, Z, off, n, lse, g_q, kernel)
            if kernels is not None:  # the wrapper counts the kernels a call launched
                kernels = rowlse_bwd_general.kernel_launches - kernels
            again = rowlse_bwd_general(Zq, Z, off, n, lse, g_q, kernel)
            rq, rdb = rowlse_bwd_general_plain(Zq, Z, off, n, lse, g_q, kernel)
            torch.cuda.synchronize()
            if not (torch.equal(again[0], dZq) and torch.equal(again[1], dZdb)):
                raise AssertionError(f"general K3 {label} at {off}: a second call differs")
            if kernels not in (None, GENERAL_K3_KERNELS):
                raise AssertionError(f"general K3 {label} at {off}: {kernels} kernels a call, "
                                     f"not {GENERAL_K3_KERNELS}")
            e2 = float((out[:live] - ref[:live]).abs().max())
            lim2 = TOL_K2 * max(1.0, float(ref[:live].abs().max()))
            e3 = max(float((dZq - rq).abs().max()), float((dZdb - rdb).abs().max()))
            lim3 = TOL_K3 * max(float(rq.abs().max()), float(rdb.abs().max()))
            masked = bool(torch.isneginf(out[live:]).all())
            finite = bool(torch.isfinite(out[:live]).all() and torch.isfinite(dZq).all()
                          and torch.isfinite(dZdb).all())
            print(
                f"general K2/K3 {label}: n={n} d={Z.shape[1]} {kernel} shard at {off} "
                f"({live} of {Zq.shape[0]} rows live) max|K2-plain|={e2:.3e} (limit {lim2:.1e}) "
                f"max|K3-plain|={e3:.3e} (limit {lim3:.1e}); K3 {kernels} kernels a call, "
                f"the same bits twice",
                flush=True,
            )
            if not (finite and masked):
                raise AssertionError(f"general K2/K3 {label} at {off}: non-finite or unmasked")
            if not e2 <= lim2:
                raise AssertionError(f"general K2 {label} at {off}: {e2} > {lim2}")
            if not e3 <= lim3:
                raise AssertionError(f"general K3 {label} at {off}: {e3} > {lim3}")
            worst["K2"] = max(worst["K2"], e2)
            worst["K3"] = max(worst["K3"], e3)
    return worst


def check_sharded_rowlse(torch, gen, mesh) -> None:
    """The sharded row log-sum on ``mesh`` against the square kernels: the
    values within TOL_K2 · max(1, |square|), the gradient of Σ sin(rowlse)
    within TOL_K3 · max |square gradient|."""
    from torchdr_tpu_torch.ops.reduce import (
        pairwise_logkernel_rowlse,
        pairwise_logkernel_rowlse_sharded,
    )

    for n in (N_TSNE, N_LARGE):
        for kernel in ("student", "gaussian"):
            Z = 5.0 * torch.randn((n, 2), generator=gen, device="cuda")
            Za, Zb = Z.clone().requires_grad_(True), Z.clone().requires_grad_(True)
            sq = pairwise_logkernel_rowlse(Za, kernel)
            sh = pairwise_logkernel_rowlse_sharded(Zb, mesh, kernel)
            torch.sin(sq).sum().backward()
            torch.sin(sh).sum().backward()
            sq, sh = sq.detach(), sh.detach()
            e = float((sh - sq).abs().max())
            lim = TOL_K2 * max(1.0, float(sq.abs().max()))
            eg = float((Zb.grad - Za.grad).abs().max())
            limg = TOL_K3 * float(Za.grad.abs().max())
            print(f"sharded rowlse n={n} {kernel} on {len(mesh)} shards: max|sharded-square|="
                  f"{e:.3e} (limit {lim:.1e}), gradient {eg:.3e} (limit {limg:.1e})", flush=True)
            if not (e <= lim and eg <= limg):
                raise AssertionError(f"sharded rowlse n={n} {kernel}: {e}, {eg}")


def time_general_k2_k3(torch, gen, mesh, worst) -> dict:
    """The general K2's and K3's times on one shard (the first, rows 0..m)
    at the mesh's (m, n): eager over many calls and replayed from a CUDA
    graph, with the plain version's time and the bound; then one step of the
    sharded row log-sum (forward and backward) on the mesh beside one step
    of the square one. Returns the ``general`` entries of K2 and K3."""
    from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
        rowlse_bwd_general,
        rowlse_bwd_general_plain,
        rowlse_fwd_general,
        rowlse_fwd_general_plain,
    )
    from torchdr_tpu_torch.ops.reduce import (
        pairwise_logkernel_rowlse,
        pairwise_logkernel_rowlse_sharded,
    )

    d, general, times = 2, {"K2": [], "K3": []}, []
    for n in (N_TSNE, N_LARGE):
        for kernel in ("student", "gaussian"):
            Z = (5.0 * torch.randn((n, d), generator=gen, device="cuda")).contiguous()
            m = n // MESH_WORLD
            Zq = Z[:m].contiguous()
            lse = rowlse_fwd_general_plain(Zq, Z, 0, n, kernel)
            g = (torch.rand((m,), generator=gen, device="cuda") / n).contiguous()
            for which, fn, plain in (
                ("K2", lambda: rowlse_fwd_general(Zq, Z, 0, n, kernel,
                                                  **shard_kwargs(rowlse_fwd_general)),
                 lambda: rowlse_fwd_general_plain(Zq, Z, 0, n, kernel)),
                ("K3", lambda: rowlse_bwd_general(Zq, Z, 0, n, lse, g, kernel),
                 lambda: rowlse_bwd_general_plain(Zq, Z, 0, n, lse, g, kernel)),
            ):
                ms = cuda_time_ms(fn, reps=100 if n == N_TSNE else 20)
                device_ms = graph_ms(fn)
                plain_ms = cuda_time_ms(plain, reps=3 if n == N_TSNE else 1)
                bound_ms, bound_by = rowlse_general_bound_ms(m, n, d, which, kernel)
                split = kernel_split_ms(torch, fn)
                print(f"general {which} time shard ({m} x {n}) d={d} {kernel}: kernel {ms:.4f} ms "
                      f"({device_ms:.4f} ms replayed), plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.5f} ms ({bound_by}); by kernel {json.dumps(split)}", flush=True)
                entry = {"kernel": which, "m": m, "n": n, "d": d, "mode": kernel, "ms": ms,
                         "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "by_kernel_ms": split}
                times.append(entry)
                general[which].append(entry)
            # one step of the repulsion: forward and backward, sharded and square
            Zg = Z.clone().requires_grad_(True)

            def step(fn):
                Zg.grad = None
                fn(Zg).sum().backward()

            sharded_ms = cuda_time_ms(
                lambda: step(lambda z: pairwise_logkernel_rowlse_sharded(z, mesh, kernel)),
                reps=20 if n == N_TSNE else 5)
            square_ms = cuda_time_ms(lambda: step(lambda z: pairwise_logkernel_rowlse(z, kernel)),
                                     reps=20 if n == N_TSNE else 5)
            print(f"rowlse step n={n} {kernel}: sharded on {len(mesh)} shards {sharded_ms:.4f} ms, "
                  f"square {square_ms:.4f} ms", flush=True)
            times.append({"step": "rowlse fwd+bwd", "n": n, "mode": kernel,
                          "sharded_ms": sharded_ms, "square_ms": square_ms})
    print("rowlse_general_times " + json.dumps(times), flush=True)
    return {which: {"shards": MESH_WORLD, "max_abs_err": worst[which], "times": entries}
            for which, entries in general.items()}


def kernel_split_ms(torch, fn, calls: int = 20) -> dict:
    """Device time of one call of ``fn`` by kernel (torch.profiler over
    ``calls`` calls after a warm-up): the pair loop and the merge of a row
    log-sum apart. Empty where the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    import re

    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
        if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            # the kernel's own name: the last identifier before its template
            # arguments or parameters ("void (anonymous namespace)::name<...>(...)")
            names = re.findall(r"(\w+)\s*[<(]", e.key.replace("(anonymous namespace)", ""))
            name = names[1] if names and names[0] == "void" and len(names) > 1 else (
                names[0] if names else e.key[:40])
            split[name] = split.get(name, 0.0) + us / 1e3 / calls
    return split


def sorted_rows(torch, P, idx):
    """A sparse affinity's rows with their entries in column order (padding
    last), so that two packings of the same rows compare slot by slot."""
    key = torch.where(idx >= 0, idx.long(), torch.iinfo(torch.int64).max)
    order = torch.argsort(key, dim=1, stable=True)
    return torch.gather(P, 1, order), torch.gather(idx.long(), 1, order)


def compare_affinities(torch, name, model_cls, X, mesh) -> dict:
    """The input affinity of ``model_cls(random_state=0)`` on X with and
    without the mesh: indices equal as sets per row, values within
    MESH_AFFINITY_TOL."""
    Xt = torch.from_numpy(X).cuda()
    aff = model_cls(random_state=0).affinity_in
    P1, I1 = aff(Xt)
    aff._set_fit_mesh(mesh)
    t0 = time.perf_counter()
    P2, I2 = aff(Xt)
    torch.cuda.synchronize()
    sharded_s = time.perf_counter() - t0
    (P1, I1), (P2, I2) = sorted_rows(torch, P1, I1), sorted_rows(torch, P2, I2)
    same_shape = P1.shape == P2.shape
    rows_differ = int((I1 != I2).any(dim=1).sum()) if same_shape else -1
    err = float((P1 - P2).abs().max()) if same_shape else float("inf")
    out = {"model": name, "width": [P1.shape[1], P2.shape[1]], "rows_with_other_indices":
           rows_differ, "max_abs_err": err, "sharded_affinity_s": sharded_s}
    print("mesh affinity " + json.dumps(out), flush=True)
    if rows_differ != 0 or not err <= MESH_AFFINITY_TOL:
        raise AssertionError(f"{name}: mesh affinity differs: {out}")
    return out


def run_mesh_path(torch, counters, X, labels, single=None) -> dict:
    """The multi-device phase on a MESH_WORLD-way mesh of the one card."""
    from torchdr_tpu_torch import SNE, TSNE, UMAP
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered
    from torchdr_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cuda:0"] * MESH_WORLD)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    worst = check_general_k2_k3(torch, gen)
    check_sharded_rowlse(torch, gen, mesh)
    general = time_general_k2_k3(torch, gen, mesh, worst)

    X10, labels10 = make_clustered(N_TSNE, D_IN, N_CLUSTERS, seed=SEED)
    general_counts = {"rowlse_fwd_general": MESH_WORLD, "rowlse_bwd_general": MESH_WORLD}
    compare_affinities(torch, "TSNE", TSNE, X10, mesh)
    tsne = run_fit(torch, TSNE(random_state=0, mesh=mesh), X10, labels10, counters,
                   expect=general_counts)
    sne = run_fit(torch, SNE(random_state=0, lr=N_TSNE / 12, mesh=mesh), X10, labels10,
                  counters, expect=general_counts)
    compare_affinities(torch, "UMAP", UMAP, X, mesh)
    umap = run_fit(torch, UMAP(random_state=0, mesh=mesh), X, labels, counters,
                   expect=("fused_shared_repulsion",))
    if single is None:  # the same fits without the mesh, as phase 4 runs them
        single = {
            "UMAP": run_fit(torch, UMAP(random_state=0), X, labels, counters,
                            expect=("fused_shared_repulsion",)),
            "TSNE": run_fit(torch, TSNE(random_state=0), X10, labels10, counters,
                            expect=("rowlse_fwd", "rowlse_bwd")),
            "SNE": run_fit(torch, SNE(random_state=0, lr=N_TSNE / 12), X10, labels10, counters,
                           expect=("rowlse_fwd", "rowlse_bwd")),
        }
    for fit in (tsne, sne, umap):
        base = single[fit["model"]]
        print(f"mesh fit {fit['model']}: wall {fit['wall_s']:.6f} s on {MESH_WORLD} shards of one "
              f"card, {base['wall_s']:.6f} s without a mesh; peak {fit['peak_mem_gb']:.6f} GB "
              f"({base['peak_mem_gb']:.6f}); phases {json.dumps(fit['phases_s'])} "
              f"({json.dumps(base['phases_s'])})", flush=True)
    if torch.cuda.device_count() > 1:
        cards = make_mesh()
        run_fit(torch, TSNE(random_state=0, mesh=cards), X10, labels10, counters,
                expect={"rowlse_fwd_general": len(cards), "rowlse_bwd_general": len(cards)})
    else:
        print("mesh of the real cards: skipped, one card visible", flush=True)
    general["K2"]["launches"] = tsne["launches"]["rowlse_fwd_general"]
    general["K3"]["launches"] = tsne["launches"]["rowlse_bwd_general"]
    return general


def run_rowlse_kernels(torch, gen) -> None:
    """The row log-sum kernels alone (``--rowlse``): the square K2 and K3
    checked and timed as in phase 3, then the general ones checked on every
    shard, the sharded row log-sum against the square kernels and the
    general times, as in phase 9. Runs with the wrappers of an older tree
    too, so that two trees compare in one call."""
    from torchdr_tpu_torch.parallel import make_mesh

    check_k2_k3(torch, gen)
    mesh = make_mesh(devices=["cuda:0"] * MESH_WORLD)
    mesh_gen = torch.Generator(device="cuda")
    mesh_gen.manual_seed(SEED + 1)
    worst = check_general_k2_k3(torch, mesh_gen)
    check_sharded_rowlse(torch, mesh_gen, mesh)
    time_general_k2_k3(torch, mesh_gen, mesh, worst)


def hold_k2_k3(torch, label, Z, kernel) -> tuple:
    """One K2/K3 case against the plain versions, K2 within TOL_K2 and K3
    within TOL_K3; K3's weights are the softmax of the row log-sums
    (student) or uniform (gaussian). Returns the two max |kernel - plain|."""
    from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
        rowlse_bwd,
        rowlse_bwd_plain,
        rowlse_fwd,
        rowlse_fwd_plain,
    )

    n, d = Z.shape
    out = rowlse_fwd(Z, kernel)
    ref = rowlse_fwd_plain(Z, kernel)
    g = torch.softmax(ref, 0) if kernel == "student" else torch.full_like(ref, 1.0 / n)
    dZ = rowlse_bwd(Z, ref, g, kernel)
    dZ_ref = rowlse_bwd_plain(Z, ref, g, kernel)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(out).all() and torch.isfinite(dZ).all())
    e2 = float((out - ref).abs().max())
    lim2 = TOL_K2 * max(1.0, float(ref.abs().max()))
    e3 = float((dZ - dZ_ref).abs().max())
    lim3 = TOL_K3 * float(dZ_ref.abs().max())
    print(
        f"K2/K3 {label}: n={n} d={d} {kernel} max|K2-plain|={e2:.3e} (limit {lim2:.1e}) "
        f"max|K3-plain|={e3:.3e} (limit {lim3:.1e}, max|plain| "
        f"{float(dZ_ref.abs().max()):.3e}) lse in [{float(ref.min()):.4g}, "
        f"{float(ref.max()):.4g}]",
        flush=True,
    )
    if not (finite and bool(torch.isfinite(ref).all())):
        raise AssertionError(f"K2/K3 {label}: non-finite values")
    if not e2 <= lim2:
        raise AssertionError(f"K2 {label}: max abs err {e2} > {lim2}")
    if not e3 <= lim3:
        raise AssertionError(f"K3 {label}: max abs err {e3} > {lim3}")
    return e2, e3


def check_k2_k3(torch, gen) -> tuple:
    """K2 and K3 against their plain versions on the card, then their
    times (:func:`time_k2_k3`)."""
    dev = torch.device("cuda")
    worst = {"K2": 0.0, "K3": 0.0}

    def spread_grid(n_side, spacing):
        # points on a grid: the nearest neighbour is `spacing` away, so
        # exp(-d^2) underflows in float32 for every pair of every row
        g = torch.arange(n_side, device=dev, dtype=torch.float32) * spacing
        Z = torch.stack(torch.meshgrid(g, g, indexing="ij"), -1).reshape(-1, 2)
        return (Z + 0.01 * torch.rand(Z.shape, generator=gen, device=dev)).contiguous()

    cases = [
        ("main d=2", N_TSNE, 2, "student", None),
        ("main d=2 gaussian", N_TSNE, 2, "gaussian", None),
        ("d=3", N_TSNE, 3, "student", None),
        ("ragged n", 9_973, 2, "student", None),
        ("small n", 300, 2, "gaussian", None),
        ("underflowing gaussian", 64 * 64, 2, "gaussian", 15.0),
    ]
    for label, n, d, kernel, spacing in cases:
        if spacing is None:
            Z = (5.0 * torch.randn((n, d), generator=gen, device=dev)).contiguous()
        else:
            Z = spread_grid(64, spacing)
        e2, e3 = hold_k2_k3(torch, label, Z, kernel)
        worst["K2"] = max(worst["K2"], e2)
        worst["K3"] = max(worst["K3"], e3)

    return time_k2_k3(torch, gen, worst)


def time_k2_k3(torch, gen, worst) -> tuple:
    """K2's and K3's times at d = 2 in both modes: at the t-SNE path's size
    (n = 10,000; the plain versions timed beside them) and at n = 50,000,
    where the device and not the host would bound a step (kernels timed;
    each compared with its plain version once, that one call timed). A
    kernel's time is that of the eager call, as the fit makes it, over many
    calls; at n = 10,000 the host's time to enqueue a call is of the same
    order, so the device time of the call replayed from a CUDA graph stands
    beside it. The two records are the student mode's at n = 10,000."""
    from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
        rowlse_bwd,
        rowlse_bwd_plain,
        rowlse_fwd,
        rowlse_fwd_plain,
    )

    dev = torch.device("cuda")
    d = 2
    sources = {
        "K2": ("torchdr_tpu_torch/ops/csrc/rowlse_fwd.cu", 105, "rowlse_fwd (K2)"),
        "K3": ("torchdr_tpu_torch/ops/csrc/rowlse_bwd.cu", 230, "rowlse_bwd (K3)"),
    }
    records, times = [], []
    for n in (N_TSNE, N_LARGE):
        for kernel in ("student", "gaussian"):
            Z = (5.0 * torch.randn((n, d), generator=gen, device=dev)).contiguous()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            lse = rowlse_fwd_plain(Z, kernel)
            end.record()
            torch.cuda.synchronize()
            once = {"K2": start.elapsed_time(end)}
            g = torch.softmax(lse, 0) if kernel == "student" else torch.full_like(lse, 1.0 / n)
            start.record()
            dZ_ref = rowlse_bwd_plain(Z, lse, g, kernel)
            end.record()
            torch.cuda.synchronize()
            once["K3"] = start.elapsed_time(end)
            e2 = float((rowlse_fwd(Z, kernel) - lse).abs().max())
            e3 = float((rowlse_bwd(Z, lse, g, kernel) - dZ_ref).abs().max())
            lim2 = TOL_K2 * max(1.0, float(lse.abs().max()))
            lim3 = TOL_K3 * float(dZ_ref.abs().max())
            if not e2 <= lim2:
                raise AssertionError(f"K2 n={n} {kernel}: max abs err {e2} > {lim2}")
            if not e3 <= lim3:
                raise AssertionError(f"K3 n={n} {kernel}: max abs err {e3} > {lim3}")
            del dZ_ref
            for which, fn, plain, err, lim in (
                ("K2", lambda: rowlse_fwd(Z, kernel), lambda: rowlse_fwd_plain(Z, kernel), e2, lim2),
                ("K3", lambda: rowlse_bwd(Z, lse, g, kernel),
                 lambda: rowlse_bwd_plain(Z, lse, g, kernel), e3, lim3),
            ):
                ms = cuda_time_ms(fn, reps=100 if n == N_TSNE else 20)
                device_ms = graph_ms(fn)
                # the plain version: repeated at the path's size, the one
                # comparison call at the large size
                plain_ms = cuda_time_ms(plain, reps=5) if n == N_TSNE else once[which]
                bound_ms, bound_by = rowlse_bound_ms(n, d, which, kernel)
                floor_ms = sfu_floor_ms(n, which, kernel)
                print(
                    f"{which} time n={n} d={d} {kernel}: kernel {ms:.4f} ms ({device_ms:.4f} ms "
                    f"replayed from a CUDA graph), plain {plain_ms:.4f} ms, "
                    f"bound {bound_ms:.5f} ms ({bound_by}), special-function floor of ordered "
                    f"pairs {floor_ms:.5f} ms, max|kernel-plain|={err:.3e} (limit {lim:.1e})",
                    flush=True,
                )
                times.append({"kernel": which, "n": n, "d": d, "mode": kernel, "ms": ms,
                              "device_ms": device_ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "sfu_floor_ms": floor_ms, "max_abs_err": err})
                if n == N_TSNE and kernel == "student":
                    src, line, name = sources[which]
                    records.append({
                        "name": name,
                        "route": "cuda",
                        "source": src,
                        "replaces": f"torchdr_tpu/ops/pallas/reduce_kernel.py:{line}",
                        "launches": None,
                        "max_abs_err": max(worst[which], err),
                        "ms": ms,
                        "graph_ms": device_ms,  # the call replayed from a CUDA graph
                        "plain_ms": plain_ms,
                        "bound_ms": bound_ms,
                        "bound_by": bound_by,
                        "library_ms": None,  # no single PyTorch call computes this function
                    })
    print("rowlse_times " + json.dumps(times), flush=True)
    return tuple(records)


def gather_kernels():
    """(variant, wrapper, plain version, line of the TPU kernel in
    benchmarks/_gather_microbench.py) of G1-G3."""
    from torchdr_tpu_torch.ops.cuda.gather_kernel import (
        bucket_2level,
        bucket_2level_plain,
        bucket_onehot,
        bucket_onehot_plain,
        bucket_take,
        bucket_take_plain,
    )

    return (("take", bucket_take, bucket_take_plain, 75),
            ("onehot", bucket_onehot, bucket_onehot_plain, 99),
            ("2level", bucket_2level, bucket_2level_plain, 132))


def hold_gather(torch, label, kernel, plain, Zb, idx, chunk=None) -> float:
    """A gather against its plain version, bit for bit (``torch.equal``),
    in chunks of ``chunk`` windows; returns max |kernel - plain| (0.0)."""
    got = kernel(Zb, idx)
    torch.cuda.synchronize()
    nb = Zb.shape[0]
    chunk = chunk or max(1, nb)
    err = 0.0
    for s in range(0, nb, chunk):
        want = plain(Zb[s : s + chunk], idx[s : s + chunk])
        part = got[s : s + chunk]
        if part.shape != want.shape or not bool(torch.isfinite(part).all()):
            raise AssertionError(f"{label}: shape {tuple(part.shape)} or non-finite values")
        err = max(err, float((part - want).abs().max()))
        if not torch.equal(part, want):
            raise AssertionError(f"{label}: max |kernel - plain| {err}, not bit for bit")
    return err


def gather_ids(torch, kind: str, nb: int, r: int, c: int, gen):
    """Window-local ids (nb, 8, c / 8) int32 of one of ``GATHER_ID_KINDS``,
    or uniform, for windows of r rows (r a multiple of 32); id k of window
    b is laid out at row-major position k, and row k of a tile is k % 16."""
    dev = gen.device
    if kind == "uniform":
        return torch.randint(0, r, (nb, 8, c // 8), generator=gen, device=dev, dtype=torch.int32)
    i = torch.arange(c, device=dev)[None, :] + 7 * torch.arange(nb, device=dev)[:, None]
    if kind == "one k-step":  # every id in window rows 0-15
        ids = i % 16
    elif kind == "every k-step":  # the 16 rows of a tile on 16 different k-steps
        ids = (16 * i + i % 16) % r
    elif kind == "k-step edges":
        edges = torch.tensor([0, 15, 16, 31, 32, r - 17, r - 16, r - 1], device=dev)
        ids = edges[i % 8]
    elif kind == "one member":  # a tile's 16 rows: member 5 of one group
        ids = (i // 16) % (r // 32) * 32 + 5
    elif kind == "every member":  # 16 members of one group a tile, all across the window
        ids = i % r
    else:
        raise ValueError(kind)
    return ids.to(torch.int32).reshape(nb, 8, c // 8).contiguous()


def gather_times(torch, kernels, Zb, idx) -> dict:
    """Each gather's eager time (CUDA events over 20 calls), its device time
    replayed from a CUDA graph, and the time of the one ``torch.gather``
    that computes its function (the microbenchmark's ``library_args``):
    ``GATHER_REPEATS`` repeats, the kernels and the three timings taken in
    turns. Returns {variant: {timing: [ms, ...]}}."""
    from torchdr_tpu_torch.benchmarks import gather_microbench as gm

    runs = {name: {"eager": [], "graph": [], "library": []} for name, *_ in kernels}
    library = {name: gm.library_args(name, Zb, idx) for name, *_ in kernels}
    for _ in range(GATHER_REPEATS):
        for name, kernel, _, _ in kernels:
            fn = lambda: kernel(Zb, idx)  # noqa: E731
            runs[name]["eager"].append(cuda_time_ms(fn, reps=20))
            runs[name]["graph"].append(graph_ms(fn, calls=5, reps=4))
            runs[name]["library"].append(
                cuda_time_ms(lambda: torch.gather(*library[name]), reps=20))  # noqa: B023
    return runs


def check_gather(torch) -> dict:
    """G1-G3 against their plain versions on the card, at the small cases of
    ``GATHER_CASES`` (ids at 0 and R - 1), at ``GATHER_EDGE_CASES`` and at
    the microbenchmark's full shape, then their times there
    (:func:`gather_times`: medians with their spread) and the plain
    version's. Returns {variant: times}."""
    from torchdr_tpu_torch.benchmarks import gather_microbench as gm

    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 2)
    kernels = gather_kernels()
    worst = {name: 0.0 for name, *_ in kernels}
    for d, r in GATHER_CASES:
        Zb, idx = gm.make_bucketed(gen, 128, d, r, 128, device=dev)
        idx[0, 0, 0], idx[0, 7, 15] = 0, r - 1
        for name, kernel, plain, _ in kernels:
            worst[name] = max(worst[name], hold_gather(torch, f"{name} D={d} R={r}", kernel,
                                                       plain, Zb, idx))
    print(f"gather small cases: {len(GATHER_CASES)} (D, R) x 3 kernels equal to plain", flush=True)
    for kind, d, r, c in GATHER_EDGE_CASES:
        Zb = torch.randn((16, r, d), generator=gen, device=dev)
        idx = gather_ids(torch, kind, 16, r, c, gen)
        for name, kernel, plain, _ in kernels:
            worst[name] = max(worst[name], hold_gather(
                torch, f"{name} {kind} D={d} R={r} c={c}", kernel, plain, Zb, idx))
    print(f"gather edge cases: {len(GATHER_EDGE_CASES)} x 3 kernels equal to plain", flush=True)

    Zb, idx = gm.make_bucketed(gen, gm.N * gm.W, device=dev)
    nb, r, d = Zb.shape
    c = idx.shape[1] * idx.shape[2]
    times = {}
    for name, kernel, plain, _ in kernels:
        err = hold_gather(torch, f"{name} full shape", kernel, plain, Zb, idx, GATHER_CHUNK)
        times[name] = {"plain_ms": cuda_time_ms(lambda: plain(Zb, idx), reps=3),  # noqa: B023
                       "max_abs_err": max(worst[name], err)}
    for name, runs in gather_times(torch, kernels, Zb, idx).items():
        t = times[name]
        for timing, ms in runs.items():
            t[f"{timing}_ms"] = float(np.median(ms))
            t[f"{timing}_spread_ms"] = [min(ms), max(ms)]
        gap = t["eager_ms"] - t["graph_ms"]
        noise = max(t["eager_spread_ms"][1] - t["eager_spread_ms"][0],
                    t["graph_spread_ms"][1] - t["graph_spread_ms"][0])
        print(f"gather {name} nb={nb} R={r} D={d} c={c}: kernel {t['eager_ms']:.4f} ms eager "
              f"[{t['eager_spread_ms'][0]:.4f}, {t['eager_spread_ms'][1]:.4f}], "
              f"{t['graph_ms']:.4f} ms replayed from a CUDA graph "
              f"[{t['graph_spread_ms'][0]:.4f}, {t['graph_spread_ms'][1]:.4f}] (medians of "
              f"{GATHER_REPEATS}; eager - graph {gap:+.4f} ms, "
              f"{'outside' if abs(gap) > noise else 'inside'} the spread {noise:.4f}), "
              f"library {t['library_ms']:.4f} ms [{t['library_spread_ms'][0]:.4f}, "
              f"{t['library_spread_ms'][1]:.4f}], plain {t['plain_ms']:.4f} ms, "
              f"max|kernel-plain|={t['max_abs_err']}", flush=True)
    print("gather_times " + json.dumps(times), flush=True)
    return times


def run_gather_path(torch, counters, times) -> list:
    """The attraction-gather microbenchmark at its full shape, with every
    launch counter set to 0 just before and read just after; fails unless
    each of G1-G3 launched and no other kernel did. Returns the kernel
    records of G1-G3."""
    from torchdr_tpu_torch.benchmarks import gather_microbench as gm

    torch.cuda.synchronize()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    results = gm.main(device="auto")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"gather path: {wall:.2f} s, launches {json.dumps(launches)}", flush=True)
    by_variant = {rec["variant"]: rec for rec in results}
    if sorted(by_variant) != sorted(gm.VARIANTS):
        raise AssertionError(f"gather path: variants {sorted(by_variant)}")
    for rec in results:
        if not all(rec[k] > 0 for k in ("ms", "ns_per_idx")):
            raise AssertionError(f"gather path: bad record {rec}")
    for fn_name, count in launches.items():
        if fn_name.startswith("bucket_") != (count > 0):
            raise AssertionError(f"gather path: {fn_name} launched {count} times")
    records = []
    for name, kernel, _, line in gather_kernels():
        rec, t = by_variant[name], times[name]
        records.append({
            "name": f"{kernel.__name__} (G{len(records) + 1})",
            "route": "cuda",
            "source": "torchdr_tpu_torch/ops/csrc/bucket_gather.cu",
            "replaces": f"benchmarks/_gather_microbench.py:{line}",
            "launches": launches[kernel.__name__],
            "max_abs_err": t["max_abs_err"],
            "ms": t["eager_ms"],  # median of GATHER_REPEATS, as the library call's
            "graph_ms": t["graph_ms"],  # median of GATHER_REPEATS, replayed from a graph
            "plain_ms": t["plain_ms"],
            "bound_ms": rec["bound_ms"],  # from the rows this run's ids touch
            "bound_by": rec["bound_by"],
            "library_ms": t["library_ms"],  # one torch.gather on the bucketed layout
        })
    return records


def run_ivf_path(torch, counters) -> dict:
    """Phase 6: the IVF index built and searched at 1.3M x 50 with the
    estimators' settings (k = 30, nprobe 16, ``rerank=False``) and a query
    block of one chunk, its recall held to the exact graph, then the UMAP
    fit on the IVF graph at that block."""
    from torchdr_tpu_torch import KnnConfig, UMAP
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered, recall
    from torchdr_tpu_torch.ops.distance import knn_graph
    from torchdr_tpu_torch.ops.ivf import _resolve_search_knobs, ivf_build, ivf_knn

    X, labels = make_clustered(N_IVF, D_IVF, N_CLUSTERS, IVF_DECAY, seed=SEED)
    Xt = torch.from_numpy(X).cuda()
    Xt -= Xt.mean(0, keepdim=True)  # as the affinity layer centres its input
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    index = ivf_build(Xt)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    block = index.chunk  # no query block straddles two cells
    search = dict(k=IVF_K, nprobe=IVF_NPROBE, index=index, rerank=False, block=block)
    ivf_knn(None, **search)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, I = ivf_knn(None, **search)
    torch.cuda.synchronize()
    search_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    nprobe, budget, m, merge, max_ch, _, _, nomination = _resolve_search_knobs(
        index, IVF_K, IVF_NPROBE, None, None, None, "xla", rerank=False)
    g = torch.Generator()
    g.manual_seed(SEED)
    rows = torch.randperm(N_IVF, generator=g)[:IVF_EVAL_ROWS].cuda()
    _, exact = knn_graph(Xt[rows], Xt, k=IVF_K + 1, exclude_diag=False)
    rec = float(recall(I[rows], exact[:, 1:]).mean())  # exact[:, 0] is the row itself
    ivf = {
        "n": N_IVF, "d": D_IVF, "build_s": build_s, "search_s": search_s, "peak_mem_gb": peak_gb,
        "nlist": int(index.centroids.shape[0]), "supers": int(index.super_centroids.shape[0]),
        "chunk": index.chunk, "block": block, "nprobe": nprobe, "budget": budget, "m": m,
        "merge": merge,
        "max_ch": max_ch, "nomination": nomination, "adjacency_P": int(index.cell_adj.shape[1]),
        "storage_gb": index.X_sorted.numel() * 4 / 1e9, "recall_at_30": rec,
        "recall_rows": IVF_EVAL_ROWS,
    }
    print("ivf " + json.dumps(ivf), flush=True)
    if not rec >= IVF_RECALL_MIN:
        raise AssertionError(f"IVF: recall@{IVF_K} {rec} < {IVF_RECALL_MIN}")
    del Xt, index, I, exact
    torch.cuda.empty_cache()
    knn = KnnConfig(mode="ivf", precision="high", ivf_block=block)  # the IVF preset at `block`
    ivf["fit"] = run_fit(torch, UMAP(random_state=0, knn_mode=knn, device="auto"), X, labels,
                         counters, expect=("fused_shared_repulsion",))
    return ivf


def exact_neighbours(torch, X, rows, k: int):
    """The exact k nearest rows of X[rows] in X, each row's own id left out."""
    from torchdr_tpu_torch.ops.distance import knn_graph

    _, idx = knn_graph(X[rows], X, k=k + 1, exclude_diag=False)
    own = (idx == rows[:, None].to(idx.dtype)).to(torch.int8)
    return torch.gather(idx, 1, torch.argsort(own, dim=1, stable=True))[:, :k]


def index_gb(index) -> float:
    """Bytes the index keeps on the card, in GB."""
    return sum(v.numel() * v.element_size() for v in index if hasattr(v, "element_size")) / 1e9


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_tiers_path(torch, counters, smi: str) -> dict:
    """Phase 11: the kNN layer's storage tiers and batch-streamed builds.

    (a) the bf16 residual split that ``storage="auto"`` takes at
    N_TIERS x D_TIERS, (b) int8 with symmetric and asymmetric scoring,
    (c) supers nomination beside flat and adjacency, (d) each tier's card
    search against its CPU search, (e) ``knn_graph_streaming`` from the
    native loader in two segments, (f) the exact tier over 64 batches of
    bench.py's data, (g) PQ with and without refinement, (h) UMAP on the
    1.3M x 50 rows of phase 6 with an int8 graph, and (i) the sharded int8
    search on a 4-way mesh of the card. Every record carries the card's
    name and power limit; any gate missed raises."""
    import shutil
    import tempfile

    from torchdr_tpu_torch import KnnConfig, UMAP
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered, recall
    from torchdr_tpu_torch.benchmarks.ivf_search_profile import make_tiers_data
    from torchdr_tpu_torch.ops.ivf import (
        _resolve_search_knobs, auto_nlist, index_from_numpy, ivf_build, ivf_knn,
    )
    from torchdr_tpu_torch.ops.pq import pq_knn
    from torchdr_tpu_torch.ops.streaming import knn_graph_from_batches, knn_graph_streaming
    from torchdr_tpu_torch.parallel.ivf import ivf_knn_sharded
    from torchdr_tpu_torch.parallel.mesh import make_mesh
    from torchdr_tpu_torch.utils.native_loader import NpyBatchLoader

    out = {"card": smi}
    t_phase = time.perf_counter()

    def report(tag, rec):
        rec["card"] = smi
        print(f"tiers {tag} " + json.dumps(rec), flush=True)
        out[tag] = rec

    def gate(ok, what):
        if not ok:
            raise AssertionError(f"kNN tiers: {what}")

    X, data_s = timed(torch, lambda: make_tiers_data(N_TIERS, D_TIERS, TIERS_CENTERS, SEED,
                                                     seg=TIERS_SEG))
    g = torch.Generator()
    g.manual_seed(SEED)
    rows = torch.randperm(N_TIERS, generator=g)[:TIERS_EVAL_ROWS].cuda()
    truth, truth_s = timed(torch, lambda: exact_neighbours(torch, X, rows, TIERS_K))
    f32_gb = X.numel() * 4 / 1e9
    report("data", {"n": N_TIERS, "d": D_TIERS, "centers": TIERS_CENTERS, "make_s": data_s,
                    "truth_s": truth_s, "eval_rows": TIERS_EVAL_ROWS, "x_gb": f32_gb})
    search = dict(k=TIERS_K, nprobe=TIERS_NPROBE, budget=TIERS_BUDGET)

    def search_rec(index, **kw):
        (_, I), secs = timed(torch, lambda: ivf_knn(kw.pop("X", None), index=index, **search,
                                                     **kw))
        return {"search_s": secs, f"recall_at_{TIERS_K}": float(recall(I[rows], truth).mean())}

    def knobs(index, **kw):
        nprobe, budget, m, merge, max_ch, _, n_supers, nomination = _resolve_search_knobs(
            index, TIERS_K, TIERS_NPROBE, None, TIERS_BUDGET, None, "xla", **kw)
        supers = index.super_centroids
        return {"nlist": int(index.centroids.shape[0]),
                "supers": 0 if supers is None else int(supers.shape[0]),
                "chunk": index.chunk, "nprobe": nprobe, "budget": budget, "m": m, "merge": merge,
                "max_ch": max_ch, "n_supers": n_supers, "nomination": nomination,
                "layout_rows": int(index.X_sorted.shape[0])}

    # (a) the split, which storage="auto" takes past split_bytes
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 1e9
    index, build_s = timed(torch, lambda: ivf_build(X))
    gate(index.X_lo is not None and index.X_sorted.dtype == torch.bfloat16,
         "storage='auto' did not take the split at 10M x 128")
    build_peak = torch.cuda.max_memory_allocated() / 1e9 - base
    rec = {"storage": "auto -> split", "build_s": build_s, "build_peak_gb_above_x": build_peak,
           "resident_gb": index_gb(index), "f32_rows_gb": index.X_sorted.numel() * 4 / 1e9,
           **knobs(index)}
    torch.cuda.reset_peak_memory_stats()
    rec.update(search_rec(index))
    rec["search_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    rec.update({f"hi_{k}": v for k, v in search_rec(index, scan_fidelity="hi").items()})
    report("split", rec)
    gate(rec[f"recall_at_{TIERS_K}"] >= SPLIT_RECALL_MIN,
         f"split recall@{TIERS_K} {rec[f'recall_at_{TIERS_K}']} < {SPLIT_RECALL_MIN}")
    del index
    torch.cuda.empty_cache()

    # (b) int8, symmetric and asymmetric; (c) supers, flat and adjacency on it
    torch.cuda.reset_peak_memory_stats()
    index, build_s = timed(torch, lambda: ivf_build(X, storage="int8"))
    rec = {"build_s": build_s, "build_peak_gb_above_x": torch.cuda.max_memory_allocated() / 1e9
           - base, "resident_gb": index_gb(index), **knobs(index)}
    rec["resident_share_of_f32"] = rec["resident_gb"] / (index.X_sorted.numel() * 4 / 1e9)
    for scoring in ("symmetric", "asymmetric"):
        kw = {"X": X} if scoring == "asymmetric" else {}
        rec[scoring] = search_rec(index, scoring=scoring, **kw)
        gate(rec[scoring][f"recall_at_{TIERS_K}"] >= INT8_RECALL_MIN,
             f"int8 {scoring} recall {rec[scoring][f'recall_at_{TIERS_K}']} < {INT8_RECALL_MIN}")
    report("int8", rec)
    sup = {"adjacency": dict(rec["symmetric"], **knobs(index)),
           "flat": search_rec(index, nomination="flat"),
           "supers": dict(search_rec(index, nprobe_supers=TIERS_SUPERS),
                          **knobs(index, nprobe_supers=TIERS_SUPERS))}
    report("supers", sup)
    del index
    torch.cuda.empty_cache()

    # (d) each tier on the card against the same index searched on the CPU
    Xs = X[:TIERS_CPU_ROWS]
    nl = auto_nlist(TIERS_CPU_ROWS)
    cpu = {}
    for tier, build_kw, search_kw in (
        ("split", dict(storage="split"), {}),
        ("int8", dict(storage="int8"), {}),
        ("int8 supers", dict(storage="int8", n_superlist=max(32, nl // 16)),
         dict(nprobe_supers=TIERS_SUPERS)),
    ):
        idx = ivf_build(Xs, **build_kw)
        kw = dict(k=TIERS_K, nprobe=TIERS_NPROBE, **search_kw)
        dg, ig = ivf_knn(None, index=idx, **kw)
        dc, ic = ivf_knn(None, index=index_from_numpy(idx, "cpu"), **kw)
        same = ig.cpu() == ic
        rel = ((dg.cpu() - dc).abs() / dc.abs().clamp(min=1.0))[same]
        cpu[tier] = {"id_agreement": float(same.float().mean()),
                     "max_rel_dist_gap": float(rel.max()), "nlist": nl,
                     "n_supers": _resolve_search_knobs(idx, TIERS_K, TIERS_NPROBE, None, None,
                                                       None, "xla", **search_kw)[6]}
        gate(cpu[tier]["id_agreement"] >= CPU_AGREE_MIN,
             f"{tier}: card and CPU ids agree on {cpu[tier]['id_agreement']}")
        gate(cpu[tier]["max_rel_dist_gap"] <= CPU_DIST_RTOL,
             f"{tier}: card and CPU distances {cpu[tier]['max_rel_dist_gap']} apart")
    report("card_vs_cpu", cpu)

    # (e) streaming from a .npy through the native loader, two segments
    tmp = tempfile.mkdtemp(prefix="tiers_")
    try:
        path = os.path.join(tmp, "x.npy")
        free_gb = shutil.disk_usage(tmp).free / 1e9
        need_gb = STREAM_ROWS * D_TIERS * 4 / 1e9
        gate(free_gb > need_gb + 1, f"{free_gb:.1f} GB free for a {need_gb:.1f} GB file")

        def write():
            mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                           shape=(STREAM_ROWS, D_TIERS))
            for a in range(0, STREAM_ROWS, TIERS_SEG):
                mm[a : a + TIERS_SEG] = X[a : min(STREAM_ROWS, a + TIERS_SEG)].cpu().numpy()
            mm.flush()
            del mm

        _, write_s = timed(torch, write)
        probe = NpyBatchLoader(path, STREAM_BATCH)
        backend = probe.backend
        probe.close()
        gate(backend == "native", f"the loader's backend is {backend}")
        n_batches = -(-STREAM_ROWS // STREAM_BATCH)
        seg_bytes = -(-n_batches // 2) * STREAM_BATCH * D_TIERS * 4
        timings = {}
        (_, I), stream_s = timed(torch, lambda: knn_graph_streaming(
            lambda: NpyBatchLoader(path, STREAM_BATCH), k=TIERS_K, nprobe=TIERS_NPROBE,
            seg_bytes=seg_bytes, timings=timings))
        in_file = rows[rows < STREAM_ROWS]
        t_stream = truth if STREAM_ROWS == N_TIERS else exact_neighbours(
            torch, X[:STREAM_ROWS], in_file, TIERS_K)
        rec = {"rows": STREAM_ROWS, "batch_rows": STREAM_BATCH, "segments": 2,
               "seg_bytes": seg_bytes, "backend": backend, "write_s": write_s,
               "total_s": stream_s, **timings, "eval_rows": int(in_file.numel()),
               f"recall_at_{TIERS_K}": float(recall(torch.from_numpy(I)[in_file.cpu()],
                                                     t_stream.cpu()).mean())}
        report("streaming", rec)
        gate(rec[f"recall_at_{TIERS_K}"] >= STREAM_RECALL_MIN,
             f"streaming recall {rec[f'recall_at_{TIERS_K}']} < {STREAM_RECALL_MIN}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del X, truth
    torch.cuda.empty_cache()

    # (f) the exact tier over 64 batches of bench.py's data; (g) PQ on its
    # first N_PQ rows
    B = make_tiers_data(N_BENCH, D_TIERS, BENCH_CENTERS, SEED + 1, seg=TIERS_SEG)
    step = -(-N_BENCH // EXACT_BATCHES)
    batches = [B[a : a + step].cpu() for a in range(0, N_BENCH, step)]
    (_, I), exact_s = timed(torch, lambda: knn_graph_from_batches(batches, k=TIERS_K))
    brows = torch.randperm(N_BENCH, generator=g)[:TIERS_EVAL_ROWS].cuda()
    want = exact_neighbours(torch, B, brows, TIERS_K)
    same_sets = torch.equal(torch.sort(I[brows].long(), 1).values,
                            torch.sort(want.long(), 1).values)
    report("exact_batches", {"n": N_BENCH, "batches": len(batches), "search_s": exact_s,
                             "ids_equal_as_sets": same_sets, "eval_rows": TIERS_EVAL_ROWS})
    gate(same_sets, "the exact tier over batches differs from knn_graph")
    P = B[:N_PQ].contiguous()
    prow = torch.randperm(N_PQ, generator=g)[:TIERS_EVAL_ROWS].cuda()
    pwant = exact_neighbours(torch, P, prow, TIERS_K)
    (_, Ia), adc_s = timed(torch, lambda: pq_knn(P, k=TIERS_K, M=PQ_M))
    (_, Ir), ref_s = timed(torch, lambda: pq_knn(P, k=TIERS_K, M=PQ_M, refine_from=P))
    rec = {"n": N_PQ, "M": PQ_M, "adc_s": adc_s, "refined_s": ref_s,
           "adc_recall": float(recall(Ia[prow], pwant).mean()),
           "refined_recall": float(recall(Ir[prow], pwant).mean())}
    report("pq", rec)
    gate(rec["refined_recall"] >= rec["adc_recall"] + PQ_GAIN,
         f"PQ refined recall {rec['refined_recall']} not {PQ_GAIN} above ADC's {rec['adc_recall']}")
    del B, batches, P
    torch.cuda.empty_cache()

    # (h) UMAP on an int8 graph of phase 6's rows; (i) the sharded int8 search
    Xn, labels = make_clustered(N_IVF, D_IVF, N_CLUSTERS, IVF_DECAY, seed=SEED)
    Xt = torch.from_numpy(Xn).cuda()
    Xt -= Xt.mean(0, keepdim=True)  # as the affinity layer centres its input
    irows = torch.randperm(N_IVF, generator=g)[:IVF_EVAL_ROWS].cuda()
    iwant = exact_neighbours(torch, Xt, irows, IVF_K)
    graphs = {}
    for storage in ("f32", "int8"):
        idx = ivf_build(Xt, storage=storage)
        _, I = ivf_knn(None, index=idx, k=IVF_K, nprobe=IVF_NPROBE, rerank=False, block=idx.chunk)
        graphs[storage] = {"recall_at_30": float(recall(I[irows], iwant).mean()),
                           "resident_gb": index_gb(idx)}
    block = idx.chunk
    M4 = make_mesh(devices=["cuda:0"] * MESH_WORLD)
    kw = dict(index=idx, k=IVF_K, nprobe=IVF_NPROBE, rerank=False, block=block)
    _, I1 = ivf_knn(None, **kw)
    (_, I4), sharded_s = timed(torch, lambda: ivf_knn_sharded(None, M4, **kw))
    agree = float((torch.sort(I1.long(), 1).values == torch.sort(I4.long(), 1).values)
                  .all(1).float().mean())
    report("sharded_int8", {"world": MESH_WORLD, "n": N_IVF, "search_s": sharded_s,
                            "rows_equal_as_sets": agree})
    gate(agree >= SHARDED_AGREE_MIN, f"sharded int8 ids equal on {agree} of the rows")
    del idx, Xt, I, I1, I4
    torch.cuda.empty_cache()
    knn = KnnConfig(mode="ivf", precision="high", ivf_block=block, storage="int8")
    fit = run_fit(torch, UMAP(random_state=0, knn_mode=knn, device="auto"), Xn, labels,
                  counters, expect=("fused_shared_repulsion",))
    fit["graphs"] = graphs
    report("umap_int8", fit)
    out["k1_launches"] = fit["launches"]["fused_shared_repulsion"]
    print(f"tiers phase {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    return out


def run_ne_path(torch, counters, X, labels) -> list:
    """Phase 5: LargeVis, InfoTSNE and PACMAP on the 60,000 x 784 rows of
    phase 4, and TSNEkhorn on 10,000 x 784 from the same generator, each at
    its defaults but INFOTSNE_LR and TSNEKHORN_MIN_GRAD_NORM, as in phase 4;
    none has a kernel, so every launch counter must read 0."""
    from torchdr_tpu_torch import PACMAP, InfoTSNE, LargeVis, TSNEkhorn
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered

    fits = [run_fit(torch, model, X, labels, counters, expect=()) for model in (
        LargeVis(random_state=0, device="auto"),
        InfoTSNE(random_state=0, lr=INFOTSNE_LR, device="auto"),
        PACMAP(random_state=0, device="auto"),
    )]
    X10, labels10 = make_clustered(N_TSNE, D_IN, N_CLUSTERS, seed=SEED)
    fits.append(run_fit(torch, TSNEkhorn(random_state=0, min_grad_norm=TSNEKHORN_MIN_GRAD_NORM,
                                         device="auto"),
                        X10, labels10, counters, expect=()))
    return fits


def new_rows(n: int, seed: int):
    """n rows around the cluster centres of ``make_clustered(..., seed=SEED)``
    (its first draw), their labels and noise drawn from ``seed``: rows of the
    same clusters that no fit has seen."""
    centers = np.random.default_rng(SEED).normal(scale=4.0, size=(N_CLUSTERS, D_IN))
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, N_CLUSTERS, n)
    X = centers.astype(np.float32)[labels] + rng.standard_normal((n, D_IN), dtype=np.float32)
    return X, labels


def knn_transfer_accuracy(torch, Z_ref, y_ref, Z, y, k: int = 10, chunk: int = 2000) -> float:
    """Share of the rows of Z whose k nearest rows of Z_ref carry their label
    as the majority."""
    hits = 0
    for s in range(0, Z.shape[0], chunk):
        nn = torch.topk(torch.cdist(Z[s:s + chunk], Z_ref), k, dim=1, largest=False).indices
        votes = torch.nn.functional.one_hot(y_ref[nn], int(y_ref.max()) + 1).sum(1)
        hits += int((votes.argmax(1) == y[s:s + chunk]).sum())
    return hits / Z.shape[0]


def hyperbolic_knn_accuracy(torch, Z, labels, n_sub: int = 10_000, k: int = 10) -> float:
    """``knn_label_accuracy`` with neighbours by the Poincaré ball's distance
    (arccosh is increasing, so its argument ranks them)."""
    idx = subsample(torch, Z.shape[0], Z.device, n_sub, 0)
    Zs, ys = Z[idx].double(), labels[idx]
    sq = torch.cdist(Zs, Zs) ** 2
    w = 1.0 - torch.sum(Zs * Zs, dim=1)
    D = sq / (w[:, None] * w[None, :])
    D.fill_diagonal_(float("inf"))
    nn = torch.topk(D, k, dim=1, largest=False).indices
    votes = torch.nn.functional.one_hot(ys[nn], int(labels.max()) + 1).sum(1)
    return float((votes.argmax(1) == ys).float().mean())


def time_cosne_step_parts(torch, model) -> dict:
    """One forward-plus-backward of COSNE's O(n^2) row log-sum (its
    repulsion), and one RiemannianAdam update, on the fitted embedding;
    the row log-sum's peak memory above what was allocated before it."""
    import math

    from torchdr_tpu_torch.ops.reduce import pairwise_logkernel_rowlse_autodiff
    from torchdr_tpu_torch.utils.optim import make_optimizer

    Z = model.embedding_.detach().clone()
    gamma = float(model.gamma)

    def rowlse(Zr):
        return pairwise_logkernel_rowlse_autodiff(
            Zr, lambda D: math.log(gamma) - torch.log(D + gamma**2), metric="sqhyperbolic",
            exclude_diag=True, block_size=model.block_size)

    def fwd():
        with torch.no_grad():
            torch.logsumexp(rowlse(Z), 0)

    def fwd_bwd():
        Zr = Z.requires_grad_(True)
        torch.autograd.grad(torch.logsumexp(rowlse(Zr), 0), Zr)
        Z.requires_grad_(False)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    opt = make_optimizer("RiemannianAdam")
    state = opt.init(Z)
    g = torch.randn_like(Z) * 1e-3
    return {
        "rowlse_fwd_ms": cuda_time_ms(fwd, reps=10),
        "rowlse_fwd_bwd_ms": cuda_time_ms(fwd_bwd, reps=10),
        "rowlse_peak_mem_gb": peak / 1e9,
        "dense_n2_gb": Z.shape[0] ** 2 * 4 / 1e9,
        "radam_update_ms": cuda_time_ms(lambda: opt.update(g, state, Z, 1.0, {}), reps=20),
    }


def ms_per_step(model) -> float:
    return model.timings_["optimize"] / max(model.n_iter_, 1) * 1e3


def run_engine_path(torch, counters, X, labels, single=None) -> dict:
    """Phase 10: COSNE on the 10,000 rows at its defaults; parametric UMAP
    on the 60,000 rows and parametric t-SNE on the 10,000 (the MLP encoder
    at ENCODER_HIDDEN, Adam at ENCODER_LR); UMAP with the bands edge
    schedule on the 60,000 rows; each beside phase 4's fit of the same
    estimator (run here when ``single`` is None). The fitted parametric
    UMAP is returned under "parametric UMAP model"."""
    from torchdr_tpu_torch import COSNE, TSNE, UMAP
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered

    X10, labels10 = make_clustered(N_TSNE, D_IN, N_CLUSTERS, seed=SEED)
    if single is None:
        single = {
            "UMAP": run_fit(torch, UMAP(random_state=0, device="auto"), X, labels, counters,
                            expect=("fused_shared_repulsion",)),
            "TSNE": run_fit(torch, TSNE(random_state=0, device="auto"), X10, labels10,
                            counters, expect=("rowlse_fwd", "rowlse_bwd")),
        }
    out = {}

    for tag, params, min_acc in (("COSNE", {}, COSNE_DEFAULT_MIN_ACC),
                                 ("COSNE h0", {"learning_rate_for_h_loss": 0.0}, 0.9)):
        cosne = COSNE(random_state=0, device="auto", **params)
        fit = run_fit(torch, cosne, X10, labels10, counters, expect=(), min_acc=min_acc)
        max_norm = float(torch.linalg.vector_norm(cosne.embedding_, dim=1).max())
        fit.update(params=params, min_acc=min_acc, max_norm=max_norm,
                   ms_per_step=ms_per_step(cosne),
                   knn10_label_acc_hyperbolic=hyperbolic_knn_accuracy(
                       torch, cosne.embedding_, torch.from_numpy(labels10).cuda()))
        if not params:
            fit.update(time_cosne_step_parts(torch, cosne))
        print(f"engine {tag} " + json.dumps(fit), flush=True)
        if not max_norm < 1.0:
            raise AssertionError(f"{tag}: a point left the ball (max norm {max_norm})")
        out[tag] = fit

    def parametric(cls, data, y, expect):
        model = parametric_model(cls)
        fit = run_fit(torch, model, data, y, counters, expect=expect)
        Xt = torch.from_numpy(data).cuda()
        err = float((model.transform(Xt) - model.embedding_).abs().max())
        fit.update(ms_per_step=ms_per_step(model), transform_err=err,
                   n_weights=sum(v.numel() for v in model.encoder_variables_.values()))
        if not err <= TRANSFORM_TOL:
            raise AssertionError(f"parametric {cls.__name__}: transform of the training rows "
                                 f"is {err} from embedding_ (> {TRANSFORM_TOL})")
        return model, fit

    pumap, fit = parametric(UMAP, X, labels, ("fused_shared_repulsion",))
    Xn, yn = new_rows(N_NEW, SEED + 1)
    Xn = torch.from_numpy(Xn).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    Zn = pumap.transform(Xn)
    torch.cuda.synchronize()
    fit.update(new_rows=N_NEW, transform_new_ms=(time.perf_counter() - t0) * 1e3,
               new_rows_knn10_acc=knn_transfer_accuracy(
                   torch, pumap.embedding_, torch.from_numpy(labels).cuda(), Zn,
                   torch.from_numpy(yn).cuda()))
    print("engine parametric UMAP " + json.dumps(fit), flush=True)
    out["parametric UMAP"] = fit
    out["parametric UMAP model"] = pumap  # phase 12 saves and loads it

    _, fit = parametric(TSNE, X10, labels10, ("rowlse_fwd", "rowlse_bwd"))
    print("engine parametric TSNE " + json.dumps(fit), flush=True)
    out["parametric TSNE"] = fit

    bands = UMAP(random_state=0, device="auto", edge_schedule="bands")
    fit = run_fit(torch, bands, X, labels, counters, expect=("fused_shared_repulsion",))
    fit.update(ms_per_step=ms_per_step(bands), band_widths=list(bands.band_widths_))
    print("engine bands UMAP " + json.dumps(fit), flush=True)
    out["bands UMAP"] = fit

    for name, base in (("UMAP", "parametric UMAP"), ("UMAP", "bands UMAP"),
                       ("TSNE", "parametric TSNE")):
        ref = single[name]
        print(f"engine {base} beside {name}: wall {out[base]['wall_s']:.3f} s "
              f"({ref['wall_s']:.3f}), optimize {out[base]['phases_s']['optimize']:.3f} s "
              f"({ref['phases_s']['optimize']:.3f}), steps {out[base]['steps']} "
              f"({ref['steps']}), launches {json.dumps(out[base]['launches'])} "
              f"({json.dumps(ref['launches'])})", flush=True)
    return out


def median_sq_distance(torch, X, rows: int = 2000, seed: int = SEED, device="cuda") -> float:
    """Median squared distance between ``rows`` seeded rows of X."""
    g = torch.Generator()
    g.manual_seed(seed)
    rows = min(rows, X.shape[0])
    Xs = torch.from_numpy(X)[torch.randperm(X.shape[0], generator=g)[:rows]].to(device).double()
    D = torch.cdist(Xs, Xs) ** 2
    i, j = torch.triu_indices(rows, rows, 1, device=D.device)
    return float(torch.median(D[i, j]))


def svd_drivers(torch, A, k: int) -> dict:
    """cuSOLVER's SVD drivers on one IncrementalPCA update of A's shape (its
    first batch and the k + 1 rows an update adds): time (median of 5),
    orthonormality of the top k right singular vectors, singular values
    against float64. The port takes "gesvd" (ops/reductions.svd)."""
    A = torch.from_numpy(A - A.mean(0)).cuda()
    exact = torch.linalg.svdvals(A.double())
    rec = {"shape": list(A.shape)}
    for driver in ("gesvdj", "gesvd"):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, S, Vt = torch.linalg.svd(A, full_matrices=False, driver=driver)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        eye = torch.eye(k, device=A.device)
        rec[driver] = {
            "ms": float(np.median(times)) * 1e3,
            "orthonormality": float((Vt[:k] @ Vt[:k].T - eye).abs().max()),
            "sv_rel_err": float(((S.double() - exact) / exact[0]).abs().max()),
        }
    print("svd " + json.dumps(rec), flush=True)
    return rec


def run_spectral_path(torch, counters, X, labels) -> dict:
    """Phase 8: IncrementalPCA and ExactIncrementalPCA on the 60,000 x 784
    rows against PCA, KernelPCA's three solvers on 10,000 x 784 rows and its
    matrix-free LOBPCG on the 60,000, and PHATE on the 10,000 at its defaults,
    each with every launch counter read (none has a kernel: all must read 0)
    and the port's eval scores of its embedding."""
    from torchdr_tpu_torch import (
        PCA, PHATE, ExactIncrementalPCA, IncrementalPCA, KernelPCA,
        NormalizedGaussianAffinity, SelfTuningAffinity,
    )
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered
    from torchdr_tpu_torch.models.spectral.kernel_pca import _SHIFT

    def fit(model, data, y, min_acc=None):
        return run_fit(torch, model, data, y, counters, expect=(), min_acc=min_acc, scores=True)

    out = {"svd": svd_drivers(torch, X[: 5 * D_IN + IPCA_K + 1], IPCA_K)}
    # captured variance tr(V^T C V) of each model's components, against the
    # port's PCA at the same k, C the float64 covariance of the rows
    Xd = torch.from_numpy(X).cuda().double()
    Xd -= Xd.mean(0, keepdim=True)
    cov = Xd.T @ Xd / X.shape[0]
    del Xd
    for k in (IPCA_K, 2):
        pca = PCA(n_components=k, device="auto")
        pca.fit_transform(X)
        ref = float(torch.trace(pca.components_.double() @ cov @ pca.components_.double().T))
        models = [IncrementalPCA(n_components=k, device="auto")]
        if k == IPCA_K:
            models.append(ExactIncrementalPCA(n_components=k, device="auto"))
        for model in models:
            rec = fit(model, X, labels)
            V = model.components_.double()
            rec["captured_rel_to_pca"] = (float(torch.trace(V @ cov @ V.T)) - ref) / ref
            print(f"captured {type(model).__name__} k={k} " + json.dumps(rec), flush=True)
            out[f"{type(model).__name__}_k{k}"] = rec
            if k == IPCA_K and not abs(rec["captured_rel_to_pca"]) <= CAPTURED_TOL:
                raise AssertionError(f"{type(model).__name__}: captured variance "
                                     f"{rec['captured_rel_to_pca']} from PCA's")
    del cov

    # KernelPCA on 10,000 rows. The default sigma = 1 makes exp(-C) ~ I on
    # these rows (squared distances ~1,500 within a cluster, ~27,000
    # between), so the kernel is taken at the median squared distance
    X10, labels10 = make_clustered(N_TSNE, D_IN, N_CLUSTERS, seed=SEED)
    sigma10 = median_sq_distance(torch, X10)
    # SelfTuningAffinity on squared distances divides them by a product of
    # two squared distances (~2e6 here): its kernel is ~11^T - I, whose
    # centred top eigenvalue is 0, so its LOBPCG is reported, not gated
    runs = (
        ("gaussian", lambda: NormalizedGaussianAffinity(
            sigma=sigma10, normalization_dim=None, device="auto"), (KPCA_TOL, None)),
        ("self_tuning", lambda: SelfTuningAffinity(normalization_dim=None, device="auto"),
         (None,)),
    )
    for kind, aff, tols in runs:
        ref = KernelPCA(affinity=aff(), solver="eigh", device="auto")
        out[f"kpca_{kind}_eigh"] = fit(ref, X10, labels10)
        lam = ref.eigenvalues_[:2]
        for tol in tols:
            model = KernelPCA(affinity=aff(), solver="lobpcg", random_state=0, tol=tol,
                              device="auto")
            rec = fit(model, X10, labels10)
            gap = float(torch.max(torch.abs(model.eigenvalues_[:2] - lam)))
            rec.update({
                "lobpcg_iterations": model.lobpcg_iterations_,
                "eigenvalues": model.eigenvalues_.tolist(), "eigh_eigenvalues": lam.tolist(),
                "eig_gap_rel_to_lambda1": gap / abs(float(lam[0])),
            })
            print(f"kpca {kind} tol={tol} " + json.dumps(rec), flush=True)
            out[f"kpca_{kind}_lobpcg_tol{tol}"] = rec
            if kind == "gaussian" and tol is not None and not gap <= KPCA_EIG_TOL * float(lam[0]):
                raise AssertionError(f"KernelPCA {kind}: LOBPCG eigenvalues {gap} from eigh's")

    # the matrix-free LOBPCG on the 60,000 rows, and one more streamed
    # product for each pair's residual |HKHv - lambda v|
    sigma = median_sq_distance(torch, X)
    model = KernelPCA(affinity=NormalizedGaussianAffinity(sigma=sigma, normalization_dim=None,
                                                          device="auto"),
                      solver="lobpcg", random_state=0, tol=KPCA_TOL, device="auto")
    rec = fit(model, X, labels)
    matvec, _ = model._matfree_operator(torch.from_numpy(X).cuda(), model._kernel_block_fn())
    V, lam = model.eigenvectors_, model.eigenvalues_[:2]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    HKHV = matvec(V) - _SHIFT * V
    torch.cuda.synchronize()
    resid = torch.linalg.vector_norm(HKHV - V * lam[None, :], dim=0)
    it = model.lobpcg_iterations_
    bodies = min(200, -(-max(it, 1) // 8) * 8)  # the loop reads its stop flag every 8
    rec.update({
        "sigma": sigma, "lobpcg_iterations": it, "loop_bodies_run": bodies,
        "matvecs": 2 + 2 * bodies, "matvec_s": time.perf_counter() - t0,
        "eigenvalues": lam.tolist(), "residual_rel_to_lambda1": (resid / lam[0]).tolist(),
    })
    print("kpca matrix-free " + json.dumps(rec), flush=True)
    out["kpca_matfree_60k"] = rec
    if not float(resid.max()) <= KPCA_RESID_TOL * float(lam[0]):
        raise AssertionError(f"KernelPCA matrix-free: residuals {resid.tolist()} > "
                             f"{KPCA_RESID_TOL} lambda_1")
    del model, matvec, V, HKHV
    torch.cuda.empty_cache()

    out["phate"] = fit(PHATE(random_state=0, device="auto"), X10, labels10, min_acc=0.9)
    return out


def parametric_model(cls):
    """The engine phase's parametric estimator: the MLP encoder at
    ENCODER_HIDDEN, Adam at ENCODER_LR."""
    from torchdr_tpu_torch.utils.encoders import make_mlp_encoder

    return cls(random_state=0, device="auto", encoder=make_mlp_encoder(2, ENCODER_HIDDEN),
               optimizer="Adam", lr=ENCODER_LR)


def cli(*args, timeout: int = 600):
    """``python -m torchdr_tpu_torch.cli *args`` from the checkout's root;
    fails unless it exits 0. Its standard output."""
    out = subprocess.run([sys.executable, "-m", "torchdr_tpu_torch.cli", *args],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)}: exit {out.returncode}\n{out.stderr[-4000:]}")
    return out.stdout


def save_and_load(torch, model, fresh, path) -> dict:
    """``save_estimator`` of ``model`` to ``path``, then ``load_estimator``
    into ``fresh``: the seconds of each and the files' sizes."""
    from pathlib import Path

    from torchdr_tpu_torch.utils import load_estimator, save_estimator

    t0 = time.perf_counter()
    save_estimator(model, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    load_estimator(fresh, path)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    p = Path(path)
    sizes = {f.name: f.stat().st_size for f in sorted(p.parent.glob(p.name + ".*"))}
    return {"save_s": save_s, "load_s": load_s, "bytes": sizes}


def traced_fit(torch, model, X, counters, smi: str) -> dict:
    """One fit under ``utils.profiling.device_trace`` with every launch
    counter set to 0 just before; fails unless each kernel of
    TRACED_KERNELS appears in the written trace as many times as its
    wrapper counted calls (so the wrapper's kernels per call times its
    count in all), and its wrapper launched once a step or not at all."""
    import glob
    import tempfile

    from torchdr_tpu_torch.utils import device_trace

    for fn in counters:
        fn.launches = 0
    with tempfile.TemporaryDirectory(prefix="trace_") as logdir:
        t0 = time.perf_counter()
        with device_trace(logdir):
            model.fit_transform(X)
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        (path,) = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
        trace_mb = os.path.getsize(path) / 1e6
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    kernels = [e for e in events if str(e.get("cat", "")).lower() == "kernel"]
    name = type(model).__name__
    rec = {"model": name, "n": X.shape[0], "steps": model.n_iter_, "wall_s": wall,
           "trace_mb": trace_mb, "kernel_events": len(kernels), "kernels": {}}
    others = {k: v for k, v in launches.items() if k not in TRACED_KERNELS and v}
    if others:
        raise AssertionError(f"traced {name}: launches of {others}")
    for wrapper, globals_ in TRACED_KERNELS.items():
        calls = launches[wrapper]
        if calls not in (0, model.n_iter_):
            raise AssertionError(f"traced {name}: {wrapper} launched {calls} times in "
                                 f"{model.n_iter_} steps")
        seen = 0
        for kernel in globals_:
            evs = [e for e in kernels if kernel in e.get("name", "")]
            seen += len(evs)
            dev_ms = sum(float(e.get("dur", 0.0)) for e in evs) / 1e3
            rec["kernels"][kernel] = {"wrapper": wrapper, "launches": calls, "events": len(evs),
                                      "device_ms": dev_ms,
                                      "ms_per_launch": dev_ms / len(evs) if evs else None}
            print(f"api trace {name}: {kernel} {len(evs)} events, {calls} counted launches, "
                  f"device {dev_ms:.4f} ms ({smi})", flush=True)
            if len(evs) != calls:
                raise AssertionError(f"traced {name}: {len(evs)} {kernel} events, "
                                     f"{calls} counted launches of {wrapper}")
        if seen != calls * len(globals_):
            raise AssertionError(f"traced {name}: {seen} kernel events of {wrapper}, "
                                 f"{calls} calls x {len(globals_)} kernels")
    print("api trace " + json.dumps(rec), flush=True)
    return rec


def run_api_path(torch, counters, X, labels, smi: str, umap=None, pumap=None) -> dict:
    """Phase 12, the user API: (a) ``cli info`` names the card; (b) ``cli
    run`` of a script that fits the north-star UMAP on the 60,000 rows
    (K1 API_UMAP_STEPS times, accuracy at least API_MIN_ACC), and of one
    under ``--virtual-cpu-devices 2`` whose ``make_mesh()`` is two CPU
    devices; (c) checkpoints saved and loaded onto the card: phase 4's UMAP
    (``embedding_`` bit for bit), PCA with 50 components (``transform`` bit
    for bit) and phase 10's parametric UMAP (``transform`` of N_NEW new rows
    within PUMAP_LOAD_TOL); (d) t-SNE on the 10,000 rows and UMAP on the
    60,000 for TRACE_STEPS steps under ``device_trace``, each hand kernel's
    traced events equal to its wrapper's count; the four parts timed by
    ``PhaseTimer``. Phase 4's UMAP and phase 10's parametric UMAP are fitted
    here when not given."""
    import tempfile

    from torchdr_tpu_torch import PCA, TSNE, UMAP
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered
    from torchdr_tpu_torch.utils import PhaseTimer

    if umap is None:
        umap = UMAP(random_state=0, device="auto")
        run_fit(torch, umap, X, labels, counters, expect=("fused_shared_repulsion",))
    if pumap is None:
        pumap = parametric_model(UMAP)
        run_fit(torch, pumap, X, labels, counters, expect=("fused_shared_repulsion",))
    timer, out = PhaseTimer(), {}

    # (a) info
    kind = torch.cuda.get_device_name(0)
    with timer.phase("info"):
        info = cli("info")
    devices = [line for line in info.splitlines() if line.startswith("devices:")]
    print(f"api info: {info.strip()!r}", flush=True)
    if len(devices) != 1 or kind not in devices[0]:
        raise AssertionError(f"cli info names no {kind!r} on its devices line: {info!r}")

    with tempfile.TemporaryDirectory(prefix="api_") as tmp:
        # (b) the main path through the CLI, and a virtual CPU mesh
        umap_script, mesh_script = os.path.join(tmp, "umap.py"), os.path.join(tmp, "mesh.py")
        with open(umap_script, "w") as f:
            f.write(CLI_UMAP_SCRIPT)
        with open(mesh_script, "w") as f:
            f.write(CLI_MESH_SCRIPT)
        with timer.phase("cli run"):
            t0 = time.perf_counter()
            stdout = cli("run", umap_script, str(N), str(D_IN), str(N_CLUSTERS), str(SEED))
            run = json.loads(stdout.strip().splitlines()[-1])
            run["command_s"] = time.perf_counter() - t0
            mesh = cli("run", "--virtual-cpu-devices", "2", mesh_script)
        print("api cli run " + json.dumps(run), flush=True)
        if run["k1_launches"] != API_UMAP_STEPS or run["steps"] != API_UMAP_STEPS:
            raise AssertionError(f"cli run UMAP: {run['k1_launches']} K1 launches in "
                                 f"{run['steps']} steps, not {API_UMAP_STEPS}")
        if not run["knn10_label_acc"] >= API_MIN_ACC:
            raise AssertionError(f"cli run UMAP: accuracy {run['knn10_label_acc']} < {API_MIN_ACC}")
        if "MESH ['cpu', 'cpu']" not in mesh:
            raise AssertionError(f"cli run --virtual-cpu-devices 2: {mesh!r}")
        out["cli_run"] = run

        # (c) checkpoints onto the card
        with timer.phase("checkpoints"):
            fresh = UMAP(random_state=0, device="auto")
            rec = save_and_load(torch, umap, fresh, os.path.join(tmp, "umap_60k"))
            if fresh.embedding_.device.type != "cuda" or not torch.equal(
                    fresh.embedding_, umap.embedding_):
                raise AssertionError("loaded UMAP: embedding_ not on the card or not equal")
            out["umap_60k"] = rec

            pca = PCA(n_components=50, device="auto")
            pca.fit_transform(X)
            Zp = pca.transform(X)
            fresh = PCA(n_components=50, device="auto")
            rec = save_and_load(torch, pca, fresh, os.path.join(tmp, "pca_50"))
            if not np.array_equal(fresh.transform(X), Zp):
                raise AssertionError("loaded PCA: transform of the rows differs")
            out["pca_50"] = rec

            Xn = torch.from_numpy(new_rows(N_NEW, SEED + 1)[0]).cuda()
            Zn = pumap.transform(Xn)
            fresh = parametric_model(UMAP)
            rec = save_and_load(torch, pumap, fresh, os.path.join(tmp, "parametric_umap"))
            rec["transform_max_diff"] = float((fresh.transform(Xn) - Zn).abs().max())
            if not rec["transform_max_diff"] <= PUMAP_LOAD_TOL:
                raise AssertionError(f"loaded parametric UMAP: transform {rec} > {PUMAP_LOAD_TOL}")
            out["parametric_umap"] = rec
        for key in ("umap_60k", "pca_50", "parametric_umap"):
            print(f"api checkpoint {key} " + json.dumps(out[key]), flush=True)

    # (d) device traces of two short fits
    X10, _ = make_clustered(N_TSNE, D_IN, N_CLUSTERS, seed=SEED)
    with timer.phase("trace"):
        out["trace_tsne"] = traced_fit(
            torch, TSNE(random_state=0, max_iter=TRACE_STEPS, device="auto"), X10, counters, smi)
        out["trace_umap"] = traced_fit(
            torch, UMAP(random_state=0, max_iter=TRACE_STEPS, device="auto"), X, counters, smi)
    for name, wrappers in (("trace_tsne", ("rowlse_fwd", "rowlse_bwd")),
                           ("trace_umap", ("fused_shared_repulsion",))):
        for kernel in out[name]["kernels"].values():
            want = TRACE_STEPS if kernel["wrapper"] in wrappers else 0
            if kernel["launches"] != want:
                raise AssertionError(f"{name}: {kernel}")
    print(f"api phases: {timer.summary()} ({smi})", flush=True)
    out["phases_s"] = dict(timer.timings)
    return out


def example_numbers(out: dict) -> dict:
    """The numbers a gallery script returns: each fit's scalars (its
    embedding and labels left out), and the script's own scalars and
    dicts of numbers."""
    def scalars(d):
        return {k: float(v) for k, v in d.items()
                if isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)}

    nums = {name: scalars(fit) for name, fit in out.get("fits", {}).items()}
    nums.update(scalars(out))
    nums.update({k: v for k, v in out.items() if k != "fits" and isinstance(v, dict)})
    return nums


def run_examples_path(torch, counters) -> dict:
    """Phase 13: each gallery script on the card at its full default size,
    in-process through its ``main([])`` (which raises when one of its gates
    fails), every launch counter set to 0 just before and read just after:
    fails unless each kernel of ``EXAMPLE_KERNELS[script]`` launched and no
    other did. Then the runner once in a fresh process. One JSON line a
    script: its seconds, numbers and launches."""
    import importlib

    from torchdr_tpu_torch.examples.__main__ import find_examples, module_name

    scripts = [rel[: -len(".py")] for rel in find_examples()]
    if scripts != sorted(EXAMPLE_KERNELS):
        raise AssertionError(f"examples: scripts {scripts}")
    t_phase = time.perf_counter()
    lines = {}
    for script in scripts:
        mod = importlib.import_module(module_name(script + ".py"))
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        out = mod.main([])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in counters}
        line = {"example": script, "seconds": seconds, "numbers": example_numbers(out),
                "launches": launches}
        print("example " + json.dumps(line), flush=True)
        for name, count in launches.items():
            if (name in EXAMPLE_KERNELS[script]) != (count > 0):
                raise AssertionError(f"example {script}: {name} launched {count} times")
        for name, fit in out.get("fits", {}).items():
            if not np.all(np.isfinite(fit["embedding"])):
                raise AssertionError(f"example {script}: {name}'s embedding is not finite")
        lines[script] = line
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torchdr_tpu_torch.examples", "--match", EXAMPLE_RUNNER_MATCH],
        cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True, text=True,
        timeout=600)
    summary = proc.stdout.strip().splitlines()[-1:] or [""]
    print(f"examples runner --match {EXAMPLE_RUNNER_MATCH}: exit {proc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s; {proc.stdout.strip()}", flush=True)
    if proc.returncode != 0 or summary[0] != "[examples] 1/1 passed":
        raise AssertionError(f"examples runner: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    print(f"examples phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return lines


def check_float32_grams(torch, X) -> dict:
    """Phase 14 (a): ``knn_graph`` on the rows after the user's
    ``set_float32_matmul_precision("high")``: the ids of a call without it,
    distances within F1_DIST_RTOL, and the user's "high" back after the call.
    The same search outside the port's entry point (its undecorated body,
    where the user's TF32 applies) is reported beside it."""
    from torchdr_tpu_torch import knn_graph

    Xt = torch.from_numpy(X).cuda()
    caller = torch.get_float32_matmul_precision()
    d0, i0 = knn_graph(Xt, k=F1_K)
    torch.set_float32_matmul_precision("high")
    try:
        d1, i1 = knn_graph(Xt, k=F1_K)
        after = torch.get_float32_matmul_precision()
        d_tf32, i_tf32 = knn_graph.__wrapped__(Xt, k=F1_K)
    finally:
        torch.set_float32_matmul_precision(caller)
    torch.cuda.synchronize()
    rel = float(((d1 - d0).abs() / d0.abs().clamp_min(1e-30)).max())
    rec = {"rows": Xt.shape[0], "d": Xt.shape[1], "k": F1_K,
           "ids_equal": bool(torch.equal(i0, i1)), "max_rel_dist_diff": rel,
           "precision_after_call": after,
           "tf32_rows_with_other_ids": float((i_tf32 != i0).any(1).float().mean()),
           "tf32_max_rel_dist_diff": float(((d_tf32 - d0).abs() / d0.abs().clamp_min(1e-30)).max())}
    print("float32 grams " + json.dumps(rec), flush=True)
    if not rec["ids_equal"] or rel > F1_DIST_RTOL or after != "high":
        raise AssertionError(f"float32 grams: {rec}")
    return rec


def check_installed_build(torch) -> dict:
    """Phase 14 (b): the package without ``_build/`` (the files a wheel
    ships) copied into a read-only directory, imported by a fresh process
    whose HOME is a temporary directory, builds K1 there and launches it
    against its plain version: the library must land in
    ``~/.cache/torchdr_tpu_torch/build`` and nothing may be written inside
    the copy. Root writes through any file mode, so as root the process runs
    as the user ``NOBODY``."""
    import shutil
    import tempfile
    from pathlib import Path

    root = Path(os.path.dirname(os.path.abspath(__file__)))
    tmp = Path(tempfile.mkdtemp())
    site, home = tmp / "site", tmp / "home"
    try:
        shutil.copytree(root / "torchdr_tpu_torch", site / "torchdr_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        (home / "tmp").mkdir(parents=True)
        before = sorted(str(p.relative_to(site)) for p in site.rglob("*"))
        for p in [site, *site.rglob("*")]:
            p.chmod(0o555 if p.is_dir() else 0o444)
        run_as = {}
        if os.geteuid() == 0:
            tmp.chmod(0o755)
            for p in [home, *home.rglob("*")]:
                os.chown(p, NOBODY, NOBODY)
            run_as = {"user": NOBODY, "group": NOBODY, "extra_groups": []}
        env = dict(os.environ, HOME=str(home), TMPDIR=str(home / "tmp"), PYTHONPATH=str(site),
                   PYTHONDONTWRITEBYTECODE="1")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-c", F2_CHILD], cwd=str(home), env=env,
                              capture_output=True, text=True, timeout=600, **run_as)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"installed build: exit {proc.returncode}\n{proc.stderr[-4000:]}")
        child = json.loads(proc.stdout.strip().splitlines()[-1])
        cache = home / ".cache" / "torchdr_tpu_torch" / "build"
        libs = sorted(p.name for p in cache.glob("*.so")) if cache.is_dir() else []
        after = sorted(str(p.relative_to(site)) for p in site.rglob("*"))
        rec = {**child, "seconds": seconds, "uid": NOBODY if run_as else os.geteuid(),
               "cache_libraries": libs, "copy_unchanged": after == before,
               "files_in_copy": len(after)}
        print("installed build " + json.dumps(rec), flush=True)
        if not (child["package"] == str(site / "torchdr_tpu_torch")
                and child["build_dir"] == str(cache) and child["launches"] == 1
                and child["finite"] and child["max_abs_err"] <= TOL_K1
                and [n for n in libs if n.startswith("libumap_repulsion-")] and rec["copy_unchanged"]):
            raise AssertionError(f"installed build: {rec}")
        return rec
    finally:
        for p in [site, *site.rglob("*")] if site.exists() else []:
            p.chmod(0o755)
        shutil.rmtree(tmp, ignore_errors=True)


def run_bench_path(torch, counters, X) -> dict:
    """Phase 14: the float32 grams (a), the installed build (b), then the
    port's benchmarks at their defaults: the headline bench through the CLI
    in a fresh process (c), the kNN benchmark (d) and the single-cell UMAP
    benchmark plain and ``--distributed`` (e), each fit with every launch
    counter set to 0 just before and read just after."""
    from torchdr_tpu_torch.benchmarks import knn_benchmark, umap_single_cell

    t_phase = time.perf_counter()
    out = {"float32_grams": check_float32_grams(torch, X),
           "installed_build": check_installed_build(torch)}

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "torchdr_tpu_torch.cli", "bench"],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=900)
    print(f"cli bench: exit {proc.returncode} in {time.perf_counter() - t0:.1f} s; "
          f"{proc.stderr.strip().splitlines()[-1:]}", flush=True)
    if proc.returncode != 0:
        raise AssertionError(f"cli bench: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    bench = json.loads(proc.stdout.strip().splitlines()[-1])
    print("bench " + json.dumps(bench), flush=True)
    if not bench["recall"] >= BENCH_RECALL_MIN:
        raise AssertionError(f"bench: recall@15 {bench['recall']} < {BENCH_RECALL_MIN}")
    out["bench"] = bench

    knn = knn_benchmark.main([])
    out["knn_benchmark"] = {label: {"seconds": r["seconds"], "recall": r["recall"]}
                            for label, r in knn.items()}
    print("knn benchmark " + json.dumps(out["knn_benchmark"]), flush=True)
    low = {label: r["recall"] for label, r in knn.items() if not r["recall"] >= KNN_BENCH_RECALL_MIN}
    if low:
        raise AssertionError(f"knn benchmark: recall {low} < {KNN_BENCH_RECALL_MIN}")

    for label, argv in (("umap_single_cell", []), ("umap_single_cell --distributed",
                                                   ["--distributed"])):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for fn in counters:
            fn.launches = 0
        res = umap_single_cell.main(argv)
        launches = {fn.__name__: fn.launches for fn in counters}
        Zt = torch.from_numpy(res["embedding"]).cuda()
        acc = knn_label_accuracy(torch, Zt, torch.from_numpy(res["labels"]).cuda())
        rec = {"n": res["n"], "d": res["d"], "steps": res["iters"], "seconds": res["seconds"],
               "silhouette": res["silhouette"],
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": launches,
               "knn10_label_acc": acc}
        print(f"{label} " + json.dumps(rec), flush=True)
        want = {name: (res["iters"] if name == "fused_shared_repulsion" else 0) for name in launches}
        if launches != want or not np.all(np.isfinite(res["embedding"])):
            raise AssertionError(f"{label}: launches {launches} (want {want}) or a bad embedding")
        if acc < SINGLE_CELL_MIN_ACC:
            raise AssertionError(f"{label}: 10-NN label accuracy {acc} < {SINGLE_CELL_MIN_ACC}")
        out[label] = rec
    print(f"benchmarks phase {time.perf_counter() - t_phase:.1f} s", flush=True)
    return out


def run_digits_path(torch, counters, smi: str) -> dict:
    """Phase 17: ``real_digits.main`` on the card, every launch counter set
    to 0 just before each of its twelve fits and read just after; each fit's
    readings held to its gates and its launches to ``DIGITS_KERNELS``, and
    its trustworthiness on the card to the CPU's; before the fits, K1, K2 and
    K3 at the fits' shapes against their plain versions. Then
    ``profile_umap_step.main`` at its full shape, and each of its parts on the
    card against the CPU. Returns the launches by estimator and fit."""
    from contextlib import contextmanager

    from torchdr_tpu_torch import UMAP
    from torchdr_tpu_torch.benchmarks import profile_umap_step, real_digits
    from torchdr_tpu_torch.models.neighbor.umap import find_ab_params
    from torchdr_tpu_torch.utils.wrappers import full_float32

    t_phase = time.perf_counter()
    X, _ = real_digits.load_digits()
    X = X.astype(np.float32)
    n = X.shape[0]
    # the kernels at the fits' shapes: K1 on UMAP's shared sample, which at
    # this n holds more ids than there are rows; K2, K3 in t-SNE's and SNE's
    # modes
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 17)
    S = UMAP(device="cuda")._shared_negative_count(n)
    hold_k1(torch, f"digits S={S}", *k1_inputs(torch, gen, n, S, 2), *find_ab_params(1.0, 0.1))
    for kernel in ("student", "gaussian"):
        Z = (5.0 * torch.randn((n, 2), generator=gen, device="cuda")).contiguous()
        hold_k2_k3(torch, f"digits {kernel}", Z, kernel)

    watched = {}

    @contextmanager
    def watch(name, model):
        torch.cuda.synchronize()
        for fn in counters:
            fn.launches = 0
        yield
        torch.cuda.synchronize()
        watched.setdefault(name, []).append(
            {"steps": model.n_iter_, "launches": {fn.__name__: fn.launches for fn in counters}})

    res = real_digits.main([], watch=watch)
    failed = []
    for name, fit in res["fits"].items():
        card_tw = real_digits.trustworthiness(X, fit["embedding"], 15, device="cuda")
        cpu_tw = real_digits.trustworthiness(X, fit["embedding"], 15, device="cpu")
        rec = {"model": name, "steps": fit["steps"], "fits": watched[name],
               "gates": fit["gates"], "trustworthiness15_card": card_tw,
               "trustworthiness15_cpu": cpu_tw,
               **{k: fit[k] for k in ("cold_s", "warm_s", "silhouette", "trustworthiness15",
                                      "knn_acc10", "preservation15")}}
        print("digits " + json.dumps(rec), flush=True)
        if not np.all(np.isfinite(fit["embedding"])):
            failed.append(f"{name}: embedding not finite")
        for key, floor in fit["gates"].items():
            if not fit[key] >= floor:
                failed.append(f"{name}: {key} {fit[key]} < {floor}")
        if not abs(card_tw - cpu_tw) <= DIGITS_TW_TOL:
            failed.append(f"{name}: trustworthiness card {card_tw} cpu {cpu_tw}")
        if len(watched[name]) != 2:
            failed.append(f"{name}: {len(watched[name])} fits watched")
        for one in watched[name]:
            want = {fn: (one["steps"] if fn in DIGITS_KERNELS[name] else 0)
                    for fn in one["launches"]}
            if one["launches"] != want or (DIGITS_KERNELS[name] and one["steps"] == 0):
                failed.append(f"{name}: launches {one['launches']} in {one['steps']} steps")

    t0 = time.perf_counter()
    step = profile_umap_step.main([])
    print(f"step decomposition ({time.perf_counter() - t0:.1f} s): "
          + json.dumps(step["readings"]), flush=True)
    for label, out in step["outputs"].items():
        if not bool(torch.isfinite(out).all()):
            failed.append(f"step {label}: not finite")
    # each part once more, on the card and on the CPU, on the same Z, ids and
    # negatives
    Z, NN, P, _ = profile_umap_step.inputs(step["n"], step["width"], "cuda")
    neg = torch.randint(0, step["n"], (step["n"], step["n_neg"]), generator=gen, device="cuda")
    card = profile_umap_step.parts(Z, NN, P, None, neg)
    host = profile_umap_step.parts(Z.cpu(), NN.cpu(), P.cpu(), None, neg.cpu())
    errs = {}
    with full_float32():
        for (label, fn), (_, fn_cpu) in zip(card, host):
            got, want = fn().cpu(), fn_cpu()
            errs[label] = float((got - want).abs().max())
            if not (bool(torch.isfinite(got).all())
                    and bool(((got - want).abs() <= STEP_ATOL + STEP_RTOL * want.abs()).all())):
                failed.append(f"step {label}: card against CPU max abs err {errs[label]}")
    print(f"step parts, card against CPU (limit {STEP_ATOL:g} + {STEP_RTOL:g}|cpu|): "
          + json.dumps(errs), flush=True)
    print(f"digits phase {time.perf_counter() - t_phase:.1f} s ({smi})", flush=True)
    if failed:
        raise AssertionError("digits phase: " + "; ".join(failed))
    return {name: [one["launches"] for one in fits] for name, fits in watched.items()}


def run_fit(torch, model, X, labels, counters, expect, min_acc=0.9, scores=False) -> dict:
    """One fit on the card with every launch counter set to 0 just before
    and read just after; fails unless each kernel in ``expect`` launched
    once per step (or, where ``expect`` maps names to counts, that many
    times per step) and the others not at all, on a bad embedding, or below
    ``min_acc`` 10-NN label accuracy (None: no gate). ``scores`` adds the
    port's own eval scores of the embedding."""
    if not isinstance(expect, dict):
        expect = {name: 1 for name in expect}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters:
        fn.launches = 0
    t0 = time.perf_counter()
    Z = model.fit_transform(X)
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in counters}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    name = type(model).__name__
    if Z.shape != (X.shape[0], model.n_components) or not np.all(np.isfinite(Z)):
        raise AssertionError(f"{name}: embedding has shape {Z.shape} or non-finite values")
    for fn_name, count in launches.items():
        want = model.n_iter_ * expect[fn_name] if fn_name in expect else 0
        if count != want or (fn_name in expect and count == 0):
            raise AssertionError(f"{name}: {fn_name} launched {count} times in {model.n_iter_} steps")
    Zt = torch.from_numpy(Z).cuda()
    yt = torch.from_numpy(labels).cuda()
    acc = knn_label_accuracy(torch, Zt, yt)
    fit = {
        "model": name, "n": X.shape[0], "d": X.shape[1], "steps": getattr(model, "n_iter_", None),
        "wall_s": wall, "phases_s": getattr(model, "timings_", None), "peak_mem_gb": peak_gb,
        "launches": launches, "knn10_label_acc": acc,
    }
    if scores:
        fit.update(eval_scores(torch, Zt, yt))
    print("fit " + json.dumps(fit), flush=True)
    if min_acc is not None and acc < min_acc:
        raise AssertionError(f"{name}: 10-NN label accuracy {acc} < {min_acc}")
    return fit


def subsample(torch, n: int, device, n_sub: int = 10_000, seed: int = 0):
    """The rows that the accuracy is read on."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randperm(n, generator=g, device=device)[:n_sub]


def eval_scores(torch, Z, labels) -> dict:
    """The port's eval of an embedding: its mean 10-NN label agreement on
    the rows of ``knn_label_accuracy``, the silhouette of all rows and the
    ARI of 50-means."""
    from torchdr_tpu_torch.eval import kmeans_ari, knn_label_accuracy as eval_knn, silhouette_score

    idx = subsample(torch, Z.shape[0], Z.device)
    return {
        "eval_knn10_label_acc": eval_knn(Z[idx], labels[idx], k=10, device=Z.device),
        "silhouette": silhouette_score(Z, labels, device=Z.device),
        "kmeans_ari": kmeans_ari(Z, labels, random_state=0, device=Z.device)[0],
    }


def knn_label_accuracy(torch, Z, labels, n_sub: int = 10_000, k: int = 10, seed: int = 0):
    """10-NN majority-label accuracy of the embedding on a row subsample."""
    idx = subsample(torch, Z.shape[0], Z.device, n_sub, seed)
    Zs, ys = Z[idx], labels[idx]
    D = torch.cdist(Zs, Zs)
    D.fill_diagonal_(float("inf"))
    nn = torch.topk(D, k, dim=1, largest=False).indices
    votes = torch.nn.functional.one_hot(ys[nn], int(labels.max()) + 1).sum(1)
    return float((votes.argmax(1) == ys).float().mean())


def profile_optimize(torch, model_cls, X, steps: int = 200, top: int = 8,
                     device: str = "auto", **params) -> dict:
    """Device time by kernel over ``steps`` optimizer steps of a fit of
    ``model_cls(**params)`` on X (torch.profiler), and the device's busy
    share of that window's wall time. The affinity and init phases run
    first, outside the window."""
    from torch.profiler import ProfilerActivity, profile

    model = model_cls(random_state=0, max_iter=steps, device=device, **params)
    Xd = torch.from_numpy(X).to(model._resolve_device())
    model.n_samples_in_, model.n_features_in_ = Xd.shape
    model._generator_ = model._root_generator()
    model._compute_input_affinity(Xd)
    model.on_affinity_computation_end()
    Z0 = model._init_embedding(Xd)
    consts = model._build_consts(Xd)
    carry0 = model._init_carry(consts)
    model._optimize(Z0, consts, carry0)  # warm-up, outside the window
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        model._optimize(Z0, consts, carry0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def device_us(evt):
        return getattr(evt, "self_device_time_total", None) or getattr(
            evt, "self_cuda_time_total", 0.0
        )

    # device-side events only (kernels, copies): an aten op's own row
    # repeats the time of the kernels it launched
    kernels = [
        e for e in prof.key_averages()
        if str(getattr(e, "device_type", "")).endswith("CUDA") and device_us(e) > 0
    ]
    kernels.sort(key=device_us, reverse=True)
    busy_s = sum(device_us(e) for e in kernels) / 1e6
    # kernel names are cut to 60 characters; templates that share a prefix add up
    top_ms = {}
    for e in kernels[:top]:
        top_ms[e.key[:60]] = top_ms.get(e.key[:60], 0.0) + device_us(e) / 1e3 / steps
    return {
        "model": model_cls.__name__,
        "n": X.shape[0],
        "steps": steps,
        "wall_ms_per_step": wall / steps * 1e3,
        "device_busy_ms_per_step": busy_s / steps * 1e3,
        "device_idle_share": 1.0 - busy_s / wall,
        "top_kernels_ms_per_step": top_ms,
    }


def profile_engine(torch, X) -> None:
    """``profile_optimize`` over 100 steps of COSNE on the 10,000 rows and of
    the parametric UMAP on X."""
    from torchdr_tpu_torch import COSNE, UMAP
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered
    from torchdr_tpu_torch.utils.encoders import make_mlp_encoder

    X10, _ = make_clustered(N_TSNE, D_IN, N_CLUSTERS, seed=SEED)
    for model_cls, data, params in (
        (COSNE, X10, {}),
        (UMAP, X, {"encoder": make_mlp_encoder(2, ENCODER_HIDDEN), "optimizer": "Adam",
                   "lr": ENCODER_LR}),
    ):
        prof = profile_optimize(torch, model_cls, data, 100, **params)
        prof["encoder"] = "encoder" in params
        print("profile " + json.dumps(prof), flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run.", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torchdr_tpu_torch import SNE, TSNE, UMAP
    from torchdr_tpu_torch.models.neighbor.umap import find_ab_params
    from torchdr_tpu_torch.ops.cuda.build import build_libraries
    from torchdr_tpu_torch.ops.cuda.reduce_kernel import (
        rowlse_bwd,
        rowlse_bwd_general,
        rowlse_fwd,
        rowlse_fwd_general,
    )
    from torchdr_tpu_torch.ops.cuda.umap_kernel import fused_shared_repulsion

    counters = (fused_shared_repulsion, rowlse_fwd, rowlse_bwd, rowlse_fwd_general,
                rowlse_bwd_general, *(kernel for _, kernel, _, _ in gather_kernels()))

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {smi}", flush=True)
    print(
        f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}",
        flush=True,
    )

    # 2. build
    k1_only = "--k1" in sys.argv[1:]
    gather_only = "--gather" in sys.argv[1:]
    ivf_only = "--ivf" in sys.argv[1:]
    ne_only = "--ne" in sys.argv[1:]
    spectral_only = "--spectral" in sys.argv[1:]
    mesh_only = "--mesh" in sys.argv[1:]
    rowlse_only = "--rowlse" in sys.argv[1:]
    engine_only = "--engine" in sys.argv[1:]
    tiers_only = "--tiers" in sys.argv[1:]
    api_only = "--api" in sys.argv[1:]
    examples_only = "--examples" in sys.argv[1:]
    bench_only = "--bench" in sys.argv[1:]
    digits_only = "--digits" in sys.argv[1:]
    t0 = time.perf_counter()
    if ne_only or spectral_only:
        libs = []  # phases 5 and 8 launch no kernel
    elif rowlse_only:
        libs = build_libraries(["rowlse_fwd", "rowlse_bwd"])
    elif mesh_only or engine_only or api_only or examples_only or digits_only:
        libs = build_libraries(["umap_repulsion", "rowlse_fwd", "rowlse_bwd"])
    elif k1_only or gather_only or ivf_only or tiers_only or bench_only:
        libs = build_libraries(["bucket_gather"] if gather_only else ["umap_repulsion"])
    else:
        libs = build_libraries()
    print(f"build: {len(libs)} libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    if "--sass" in sys.argv[1:]:
        sass_report(libs)
    if gather_only:
        run_gather_path(torch, counters, check_gather(torch))
        print(smi, flush=True)
        return 0
    if ivf_only:
        run_ivf_path(torch, counters)
        print(smi, flush=True)
        return 0
    if tiers_only:
        run_tiers_path(torch, counters, smi)
        print(smi, flush=True)
        return 0
    if examples_only:
        run_examples_path(torch, counters)
        print(smi, flush=True)
        return 0
    if digits_only:
        run_digits_path(torch, counters, smi)
        print(smi, flush=True)
        return 0
    from torchdr_tpu_torch.benchmarks.ivf_recall import make_clustered

    X, labels = (None, None) if rowlse_only else make_clustered(N, D_IN, N_CLUSTERS, seed=SEED)
    if ne_only:
        run_ne_path(torch, counters, X, labels)
        print(smi, flush=True)
        return 0
    if bench_only:
        run_bench_path(torch, counters, X)
        print(smi, flush=True)
        return 0
    if spectral_only:
        run_spectral_path(torch, counters, X, labels)
        print(smi, flush=True)
        return 0
    if mesh_only:
        run_mesh_path(torch, counters, X, labels)
        print(smi, flush=True)
        return 0
    if engine_only:
        run_engine_path(torch, counters, X, labels)
        if "--profile" in sys.argv[1:]:
            profile_engine(torch, X)
        print(smi, flush=True)
        return 0
    if api_only:
        run_api_path(torch, counters, X, labels, smi)
        print(smi, flush=True)
        return 0

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    if rowlse_only:
        run_rowlse_kernels(torch, gen)
        print(smi, flush=True)
        return 0
    k1 = check_k1(torch, gen, *find_ab_params(1.0, 0.1))  # UMAP's defaults
    if k1_only:
        print(smi, flush=True)
        return 0
    k2, k3 = check_k2_k3(torch, gen)

    # 4. the paths: UMAP on 60k x 784, t-SNE and SNE on 10k x 784
    umap_model = UMAP(random_state=0, device="auto")
    umap = run_fit(torch, umap_model, X, labels, counters, expect=("fused_shared_repulsion",))
    k1["launches"] = umap["launches"]["fused_shared_repulsion"]
    X10, labels10 = make_clustered(N_TSNE, D_IN, N_CLUSTERS, seed=SEED)
    tsne = run_fit(torch, TSNE(random_state=0, device="auto"), X10, labels10, counters,
                   expect=("rowlse_fwd", "rowlse_bwd"))
    k2["launches"] = tsne["launches"]["rowlse_fwd"]
    k3["launches"] = tsne["launches"]["rowlse_bwd"]
    # SNE's lr="auto" (n/4 = 2,500) diverges on these data, in the JAX
    # package as in the port (|Z| ~1e16 after 30 steps): a hub point whose
    # column of P sums to ~14/n makes lr times the attraction's curvature
    # ~7.6, beyond heavy-ball stability (2(1 + 0.8) = 3.6); n/12 is under it
    sne = run_fit(torch, SNE(random_state=0, lr=N_TSNE / 12, device="auto"), X10, labels10,
                  counters, expect=("rowlse_fwd", "rowlse_bwd"))

    # 5. LargeVis, InfoTSNE and PACMAP on 60k x 784, TSNEkhorn on 10k x 784
    run_ne_path(torch, counters, X, labels)

    # 6. the IVF kNN tier and UMAP on its graph at 1.3M x 50
    run_ivf_path(torch, counters)

    # 7. the gathers and the attraction-gather microbenchmark
    gathers = run_gather_path(torch, counters, check_gather(torch))

    # 8. the spectral estimators: incremental PCAs, KernelPCA, PHATE
    run_spectral_path(torch, counters, X, labels)

    # 9. the multi-device path on a 4-way mesh of the card: the general K2
    # and K3, the sharded row log-sum, t-SNE, SNE and UMAP on the mesh
    general = run_mesh_path(torch, counters, X, labels,
                            single={"UMAP": umap, "TSNE": tsne, "SNE": sne})
    k2["general"], k3["general"] = general["K2"], general["K3"]

    # 10. the engine: COSNE, parametric UMAP and t-SNE, UMAP's bands schedule
    engine = run_engine_path(torch, counters, X, labels, single={"UMAP": umap, "TSNE": tsne})

    # 11. the kNN layer's storage tiers and batch-streamed builds at 10M x 128
    run_tiers_path(torch, counters, smi)

    # 12. the user API: the CLI, checkpoints of phase 4's UMAP and phase 10's
    # parametric UMAP loaded onto the card, device traces of two fits
    run_api_path(torch, counters, X, labels, smi, umap=umap_model,
                 pumap=engine["parametric UMAP model"])

    # 13. the examples gallery: every script at its full size, and the runner
    gallery = run_examples_path(torch, counters)
    for rec, name in ((k1, "fused_shared_repulsion"), (k2, "rowlse_fwd"), (k3, "rowlse_bwd")):
        rec["gallery_launches"] = {script: line["launches"][name]
                                   for script, line in gallery.items()
                                   if line["launches"][name]}

    # 14. the repaired float32 grams and installed build, and the port's
    # benchmarks: the headline bench, the kNN and single-cell UMAP benchmarks
    benches = run_bench_path(torch, counters, X)
    k1["bench_launches"] = {label: benches[label]["launches"]["fused_shared_repulsion"]
                            for label in ("umap_single_cell", "umap_single_cell --distributed")}

    if "--profile" in sys.argv[1:]:
        from torchdr_tpu_torch import PACMAP, InfoTSNE, LargeVis, TSNEkhorn

        for model_cls, data, steps, params in (
            (UMAP, X, 200, {}), (TSNE, X10, 200, {}), (LargeVis, X, 100, {}),
            (InfoTSNE, X, 100, {"lr": INFOTSNE_LR}), (PACMAP, X, 100, {}),
            (TSNEkhorn, X10, 100, {"min_grad_norm": TSNEKHORN_MIN_GRAD_NORM}),
        ):
            prof = profile_optimize(torch, model_cls, data, steps, **params)
            print("profile " + json.dumps(prof), flush=True)
        profile_engine(torch, X)

    # 17. real data: the digits record's six fits, and the UMAP step's parts
    digits = run_digits_path(torch, counters, smi)
    for rec, name in ((k1, "fused_shared_repulsion"), (k2, "rowlse_fwd"), (k3, "rowlse_bwd")):
        rec["digits_launches"] = {model: [fit[name] for fit in fits]
                                  for model, fits in digits.items()
                                  if any(fit[name] for fit in fits)}

    print(json.dumps({"kernels": [k1, k2, k3, *gathers]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
