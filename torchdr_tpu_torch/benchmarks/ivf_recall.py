"""Recall@k of the IVF tier against the exact graph, over families of
clustered data, on one card.

    python -m torchdr_tpu_torch.benchmarks.ivf_recall [--block B,...] [clusters:decay ...]

Each case makes ``N`` x ``D`` float32 rows (:func:`make_clustered`: Gaussian
clusters whose component j is scaled by (j + 1)^-decay; decay 0 is
isotropic), builds the index with every default (``ivf_build``), and for
each query block B (``--block``, default ``256,chunk``: the search's default
block and one chunk of the index) searches it with ``ivf_knn`` at k = 30,
nprobe 16, ``rerank=False`` (the estimators' settings), once with the
default nomination and once with flat nomination, and holds both to the
exact ``knn_graph`` on 2,000 rows. It prints one JSON line per case with
the resolved knobs, the build time and, per block, the search times and
the recall of the rows in the cell of their query block's first row
("home") and of the others. Adjacency nomination samples a self-query
block's home cells at rows ``j · chunk`` for j < max(1, B // chunk), as the
JAX package does (``ops/ivf.py``): with B < chunk, the "other" rows sit in
a block whose second cell is never sampled; with B = chunk there are none.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

N, D, K, NPROBE, N_EVAL = 1_300_000, 50, 30, 16, 2_000
CASES = ("50:0", "50:0.5", "50:1", "50:1.5", "50:2", "1000:0", "1000:1", "200:1")


def make_clustered(n: int, d: int = D, n_clusters: int = 50, decay: float = 0.0, seed: int = 0):
    """n x d float32 rows around Gaussian cluster centres (scale 4, unit
    noise), component j of each row then scaled by (j + 1)^-decay (an
    assumed spectrum, not one measured on real data); with ``labels``.
    ``chip_smoke.py`` makes every path's data with it."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=4.0, size=(n_clusters, d)).astype(np.float32)
    labels = rng.integers(0, n_clusters, n)
    X = centers[labels] + rng.standard_normal((n, d), dtype=np.float32)
    if decay:
        X *= (np.arange(1, d + 1, dtype=np.float32) ** -decay)[None, :]
    return X, labels


def recall(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Per row, the share of ``want``'s ids that ``got`` holds."""
    return (want[:, :, None].long() == got[:, None, :].long()).any(-1).float().mean(1)


def run_case(n_clusters: int, decay: float, device, blocks=(256, "chunk")) -> dict:
    from torchdr_tpu_torch.ops.distance import knn_graph
    from torchdr_tpu_torch.ops.ivf import _resolve_search_knobs, ivf_build, ivf_knn

    X, _ = make_clustered(N, D, n_clusters, decay)
    Xt = torch.from_numpy(X).to(device)
    Xt -= Xt.mean(0, keepdim=True)  # as the affinity layer centres its input
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = ivf_build(Xt)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    knobs = _resolve_search_knobs(index, K, NPROBE, None, None, None, "xla", rerank=False)
    g = torch.Generator()
    g.manual_seed(0)
    rows = torch.randperm(N, generator=g)[:N_EVAL].to(device)
    _, exact = knn_graph(Xt[rows], Xt, k=K + 1, exclude_diag=False)
    exact = exact[:, 1:]  # drop each row itself
    out = {"clusters": n_clusters, "decay": decay, "n": N, "d": D, "build_s": build_s,
           "nlist": int(index.centroids.shape[0]), "chunk": index.chunk,
           "budget": knobs[1], "m": knobs[2], "merge": knobs[3], "nomination": knobs[7],
           "max_cell": int(index.counts.max())}
    # the sorted position of each evaluated row
    ids = index.ids_sorted.long()
    pos = torch.empty(N, dtype=torch.long, device=device)
    live = ids >= 0
    pos[ids[live]] = torch.nonzero(live).squeeze(1)
    p = pos[rows]
    for b in blocks:
        B = index.chunk if b == "chunk" else int(b)
        # rows in the cell of their query block's first row
        home = (index.cells_sorted[p] == index.cells_sorted[(p // B) * B]).cpu()
        res = {"home_share": float(home.float().mean())}
        for label, nom in (("default", None), ("flat", "flat")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, I = ivf_knn(None, k=K, nprobe=NPROBE, index=index, rerank=False, nomination=nom,
                           block=B)
            torch.cuda.synchronize()
            r = recall(I[rows], exact).cpu()
            res[f"{label}_search_s"] = time.perf_counter() - t0
            res[f"{label}_recall"] = float(r.mean())
            res[f"{label}_recall_home"] = float(r[home].mean())
            res[f"{label}_recall_other"] = float(r[~home].mean()) if (~home).any() else None
        out[f"block_{B}"] = res
    return out


def main(cases=CASES, blocks=(256, "chunk")) -> list:
    import subprocess

    if not torch.cuda.is_available():
        raise RuntimeError("ivf_recall: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    results = []
    for case in cases:
        clusters, decay = case.split(":")
        res = run_case(int(clusters), float(decay), torch.device("cuda"), blocks)
        res["device"] = smi
        print(json.dumps(res), flush=True)
        results.append(res)
    return results


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--block", default="256,chunk",
                    help="query blocks, comma-separated; 'chunk' is the index's chunk")
    ap.add_argument("cases", nargs="*", default=list(CASES))
    a = ap.parse_args()
    main(a.cases, tuple(b if b == "chunk" else int(b) for b in a.block.split(",")))
