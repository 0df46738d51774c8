"""kNN tier configuration object (copy of ``torchdr_tpu/ops/knn_config.py``).

"exact" is the flat tier; "approx" maps to it (see
:func:`torchdr_tpu_torch.ops.distance.knn_graph`); "ivf" is the IVF tier
(:func:`torchdr_tpu_torch.ops.ivf.ivf_knn`), whose knobs are the fields
from ``nprobe`` on.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class KnnConfig:
    """Tuning for the kNN-graph builder (ops/distance.knn_graph).

    Parameters
    ----------
    mode : {"exact", "approx", "ivf"}
        "ivf": coarse quantization and a block-shared probe (``ops/ivf.py``).
    precision : {"highest", "high", "default"}
        Accepted for parity; the port's gram is always exact float32.
    recall_target : float
        Recall target of the JAX package's approx tier (unused here).
    block_size : int
        Query rows per block (exact and approx tiers).
    nprobe, n_clusters, budget, merge, m, ivf_block, rerank
        The IVF search's knobs, passed to ``ivf_knn`` (``ivf_block`` is its
        ``block``). ``rerank=False`` returns the scan scores as distances,
        the estimators' default.
    nomination : {None, "flat", "adjacency", "supers"}
        None picks adjacency when the index has a cell table and nlist ≥
        1024, flat otherwise. "supers" needs the search's ``nprobe_supers``,
        which the estimators do not pass: there it searches as "flat", as in
        the JAX package.
    storage : {"auto", "f32", "split", "int8"}
        "f32" float32 rows, "split" the bf16 residual split, "int8" the int8
        tier; "auto" takes the split past 4 GB of sorted rows.
    """

    mode: str = "exact"
    precision: str = "highest"
    recall_target: float = 0.95
    block_size: int = 1024
    nprobe: int = 16
    n_clusters: Optional[int] = None
    budget: Optional[int] = None
    merge: Optional[str] = None
    m: Optional[int] = None
    ivf_block: Optional[int] = None
    nomination: Optional[str] = None
    rerank: bool = False
    storage: str = "auto"

    def __post_init__(self):
        if self.mode not in ("exact", "approx", "ivf"):
            raise ValueError(f"[TorchDR-Torch] unknown knn mode {self.mode!r}")
        if self.precision not in ("highest", "high", "default"):
            raise ValueError(f"[TorchDR-Torch] unknown knn precision {self.precision!r}")
        if self.merge not in (None, "approx", "exact", "tournament"):
            raise ValueError(f"[TorchDR-Torch] unknown ivf merge {self.merge!r}")
        if self.nomination not in (None, "flat", "adjacency", "supers"):
            raise ValueError(f"[TorchDR-Torch] unknown ivf nomination {self.nomination!r}")
        if self.storage not in ("auto", "f32", "split", "int8"):
            raise ValueError(f"[TorchDR-Torch] unknown ivf storage {self.storage!r}")

    def kwargs(self) -> dict:
        """The arguments of ``knn_graph`` that this configuration sets."""
        return dict(
            mode=self.mode,
            precision=self.precision,
            recall_target=self.recall_target,
            block_size=self.block_size,
        )


#: Preset: exact tier (the default everywhere).
EXACT = KnnConfig()
#: Preset: the JAX package's fast tier; the port runs it exactly.
FAST = KnnConfig(mode="approx", precision="high", recall_target=0.95)
#: Preset: the IVF tier (``ops/ivf.py``), storage "auto".
IVF = KnnConfig(mode="ivf", precision="high")
