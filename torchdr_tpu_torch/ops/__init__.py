"""Distance, kNN, root-search, sparse and kernel primitives."""

from .knn_config import EXACT, FAST, IVF, KnnConfig

__all__ = ["KnnConfig", "EXACT", "FAST", "IVF"]
