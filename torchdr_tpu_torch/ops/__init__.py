"""Distance, kNN, root-search, sparse and kernel primitives."""

from .distance import knn_graph, knn_graph_host_chunked
from .ivf import IVFIndex, auto_nlist, ivf_build, ivf_knn, ivf_knn_queries
from .kmeans import kmeans_fit
from .knn_config import EXACT, FAST, IVF, KnnConfig

__all__ = [
    "KnnConfig", "EXACT", "FAST", "IVF",
    "knn_graph", "knn_graph_host_chunked", "kmeans_fit",
    "IVFIndex", "auto_nlist", "ivf_build", "ivf_knn", "ivf_knn_queries",
]
