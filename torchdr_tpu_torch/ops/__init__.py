"""Distance, kNN, root-search, sparse and kernel primitives."""

from .attraction import knn_attraction_loss, knn_transpose
from .distance import (
    knn_graph,
    knn_graph_host_chunked,
    pairwise_distances,
    pairwise_distances_indexed,
)
from .ivf import (
    IVFIndex,
    auto_nlist,
    ivf_build,
    ivf_build_from_batches,
    ivf_knn,
    ivf_knn_queries,
)
from .kmeans import kmeans_fit
from .knn_config import EXACT, FAST, IVF, KnnConfig
from .loader import BatchSource, get_loader_metadata, validate_deterministic_loader
from .metrics import LIST_METRICS, pairwise_block
from .pq import PQCodebook, pq_encode, pq_knn, pq_search, pq_train
from .reduce import pairwise_logkernel_logsumexp, pairwise_logkernel_rowlse
from .reductions import (
    center_kernel,
    cross_entropy_loss,
    entropy,
    kmax,
    kmin,
    logsumexp_red,
    matrix_power,
    square_loss,
    sum_red,
    svd_flip,
)
from .root_search import binary_search, false_position, init_bounds
from .sparse import sparse_to_dense, symmetrize_sparse
from .streaming import knn_graph_from_batches, knn_graph_streaming

__all__ = [
    "knn_graph", "knn_graph_host_chunked", "pairwise_distances", "pairwise_distances_indexed",
    "KnnConfig", "EXACT", "FAST", "IVF", "kmeans_fit", "knn_graph_from_batches",
    "knn_graph_streaming", "BatchSource", "get_loader_metadata",
    "validate_deterministic_loader",
    "IVFIndex", "auto_nlist", "ivf_build", "ivf_build_from_batches", "ivf_knn",
    "ivf_knn_queries",
    "PQCodebook", "pq_train", "pq_encode", "pq_search", "pq_knn",
    "LIST_METRICS", "pairwise_block",
    "pairwise_logkernel_logsumexp", "pairwise_logkernel_rowlse",
    "knn_attraction_loss", "knn_transpose",
    "center_kernel", "cross_entropy_loss", "entropy", "kmax", "kmin",
    "logsumexp_red", "matrix_power", "square_loss", "sum_red", "svd_flip",
    "binary_search", "false_position", "init_bounds",
    "sparse_to_dense", "symmetrize_sparse",
]
