"""torchdr_tpu_torch: the PyTorch/CUDA port of ``torchdr_tpu``.

The package mirrors the JAX package file for file; each module names its
counterpart. Its hand-written Hopper kernels live in ``ops/csrc/`` and are
bound in ``ops/cuda/``.

Device: every estimator takes ``device``. ``"auto"`` means ``cuda`` and
raises when no card is present; only an explicit ``device="cpu"`` runs on
the CPU, where each kernel wrapper takes its plain PyTorch version.

Precision: everything is float32, and every public entry point (a fit,
``transform``, an affinity's call, the kNN, IVF, k-means and PQ functions,
``eval``) computes its products at full float32 whatever the caller set
with ``torch.set_float32_matmul_precision``, and gives that setting back on
return (``utils.wrappers.full_float32``): a TF32 distance gram keeps about
three decimal digits and flips neighbour ranks in the kNN graph. Importing
the package changes no global setting.
"""

from .affinity import (
    Affinity,
    DoublyStochasticQuadraticAffinity,
    EntropicAffinity,
    LogAffinity,
    MAGICAffinity,
    NormalizedGaussianAffinity,
    NormalizedStudentAffinity,
    PACMAPAffinity,
    PHATEAffinity,
    SelfTuningAffinity,
    SinkhornAffinity,
    SparseAffinity,
    SparseLogAffinity,
    SymmetricEntropicAffinity,
    UMAPAffinity,
)
from .affinity_matcher import AffinityMatcher
from .base import DRModule
from .eval import (
    adjusted_rand_index,
    kmeans_ari,
    knn_label_accuracy,
    knn_recall,
    neighborhood_preservation,
    neighborhood_preservation_sampled,
    silhouette_samples,
    silhouette_score,
)
from .models.neighbor import (
    COSNE,
    PACMAP,
    SNE,
    TSNE,
    UMAP,
    InfoTSNE,
    LargeVis,
    TSNEkhorn,
)
from .models.neighbor.base import (
    NegativeSamplingNeighborEmbedding,
    NeighborEmbedding,
)
from .models.spectral import (
    PCA,
    PHATE,
    ExactIncrementalPCA,
    IncrementalPCA,
    KernelPCA,
)
from .ops.distance import (
    knn_graph,
    knn_graph_host_chunked,
    pairwise_distances,
    pairwise_distances_indexed,
)
from .ops.ivf import ivf_build, ivf_build_from_batches, ivf_knn, ivf_knn_queries
from .ops.kmeans import kmeans_fit
from .ops.knn_config import EXACT, FAST, IVF, KnnConfig
from .ops.loader import (
    BatchSource,
    get_loader_metadata,
    validate_deterministic_loader,
)
from .ops.pq import pq_encode, pq_knn, pq_search, pq_train
from .ops.streaming import knn_graph_from_batches, knn_graph_streaming
from .ops.root_search import binary_search, false_position

__all__ = [
    "Affinity",
    "LogAffinity",
    "SparseAffinity",
    "SparseLogAffinity",
    "AffinityMatcher",
    "DRModule",
    "NeighborEmbedding",
    "NegativeSamplingNeighborEmbedding",
    "binary_search",
    "false_position",
    "SNE",
    "TSNE",
    "UMAP",
    "LargeVis",
    "InfoTSNE",
    "TSNEkhorn",
    "PACMAP",
    "COSNE",
    "PCA",
    "IncrementalPCA",
    "ExactIncrementalPCA",
    "KernelPCA",
    "PHATE",
    "EntropicAffinity",
    "NormalizedGaussianAffinity",
    "NormalizedStudentAffinity",
    "SinkhornAffinity",
    "SymmetricEntropicAffinity",
    "DoublyStochasticQuadraticAffinity",
    "MAGICAffinity",
    "PACMAPAffinity",
    "PHATEAffinity",
    "SelfTuningAffinity",
    "UMAPAffinity",
    "adjusted_rand_index",
    "kmeans_ari",
    "knn_label_accuracy",
    "knn_recall",
    "neighborhood_preservation",
    "neighborhood_preservation_sampled",
    "silhouette_samples",
    "silhouette_score",
    "knn_graph",
    "knn_graph_host_chunked",
    "pairwise_distances",
    "pairwise_distances_indexed",
    "ivf_build",
    "ivf_build_from_batches",
    "ivf_knn",
    "ivf_knn_queries",
    "kmeans_fit",
    "knn_graph_from_batches",
    "knn_graph_streaming",
    "BatchSource",
    "get_loader_metadata",
    "validate_deterministic_loader",
    "pq_train",
    "pq_encode",
    "pq_search",
    "pq_knn",
    "KnnConfig",
    "EXACT",
    "FAST",
    "IVF",
]
