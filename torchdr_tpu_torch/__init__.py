"""torchdr_tpu_torch: the PyTorch/CUDA port of ``torchdr_tpu``.

The package mirrors the JAX package file for file; each module names its
counterpart. Its hand-written Hopper kernels live in ``ops/csrc/`` and are
bound in ``ops/cuda/``.

Device: every estimator takes ``device``. ``"auto"`` means ``cuda`` and
raises when no card is present; only an explicit ``device="cpu"`` runs on
the CPU, where each kernel wrapper takes its plain PyTorch version.

Precision: everything is float32. Importing this package sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False``: a TF32 distance gram keeps
about three decimal digits and flips neighbour ranks in the kNN graph.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from .affinity import (  # noqa: E402
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
from .affinity_matcher import AffinityMatcher  # noqa: E402
from .base import DRModule  # noqa: E402
from .eval import (  # noqa: E402
    adjusted_rand_index,
    kmeans_ari,
    knn_label_accuracy,
    knn_recall,
    neighborhood_preservation,
    neighborhood_preservation_sampled,
    silhouette_samples,
    silhouette_score,
)
from .models.neighbor import (  # noqa: E402
    COSNE,
    PACMAP,
    SNE,
    TSNE,
    UMAP,
    InfoTSNE,
    LargeVis,
    TSNEkhorn,
)
from .models.neighbor.base import (  # noqa: E402
    NegativeSamplingNeighborEmbedding,
    NeighborEmbedding,
)
from .models.spectral import (  # noqa: E402
    PCA,
    PHATE,
    ExactIncrementalPCA,
    IncrementalPCA,
    KernelPCA,
)
from .ops.distance import (  # noqa: E402
    knn_graph,
    knn_graph_host_chunked,
    pairwise_distances,
    pairwise_distances_indexed,
)
from .ops.ivf import ivf_build, ivf_build_from_batches, ivf_knn, ivf_knn_queries  # noqa: E402
from .ops.kmeans import kmeans_fit  # noqa: E402
from .ops.knn_config import EXACT, FAST, IVF, KnnConfig  # noqa: E402
from .ops.loader import (  # noqa: E402
    BatchSource,
    get_loader_metadata,
    validate_deterministic_loader,
)
from .ops.pq import pq_encode, pq_knn, pq_search, pq_train  # noqa: E402
from .ops.streaming import knn_graph_from_batches, knn_graph_streaming  # noqa: E402
from .ops.root_search import binary_search, false_position  # noqa: E402

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
