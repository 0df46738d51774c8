"""Evaluation metrics (counterpart of ``torchdr_tpu/eval``)."""

from .kmeans_ari import adjusted_rand_index, kmeans_ari
from .knn_metrics import (
    knn_label_accuracy,
    knn_recall,
    neighborhood_preservation,
    neighborhood_preservation_sampled,
)
from .silhouette import silhouette_samples, silhouette_score

__all__ = [
    "adjusted_rand_index", "kmeans_ari",
    "knn_label_accuracy", "knn_recall", "neighborhood_preservation",
    "neighborhood_preservation_sampled",
    "silhouette_samples", "silhouette_score",
]
