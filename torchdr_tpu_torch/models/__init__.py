"""Estimators."""

from .neighbor import (
    COSNE,
    PACMAP,
    SNE,
    TSNE,
    UMAP,
    InfoTSNE,
    LargeVis,
    NegativeSamplingNeighborEmbedding,
    NeighborEmbedding,
    TSNEkhorn,
)
from .spectral import PCA, PHATE, ExactIncrementalPCA, IncrementalPCA, KernelPCA

__all__ = [
    "NeighborEmbedding", "NegativeSamplingNeighborEmbedding",
    "SNE", "TSNE", "UMAP", "LargeVis", "InfoTSNE", "TSNEkhorn", "PACMAP", "COSNE",
    "PCA", "IncrementalPCA", "ExactIncrementalPCA", "KernelPCA", "PHATE",
]
