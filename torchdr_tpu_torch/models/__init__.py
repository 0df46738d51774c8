"""Estimators."""

from .neighbor import COSNE, PACMAP, SNE, TSNE, UMAP, InfoTSNE, LargeVis, TSNEkhorn
from .spectral import PCA, PHATE, ExactIncrementalPCA, IncrementalPCA, KernelPCA

__all__ = [
    "SNE", "TSNE", "UMAP", "LargeVis", "InfoTSNE", "TSNEkhorn", "PACMAP", "COSNE",
    "PCA", "IncrementalPCA", "ExactIncrementalPCA", "KernelPCA", "PHATE",
]
