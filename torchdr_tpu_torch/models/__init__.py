"""Estimators."""

from .neighbor import SNE, TSNE, UMAP
from .spectral import PCA

__all__ = ["SNE", "TSNE", "UMAP", "PCA"]
