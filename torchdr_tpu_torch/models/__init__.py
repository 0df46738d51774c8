"""Estimators."""

from .neighbor import PACMAP, SNE, TSNE, UMAP, InfoTSNE, LargeVis, TSNEkhorn
from .spectral import PCA

__all__ = ["SNE", "TSNE", "UMAP", "LargeVis", "InfoTSNE", "TSNEkhorn", "PACMAP", "PCA"]
