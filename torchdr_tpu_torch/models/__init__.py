"""Estimators."""

from .neighbor import UMAP
from .spectral import PCA

__all__ = ["UMAP", "PCA"]
