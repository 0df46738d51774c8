"""Affinities."""

from .base import Affinity, SparseAffinity
from .knn_normalized import UMAPAffinity

__all__ = ["Affinity", "SparseAffinity", "UMAPAffinity"]
