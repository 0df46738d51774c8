"""Affinities."""

from .base import Affinity, LogAffinity, SparseAffinity, SparseLogAffinity
from .entropic import EntropicAffinity
from .knn_normalized import UMAPAffinity

__all__ = [
    "Affinity",
    "LogAffinity",
    "SparseAffinity",
    "SparseLogAffinity",
    "EntropicAffinity",
    "UMAPAffinity",
]
