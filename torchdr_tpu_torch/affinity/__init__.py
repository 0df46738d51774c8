"""Affinities."""

from .base import Affinity, LogAffinity, SparseAffinity, SparseLogAffinity
from .entropic import (
    EntropicAffinity,
    NormalizedGaussianAffinity,
    NormalizedStudentAffinity,
    SinkhornAffinity,
    SymmetricEntropicAffinity,
)
from .knn_normalized import PACMAPAffinity, UMAPAffinity
from .quadratic import DoublyStochasticQuadraticAffinity

__all__ = [
    "Affinity",
    "LogAffinity",
    "SparseAffinity",
    "SparseLogAffinity",
    "EntropicAffinity",
    "NormalizedGaussianAffinity",
    "NormalizedStudentAffinity",
    "SinkhornAffinity",
    "SymmetricEntropicAffinity",
    "DoublyStochasticQuadraticAffinity",
    "PACMAPAffinity",
    "UMAPAffinity",
]
