"""Affinities."""

from .base import Affinity, LogAffinity, SparseAffinity, SparseLogAffinity
from .entropic import (
    EntropicAffinity,
    NormalizedGaussianAffinity,
    NormalizedStudentAffinity,
    SinkhornAffinity,
    SymmetricEntropicAffinity,
)
from .knn_normalized import (
    MAGICAffinity,
    PACMAPAffinity,
    PHATEAffinity,
    SelfTuningAffinity,
    UMAPAffinity,
)
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
    "MAGICAffinity",
    "PACMAPAffinity",
    "PHATEAffinity",
    "SelfTuningAffinity",
    "UMAPAffinity",
]
