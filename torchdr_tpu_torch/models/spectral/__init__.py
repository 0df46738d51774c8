from .incremental_pca import ExactIncrementalPCA, IncrementalPCA
from .kernel_pca import KernelPCA
from .pca import PCA
from .phate import PHATE

__all__ = ["PCA", "IncrementalPCA", "ExactIncrementalPCA", "KernelPCA", "PHATE"]
