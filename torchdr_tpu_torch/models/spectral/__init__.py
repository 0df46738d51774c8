from .pca import PCA

__all__ = ["PCA"]
