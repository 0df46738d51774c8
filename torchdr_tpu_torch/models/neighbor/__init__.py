from .umap import UMAP

__all__ = ["UMAP"]
